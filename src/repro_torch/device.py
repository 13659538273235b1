"""Device resolution for the port's entry points.

Every entry point takes ``device``: ``None`` means the card, and raises
when there is none; ``"cpu"`` (or any explicit device) is taken as given.
There is no silent fallback to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on (see the module docstring)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but no CUDA device "
                               "is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_numerics(device: torch.device) -> None:
    """Full float32 on the card: cuDNN convolutions run in TF32 by default
    and would keep only ~3 decimal digits, so TF32 is switched off for both
    convolutions and matrix products."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
