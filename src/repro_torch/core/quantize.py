"""One-bit gradient transport for the prototype uplink (paper Sec. V-B):
clients send sign(ǧ), the server majority-votes (``kernels.ops.sign_mv``)."""

from __future__ import annotations

import torch


def one_bit(x: torch.Tensor) -> torch.Tensor:
    """Client-side quantizer; sign with 0 mapped to +1 (a carrier is always
    sent)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)
