"""The arithmetic the reference computes in.  ``"float32"`` is the
reference itself (TF32 off: a float32 product on the card runs in TF32
unless it is switched off).  The lower precisions make the control: the
operands of every matrix product (``"float8_e4m3fn"``, scaled per tensor
by its largest magnitude as fp8 training scales them) or the server
phase's float32 inputs (``"bfloat16"``) rounded to them; the backward
pass lets the gradient through the rounding unchanged."""

from __future__ import annotations

import torch

Tensor = torch.Tensor
FP8_MAX = 448.0
NAMES = ("float32", "bfloat16", "float8_e4m3fn")


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rounded(x: Tensor, precision: str) -> Tensor:
    """``x`` (float32) rounded to ``precision`` and back, the gradient
    passed straight through."""
    if precision == "float32":
        return x
    if precision == "bfloat16":
        q = x.to(torch.bfloat16).to(torch.float32)
    elif precision == "float8_e4m3fn":
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        q = (x.detach() * scale).to(torch.float8_e4m3fn).to(
            torch.float32) / scale
    else:
        raise ValueError(f"unknown precision {precision!r}; choose from "
                         f"{NAMES}")
    return x + (q - x).detach()


def matmul(a: Tensor, b: Tensor, precision: str) -> Tensor:
    """``a @ b`` with both operands in ``precision`` (float32 products)."""
    return torch.matmul(rounded(a, precision), rounded(b, precision))
