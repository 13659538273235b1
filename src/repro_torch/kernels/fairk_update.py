"""Wrapper of the fused FAIR-k server kernel (``csrc/fairk_update.cu``).

Replaces ``src/repro/kernels/fairk_update.py:_fairk_kernel`` (the Pallas
TPU kernel, ``pl.pallas_call`` in ``_fairk_call``).  Bound on the H100:
device-memory bytes — 20 to 32 bytes move per coordinate for a few
compares, so the kernel is one coalesced grid-stride pass with every
intermediate in registers and the statistics row accumulated as exact
integers in shared memory (one global atomic per non-empty bin per
block).  The TPU wrapper's 256-lane block padding is gone: the kernel
masks its own tail.

``fairk_update_cuda`` checks its tensors, allocates the outputs, zeroes
the statistics accumulator and launches on the current stream without
synchronising.  ``LAUNCHES`` counts its launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import packing
from repro_torch.kernels import build

Tensor = torch.Tensor

# layout of the kernel's int32 statistics accumulator
STATS_N_SEL = 0
STATS_N_SEL_M = 1
STATS_MAG_OFF = 2
STATS_AGE_OFF = STATS_MAG_OFF + packing.STATS_MAG_BINS
STATS_SIZE = STATS_AGE_OFF + packing.STATS_AGE_BINS

LAUNCHES = 0


def check_vec(name: str, t: Tensor, d: int, device: torch.device) -> None:
    """A kernel operand must be a contiguous (d,) float32 CUDA tensor."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must lie on {device} (a CUDA device), "
                         f"got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != (d,):
        raise ValueError(f"{name} must have shape ({d},), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fairk_update_cuda(g: Tensor, g_prev: Tensor, age: Tensor, thetas: Tensor,
                      residual: Optional[Tensor] = None,
                      fresh: Optional[Tensor] = None, stats_stride: int = 0,
                      sanitize: bool = False
                      ) -> Tuple[Tensor, Tensor, Optional[Tensor],
                                 Optional[Tensor]]:
    """One fused launch -> (g_t, age', residual' | None, stats | None).
    ``thetas`` is the device tensor [θ_M, θ_A]; ``stats`` is the int32
    accumulator ``[n_sel, n_sel_m, mag_hist(128), age_hist(128)]`` when
    ``stats_stride`` > 0 (a power of two)."""
    global LAUNCHES
    d = g.shape[0] if g.dim() == 1 else -1
    dev = g.device
    for name, t in (("g", g), ("g_prev", g_prev), ("age", age),
                    ("residual", residual), ("fresh", fresh)):
        if t is not None:
            check_vec(name, t, d, dev)
    check_vec("thetas", thetas, 2, dev)
    if stats_stride < 0 or stats_stride & (stats_stride - 1):
        raise ValueError(f"stats_stride must be 0 or a power of two, got "
                         f"{stats_stride}")
    lib = build.load()
    g_t = torch.empty_like(g)
    age_out = torch.empty_like(age)
    res_out = torch.empty_like(residual) if residual is not None else None
    stats = (torch.zeros(STATS_SIZE, dtype=torch.int32, device=dev)
             if stats_stride else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = build.ptr
    rc = lib.repro_fairk_update(
        p(g), p(fresh), p(g_prev), p(age), p(residual), p(thetas), p(g_t),
        p(age_out), p(res_out), p(stats), d, stats_stride,
        int(bool(sanitize)), stream)
    build.check(rc, "fairk_update")
    LAUNCHES += 1
    return g_t, age_out, res_out, stats
