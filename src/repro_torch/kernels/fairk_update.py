"""Wrapper of the fused FAIR-k server kernel (``csrc/fairk_update.cu``).

Replaces ``src/repro/kernels/fairk_update.py:_fairk_kernel`` (the Pallas
TPU kernel, ``pl.pallas_call`` in ``_fairk_call``).  Bound on the H100:
device-memory bytes — 20 to 32 bytes move per coordinate for a few
compares, so the kernel is one grid-stride pass with 16-byte loads, a
grid sized to the card and every intermediate in registers.  It reads
the thresholds through two pointers to 0-dim device tensors and writes
the float32 statistics row itself (exact integer counts summed across
blocks in a per-slot device accumulator, converted by the last block),
so a call is one device operation.  The TPU wrapper's 256-lane block
padding is gone: the kernel masks its own tail.

The launch is the ``torch.library`` operator ``repro_torch::fairk_update``
(``fairk_update_op``, defined in ``LIB``, the library every kernel
module adds its operator to), so a dispatch mode sees one call as one
named operation, and under ``FakeTensorMode`` its fake implementation
gives the outputs' shapes and dtypes without launching anything.  Its
kernel (one Python function for every device, the dispatcher's
``CompositeExplicitAutograd`` key) checks the tensors, allocates the
outputs, picks the statistics slot of the current stream and launches
on that stream without synchronising; ``LAUNCHES`` counts its launches.
``fairk_update_cuda`` calls it and turns the empty rows that stand for
absent outputs into None.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import packing
from repro_torch.kernels import build

Tensor = torch.Tensor

# layout of the kernel's float32 statistics row
STATS_N_SEL = 0
STATS_N_SEL_M = 1
STATS_MAG_OFF = 2
STATS_AGE_OFF = STATS_MAG_OFF + packing.STATS_MAG_BINS
STATS_SIZE = STATS_AGE_OFF + packing.STATS_AGE_BINS

# the kernel's statistics accumulators (csrc/fairk_update.cu: kSlots):
# one per (device, stream), since two calls that run at the same time may
# not share one
STATS_SLOTS = 64
_SLOTS: Dict[Tuple[int, int], int] = {}

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


def check_scalar(name: str, t: Tensor, device: torch.device) -> None:
    """A threshold operand must be a one-element float32 tensor on the
    kernel's device."""
    if t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype != torch.float32 or t.numel() != 1:
        raise ValueError(f"{name} must be one float32 value, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")


def stats_slot(device: torch.device, stream: int) -> int:
    """The statistics slot of ``stream`` on ``device`` (assigned on first
    use, at most ``STATS_SLOTS`` streams per device)."""
    key = (device.index, stream)
    slot = _SLOTS.get(key)
    if slot is None:
        slot = sum(1 for dev, _ in _SLOTS if dev == device.index)
        if slot >= STATS_SLOTS:
            raise RuntimeError(f"fairk_update: more than {STATS_SLOTS} "
                               f"streams on {device} asked for statistics")
        _SLOTS[key] = slot
    return slot


# the operator library of the port's kernels (each kernel module adds its
# operators to the ``repro_torch`` namespace)
LIB = torch.library.Library("repro_torch", "FRAGMENT")
LIB.define("fairk_update(Tensor g, Tensor g_prev, Tensor age, "
           "Tensor theta_m, Tensor theta_a, Tensor? residual, "
           "Tensor? fresh, int stats_stride, bool sanitize) "
           "-> (Tensor, Tensor, Tensor, Tensor)")


def _fairk_update_launch(g: Tensor, g_prev: Tensor, age: Tensor,
                         theta_m: Tensor, theta_a: Tensor,
                         residual: Optional[Tensor], fresh: Optional[Tensor],
                         stats_stride: int, sanitize: bool
                         ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The op's kernel: one fused launch -> (g_t, age', residual',
    stats); an empty (0,) row stands for the residual without
    ``residual`` and for the statistics when ``stats_stride`` is 0."""
    global LAUNCHES
    d = g.shape[0] if g.dim() == 1 else -1
    dev = g.device
    for name, t in (("g", g), ("g_prev", g_prev), ("age", age),
                    ("residual", residual), ("fresh", fresh)):
        if t is not None:
            check_vec(name, t, d, dev)
    check_scalar("theta_m", theta_m, dev)
    check_scalar("theta_a", theta_a, dev)
    if stats_stride < 0 or stats_stride & (stats_stride - 1):
        raise ValueError(f"stats_stride must be 0 or a power of two, got "
                         f"{stats_stride}")
    lib = build.load()
    g_t = torch.empty_like(g)
    age_out = torch.empty_like(age)
    res_out = torch.empty_like(residual) if residual is not None else None
    stats = (torch.empty(STATS_SIZE, dtype=torch.float32, device=dev)
             if stats_stride else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    slot = stats_slot(dev, stream) if stats_stride else 0
    p = build.ptr
    rc = lib.repro_fairk_update(
        p(g), p(fresh), p(g_prev), p(age), p(residual), p(theta_m),
        p(theta_a), p(g_t), p(age_out), p(res_out), p(stats), d,
        stats_stride, slot, int(bool(sanitize)), stream)
    build.check(rc, "fairk_update")
    LAUNCHES += 1
    return (g_t, age_out, g.new_empty(0) if res_out is None else res_out,
            g.new_empty(0) if stats is None else stats)


def _fairk_update_fake(g, g_prev, age, theta_m, theta_a, residual, fresh,
                       stats_stride, sanitize):
    return (torch.empty_like(g), torch.empty_like(age),
            torch.empty_like(residual) if residual is not None
            else g.new_empty(0),
            g.new_empty(STATS_SIZE if stats_stride else 0))


LIB.impl("fairk_update", _fairk_update_launch, "CompositeExplicitAutograd")
torch.library.register_fake("repro_torch::fairk_update", _fairk_update_fake,
                            lib=LIB)
fairk_update_op = torch.ops.repro_torch.fairk_update.default


def fairk_update_cuda(g: Tensor, g_prev: Tensor, age: Tensor,
                      theta_m: Tensor, theta_a: Tensor,
                      residual: Optional[Tensor] = None,
                      fresh: Optional[Tensor] = None, stats_stride: int = 0,
                      sanitize: bool = False
                      ) -> Tuple[Tensor, Tensor, Optional[Tensor],
                                 Optional[Tensor]]:
    """One fused launch -> (g_t, age', residual' | None, stats | None).
    ``theta_m`` / ``theta_a`` are one-element float32 device tensors;
    ``stats`` is the float32 row ``[n_sel, n_sel_m, mag_hist(128),
    age_hist(128)]`` when ``stats_stride`` > 0 (a power of two)."""
    g_t, age_out, res_out, stats = fairk_update_op(
        g, g_prev, age, theta_m, theta_a, residual, fresh,
        int(stats_stride), bool(sanitize))
    return (g_t, age_out, res_out if residual is not None else None,
            stats if stats_stride else None)
