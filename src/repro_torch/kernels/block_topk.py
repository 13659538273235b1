"""Wrapper of the per-block top-m kernel (``csrc/block_topk.cu``).

Replaces ``src/repro/kernels/block_topk.py:_block_topk_kernel`` (the
Pallas TPU kernel, ``pl.pallas_call`` in ``block_topk_pallas``).  Bound
on the H100: the m rounds of block-wide argmax, a chain of dependent
reductions, once m is in the tens; the bytes bound (d floats read once)
is far below.  One CTA per data block holds the block's |x| in shared
memory; each thread keeps its own best candidate in registers and only
the winner's owner rescans after a round.

``block_topk_cuda`` checks its tensor and the shape (``ValueError`` as
in JAX), allocates the outputs and launches on the current stream without
synchronising.  ``LAUNCHES`` counts its launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fairk_update import check_vec
from repro_torch.kernels.ref import check_block_topk

Tensor = torch.Tensor

# the block's |x| lives in dynamic shared memory: 227 KB a block on the
# H100, less the kernel's static arrays
MAX_BLOCK_SIZE = 56 * 1024

LAUNCHES = 0


def block_topk_cuda(x: Tensor, block_size: int, m: int
                    ) -> Tuple[Tensor, Tensor]:
    """x (d,) float32 -> (vals (nb, m) float32, idxs (nb, m) int32)."""
    global LAUNCHES
    d = x.shape[0] if x.dim() == 1 else -1
    check_vec("x", x, d, x.device)
    nb = check_block_topk(d, block_size, m)
    if block_size > MAX_BLOCK_SIZE:
        raise ValueError(f"block_size={block_size} exceeds the kernel's "
                         f"shared-memory limit of {MAX_BLOCK_SIZE}")
    lib = build.load()
    vals = torch.empty((nb, m), dtype=torch.float32, device=x.device)
    idxs = torch.empty((nb, m), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    p = build.ptr
    rc = lib.repro_block_topk(p(x), p(vals), p(idxs), nb, block_size, m,
                              stream)
    build.check(rc, "block_topk")
    LAUNCHES += 1
    return vals, idxs
