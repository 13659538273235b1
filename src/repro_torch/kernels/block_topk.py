"""Wrapper of the per-block top-m kernel (``csrc/block_topk.cu``).

Replaces ``src/repro/kernels/block_topk.py:_block_topk_kernel`` (the
Pallas TPU kernel, ``pl.pallas_call`` in ``block_topk_pallas``).  Bound
on the H100: device-memory bytes (d floats read, nb * m pairs written).
One CTA per data block turns |x| into uint32 keys (NaN above +inf), finds
a threshold without any step that runs m times in sequence — a register
filter (each thread's few largest keys vote in one histogram, giving a
lower bound that at least m keys reach) for blocks of up to 4,096 keys
and m <= 256, else a radix select of at most four passes over the keys in
shared memory — then sorts the candidates (key descending, index
ascending: ties toward the lower index) with a bitonic sort.

``block_topk_cuda`` checks its tensor and the shape (``ValueError`` as
in JAX), allocates the outputs (and, where the candidates do not fit in
shared memory beside the keys, a scratch row per block) and launches on
the current stream without synchronising.  ``LAUNCHES`` counts its
launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fairk_update import check_vec
from repro_torch.kernels.ref import check_block_topk

Tensor = torch.Tensor

# the block's keys live in dynamic shared memory: 227 KB a block on the
# H100, less room for the kernel's static arrays (csrc/block_topk.cu:
# kSmemBytes); beside them one region holds the radix histogram (at least
# 1 KB) and then, where they fit, the candidates
SMEM_BYTES = 232_448 - 1_024
MAX_BLOCK_SIZE = 56 * 1024

LAUNCHES = 0


def candidates_in_smem(block_size: int, m: int) -> bool:
    """Whether the m candidates (padded to a power of two, 8 bytes each)
    fit in shared memory beside the block's keys."""
    cand_n = 1 << (m - 1).bit_length()
    keys = (4 * block_size + 15) & ~15
    return keys + max(8 * cand_n, 1024) <= SMEM_BYTES


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
    scratch = (None if candidates_in_smem(block_size, m) else
               torch.empty((nb, 1 << (m - 1).bit_length()),
                           dtype=torch.int64, device=x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    p = build.ptr
    rc = lib.repro_block_topk(p(x), p(vals), p(idxs), p(scratch), nb,
                              block_size, m, stream)
    build.check(rc, "block_topk")
    LAUNCHES += 1
    return vals, idxs
