"""Wrapper of the fused merge-and-age kernel (``csrc/aou_merge.cu``).

Replaces ``src/repro/kernels/aou_merge.py:_aou_merge_kernel`` (the Pallas
TPU kernel, ``pl.pallas_call`` in ``aou_merge_pallas``).  Bound on the
H100: device-memory bytes — 24 bytes move per coordinate for five flops,
so the kernel is one coalesced grid-stride pass that masks its own ragged
tail (any d).  It clips the age at ``AGE_CAP`` as the JAX oracle and the
engine do.

``aou_merge_cuda`` checks its tensors, allocates the outputs and launches
on the current stream without synchronising.  ``LAUNCHES`` counts its
launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fairk_update import check_vec

Tensor = torch.Tensor

LAUNCHES = 0


def aou_merge_cuda(g_new: Tensor, g_old: Tensor, age: Tensor, mask: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    """One launch -> (g, age'), both (d,) float32."""
    global LAUNCHES
    d = g_new.shape[0] if g_new.dim() == 1 else -1
    for name, t in (("g_new", g_new), ("g_old", g_old), ("age", age),
                    ("mask", mask)):
        check_vec(name, t, d, g_new.device)
    lib = build.load()
    g_out = torch.empty_like(g_new)
    age_out = torch.empty_like(age)
    stream = torch.cuda.current_stream(g_new.device).cuda_stream
    p = build.ptr
    rc = lib.repro_aou_merge(p(g_new), p(g_old), p(age), p(mask), p(g_out),
                             p(age_out), d, stream)
    build.check(rc, "aou_merge")
    LAUNCHES += 1
    return g_out, age_out
