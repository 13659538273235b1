"""Wrappers of the merge-and-age kernel (``csrc/aou_merge.cu``).

Replaces ``src/repro/kernels/aou_merge.py:_aou_merge_kernel`` (the Pallas
TPU kernel, ``pl.pallas_call`` in ``aou_merge_pallas``).  Bound on the
H100: device-memory bytes — 24 bytes move per coordinate for five flops in
the mask form — so a thread takes one float4 of every row (scalar loads
on views off a 16-byte boundary).  It clips the age at ``AGE_CAP`` as the
JAX oracle and the engine do.

* ``aou_merge_cuda``: the TPU function, in mask form.
* ``merge_by_indices_cuda``: the exact call sites' whole state update for
  a selection given as int64 indices, in one cooperative launch (a dense
  pass writes every coordinate as unselected, a grid-wide barrier, then
  the k selected ones are written): the trainer's scatter form (SET) or
  the engine's arithmetic form (``arith``).

Each launch is a ``torch.library`` operator (``repro_torch::aou_merge``,
``repro_torch::merge_by_indices``) with a fake implementation for
``FakeTensorMode``; its kernel checks the tensors, allocates the outputs
and launches on the current stream without synchronising.  ``LAUNCHES``
counts the launches of both.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fairk_update import LIB, check_vec

Tensor = torch.Tensor

LAUNCHES = 0


LIB.define("aou_merge(Tensor g_new, Tensor g_old, Tensor age, Tensor mask) "
           "-> (Tensor, Tensor)")
LIB.define("merge_by_indices(Tensor idx, Tensor row, Tensor g_prev, "
           "Tensor age, Tensor? sel_count, Tensor? noise, float noise_mul, "
           "int n_clients, bool superposed, Tensor? aux, bool arith) "
           "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")


def _aou_merge_launch(g_new: Tensor, g_old: Tensor, age: Tensor,
                      mask: Tensor) -> Tuple[Tensor, Tensor]:
    """The op's kernel: one launch -> (g, age')."""
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


def _aou_merge_fake(g_new, g_old, age, mask):
    return torch.empty_like(g_new), torch.empty_like(age)


def aou_merge_cuda(g_new: Tensor, g_old: Tensor, age: Tensor, mask: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    """One launch -> (g, age'), both (d,) float32."""
    return aou_merge_op(g_new, g_old, age, mask)


def _merge_by_indices_launch(idx: Tensor, row: Tensor, g_prev: Tensor,
                             age: Tensor, sel_count: Optional[Tensor],
                             noise: Optional[Tensor], noise_mul: float,
                             n_clients: int, superposed: bool,
                             aux: Optional[Tensor], arith: bool
                             ) -> Tuple[Tensor, Tensor, Tensor, Tensor,
                                        Tensor]:
    """The op's kernel (``merge_by_indices_cuda``); an empty (0,) row
    stands for each output the form does not write."""
    global LAUNCHES
    dev = g_prev.device
    d = g_prev.shape[0] if g_prev.dim() == 1 else -1
    if idx.device != dev or idx.dtype != torch.int64:
        raise ValueError(f"idx must be int64 on {dev}, got {idx.dtype} on "
                         f"{idx.device}")
    if idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous (k,) row")
    k = idx.shape[0]
    width = d if arith else k
    for name, t, n in (("g_prev", g_prev, d), ("age", age, d),
                       ("row", row, width), ("noise", noise, width),
                       ("aux", aux, d)):
        if t is not None:
            check_vec(name, t, n, dev)
    if not arith:
        if sel_count is None:
            raise ValueError("the scatter form needs sel_count")
        check_vec("sel_count", sel_count, d, dev)
    lib = build.load()
    g_out = torch.empty_like(g_prev)
    age_out = torch.empty_like(g_prev)
    mask = None if arith else torch.empty_like(g_prev)
    count = None if arith else torch.empty_like(g_prev)
    res = None if aux is None else torch.empty_like(g_prev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = build.ptr
    rc = lib.repro_aou_merge_by_indices(
        p(idx), p(row), p(noise), p(g_prev), p(age),
        None if arith else p(sel_count), p(aux), p(g_out), p(age_out),
        p(mask), p(count), p(res), d, k, float(noise_mul),
        float(n_clients), int(bool(superposed)), int(bool(arith)), stream)
    build.check(rc, "aou_merge")
    LAUNCHES += 1
    return (g_out, age_out, *(g_prev.new_empty(0) if t is None else t
                              for t in (mask, count, res)))


def _merge_by_indices_fake(idx, row, g_prev, age, sel_count, noise,
                           noise_mul, n_clients, superposed, aux, arith):
    def row_or_empty(present):
        return torch.empty_like(g_prev) if present else g_prev.new_empty(0)
    return (torch.empty_like(g_prev), torch.empty_like(g_prev),
            row_or_empty(not arith), row_or_empty(not arith),
            row_or_empty(aux is not None))


for _name, _launch, _fake in (
        ("aou_merge", _aou_merge_launch, _aou_merge_fake),
        ("merge_by_indices", _merge_by_indices_launch,
         _merge_by_indices_fake)):
    LIB.impl(_name, _launch, "CompositeExplicitAutograd")
    torch.library.register_fake(f"repro_torch::{_name}", _fake, lib=LIB)
aou_merge_op = torch.ops.repro_torch.aou_merge.default
merge_by_indices_op = torch.ops.repro_torch.merge_by_indices.default


def merge_by_indices_cuda(idx: Tensor, row: Tensor, g_prev: Tensor,
                          age: Tensor, *, sel_count: Optional[Tensor] = None,
                          noise: Optional[Tensor] = None,
                          noise_mul: float = 0.0, n_clients: int = 1,
                          superposed: bool = False,
                          aux: Optional[Tensor] = None, arith: bool = False
                          ) -> Tuple[Tensor, Tensor, Optional[Tensor],
                                     Optional[Tensor], Optional[Tensor]]:
    """One launch -> ``(g_t, age', mask | None, sel_count' | None,
    residual' | None)``, each (d,) float32, for the int64 selection ``idx``
    (k distinct values in [0, d)).

    SET (``arith`` False): ``row`` is the (k,) fresh row (with
    ``superposed``, the raw faded sum, given ``(row + noise_mul·noise) /
    n_clients`` first), ``noise`` the (k,) draw, ``sel_count`` (d,) is
    required, ``aux`` is ``ef_sum`` (d,) for the residual.  ARITH: ``row``
    is the (d,) sent row, ``noise`` the (d,) draw scaled by ``noise_mul``,
    ``aux`` the score (d,) for the residual; no mask or count."""
    g_out, age_out, mask, count, res = merge_by_indices_op(
        idx, row, g_prev, age, sel_count, noise, float(noise_mul),
        int(n_clients), bool(superposed), aux, bool(arith))
    return (g_out, age_out, None if arith else mask,
            None if arith else count, None if aux is None else res)
