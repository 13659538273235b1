"""Wrappers of the FSK majority-vote kernels (``csrc/sign_mv.cu``).

Replace ``src/repro/kernels/sign_mv.py:_sign_mv_kernel`` /
``_sign_mv_noise_kernel`` (``sign_mv_pallas``) and
``_sign_from_energy_kernel`` / ``_sign_from_energy_noise_kernel``
(``sign_from_energy_pallas``).  Bound on the H100: device-memory bytes
(each vote is read once for one compare and one integer add).  A CTA of
64 columns x 4 row groups (128 x 2 for chunks of at most 16 rows)
starts up to 8 row loads a thread before it compares (float2 loads on
the dense path), and the row groups' int32 counts meet in shared
memory, so the counts are exact integers.

* ``sign_mv_cuda``: the TPU function, (N, k) votes -> (signs, energy).
* ``vote_fold_cuda``: the one-bit chunk fold, ``acc += `` the vote counts
  of a (C, d) chunk, optionally gathered at ``idx`` and with each client's
  votes weighted by a (C,) ``row`` before the re-sign; no signs row.
* ``sign_from_energy_cuda``: the detection (noise as it is, or
  ``noise_std * z``), optionally with the packed path's selection score
  ``|s| + knuth_jitter(j)``.

Each launch is a ``torch.library`` operator (``repro_torch::sign_mv``,
``repro_torch::vote_fold``, which adds into ``acc`` in place, and
``repro_torch::sign_from_energy``) with a fake implementation for
``FakeTensorMode``; its kernel checks the tensors, allocates the outputs
and launches on the current stream without synchronising: one device
operation per call.
``SIGN_MV_LAUNCHES`` counts the launches of ``sign_mv_cuda`` and
``vote_fold_cuda``, ``SIGN_FROM_ENERGY_LAUNCHES`` those of
``sign_from_energy_cuda``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fairk_update import LIB, check_vec

Tensor = torch.Tensor

SIGN_MV_LAUNCHES = 0
SIGN_FROM_ENERGY_LAUNCHES = 0


def _check_matrix(name: str, x: Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name} must be (N, k), got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")


LIB.define("sign_mv(Tensor votes, Tensor? noise) -> (Tensor, Tensor)")
LIB.define("vote_fold(Tensor(a!) acc, Tensor x, Tensor? idx, Tensor? row) "
           "-> ()")
LIB.define("sign_from_energy(Tensor energy, Tensor? noise, Tensor? z, "
           "float noise_std, bool score) -> (Tensor, Tensor, Tensor)")


def _sign_mv_launch(votes: Tensor, noise: Optional[Tensor]
                    ) -> Tuple[Tensor, Tensor]:
    """The launch: (N, k) votes (+ (k,) noise) -> (signs, energy)."""
    global SIGN_MV_LAUNCHES
    _check_matrix("votes", votes)
    if not votes.is_contiguous():
        raise ValueError("votes must be contiguous float32")
    n, k = votes.shape
    if noise is not None:
        check_vec("noise", noise, k, votes.device)
    lib = build.load()
    signs = torch.empty(k, dtype=torch.float32, device=votes.device)
    energy = torch.empty_like(signs)
    stream = torch.cuda.current_stream(votes.device).cuda_stream
    p = build.ptr
    rc = lib.repro_sign_mv(p(votes), p(noise), p(signs), p(energy), n, k,
                           stream)
    build.check(rc, "sign_mv")
    SIGN_MV_LAUNCHES += 1
    return signs, energy


def _sign_mv_fake(votes, noise):
    k = votes.shape[1]
    return votes.new_empty(k), votes.new_empty(k)


def sign_mv_cuda(votes: Tensor, noise: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor]:
    """(N, k) votes (+ (k,) noise) -> (signs, energy), both (k,) float32."""
    return sign_mv_op(votes, noise)


def _vote_fold_launch(acc: Tensor, x: Tensor, idx: Optional[Tensor],
                      row: Optional[Tensor]) -> None:
    """``acc[j] += Σ_r (x[r, idx[j]] >= 0 ? +1 : −1)`` in place, for a
    (C, d) float32 ``x`` whose rows are contiguous (any row stride) and an
    int64 ``idx`` of values in [0, d) (None: ``idx[j] = j``).  With a (C,)
    float32 ``row`` each vote is ``((x >= 0 ? 1 : −1)·row[r] >= 0) ? +1 :
    −1`` (the same launch)."""
    global SIGN_MV_LAUNCHES
    _check_matrix("x", x)
    n, d = x.shape
    if d > 1 and x.stride(1) != 1:
        raise ValueError("x must have contiguous rows (column stride 1)")
    if idx is not None:
        if idx.device != x.device or idx.dtype != torch.int64:
            raise ValueError(f"idx must be int64 on {x.device}, got "
                             f"{idx.dtype} on {idx.device}")
        if idx.dim() != 1 or not idx.is_contiguous():
            raise ValueError("idx must be a contiguous (k,) row")
    k = d if idx is None else idx.shape[0]
    check_vec("acc", acc, k, x.device)
    if row is not None:
        check_vec("row", row, n, x.device)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    p = build.ptr
    rc = lib.repro_vote_fold(p(x), x.stride(0), p(idx), p(row), p(acc), n, k,
                             stream)
    build.check(rc, "vote_fold")
    SIGN_MV_LAUNCHES += 1


def _vote_fold_fake(acc, x, idx, row):
    return None


def vote_fold_cuda(acc: Tensor, x: Tensor, idx: Optional[Tensor] = None,
                   row: Optional[Tensor] = None) -> Tensor:
    """``vote_fold_op`` on ``acc`` in place; returns ``acc``."""
    vote_fold_op(acc, x, idx, row)
    return acc


def _sign_from_energy_launch(energy: Tensor, noise: Optional[Tensor],
                             z: Optional[Tensor], noise_std: float,
                             score: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """The launch -> (signs, energy', score | an empty (0,) row)."""
    global SIGN_FROM_ENERGY_LAUNCHES
    k = energy.shape[0] if energy.dim() == 1 else -1
    check_vec("energy", energy, k, energy.device)
    if noise is not None and z is not None:
        raise ValueError("pass the noise or the draw z, not both")
    add = noise if z is None else z
    if add is not None:
        check_vec("noise" if z is None else "z", add, k, energy.device)
    lib = build.load()
    signs = torch.empty_like(energy)
    energy_out = torch.empty_like(energy)
    score_out = torch.empty_like(energy) if score else None
    stream = torch.cuda.current_stream(energy.device).cuda_stream
    p = build.ptr
    rc = lib.repro_sign_from_energy(p(energy), p(add), int(z is not None),
                                    float(noise_std), p(signs),
                                    p(energy_out), p(score_out), k, stream)
    build.check(rc, "sign_from_energy")
    SIGN_FROM_ENERGY_LAUNCHES += 1
    return (signs, energy_out,
            energy.new_empty(0) if score_out is None else score_out)


def _sign_from_energy_fake(energy, noise, z, noise_std, score):
    return (torch.empty_like(energy), torch.empty_like(energy),
            torch.empty_like(energy) if score else energy.new_empty(0))


for _name, _launch, _fake in (
        ("sign_mv", _sign_mv_launch, _sign_mv_fake),
        ("vote_fold", _vote_fold_launch, _vote_fold_fake),
        ("sign_from_energy", _sign_from_energy_launch,
         _sign_from_energy_fake)):
    LIB.impl(_name, _launch, "CompositeExplicitAutograd")
    torch.library.register_fake(f"repro_torch::{_name}", _fake, lib=LIB)
sign_mv_op = torch.ops.repro_torch.sign_mv.default
vote_fold_op = torch.ops.repro_torch.vote_fold.default
sign_from_energy_op = torch.ops.repro_torch.sign_from_energy.default


def sign_from_energy_cuda(energy: Tensor, noise: Optional[Tensor] = None,
                          z: Optional[Tensor] = None, noise_std: float = 0.0,
                          score: bool = False) -> Tuple[Tensor, ...]:
    """(k,) energy, plus ``noise`` or ``noise_std * z`` (not both) ->
    ``(signs, energy')``, and the score ``|energy'| + knuth_jitter(j)`` as
    a third (k,) row when ``score``."""
    signs, energy_out, score_out = sign_from_energy_op(
        energy, noise, z, float(noise_std), bool(score))
    if score:
        return signs, energy_out, score_out
    return signs, energy_out
