"""Dispatchers for the port's kernels, mirroring ``repro.kernels.ops``.

``mode``: ``None`` launches the CUDA kernel on a CUDA tensor and uses the
plain PyTorch version (``kernels.ref``) on a CPU tensor; ``"kernel"``
launches the kernel and raises on a CPU tensor; ``"plain"`` runs the
plain version on any device (the tests and ``chip_smoke.py`` compare the
two with it).  Nothing falls back: a kernel that fails to build or launch
raises.  Each kernel is a ``torch.library`` custom op, so ``"kernel"``
also takes a ``FakeTensor`` on any device: under ``FakeTensorMode``
nothing launches, and the op's fake implementation gives the outputs
(``roofline.dispatch`` counts a step that way).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core import packing
from repro_torch.kernels import aou_merge as am
from repro_torch.kernels import block_topk as bt
from repro_torch.kernels import fairk_update as fk
from repro_torch.kernels import ref
from repro_torch.kernels import sign_mv as smv

Tensor = torch.Tensor

MODES = (None, "kernel", "plain")

# how many fused FAIR-k server passes were dispatched (kernel or plain)
FAIRK_UPDATE_CALLS = 0


def resolve_mode(mode: Optional[str], t: Tensor) -> str:
    """``"kernel"`` or ``"plain"`` for a tensor, per the rules above."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode is None:
        return "kernel" if t.is_cuda else "plain"
    if mode == "kernel" and not (t.is_cuda or isinstance(t, FakeTensor)):
        raise ValueError(f"mode='kernel' needs CUDA tensors, got a tensor "
                         f"on {t.device}")
    return mode


def _f32(t: Optional[Tensor]) -> Optional[Tensor]:
    return None if t is None else t.to(torch.float32).contiguous()


def _theta(v, device) -> Tensor:
    """A threshold as a 0-dim float32 tensor on ``device``: a view of a
    float32 tensor already there (no device operation), else a copy."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())


def aou_merge(g_new: Tensor, g_old: Tensor, age: Tensor, mask: Tensor,
              mode: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """Fused Eq. (8) merge + Eq. (10) AoU update -> float32 ``(g, age')``:
    ``g = m·g_new + (1−m)·g_old``, ``age' = min((age+1)·(1−m), AGE_CAP)``."""
    args = [_f32(t) for t in (g_new, g_old, age, mask)]
    if resolve_mode(mode, g_new) == "plain":
        return ref.aou_merge_ref(*args)
    return am.aou_merge_cuda(*args)


def aou_merge_by_indices(idx: Tensor, fresh: Tensor, g_prev: Tensor,
                         age: Tensor, sel_count: Tensor, *, n_clients: int,
                         superposed: bool = False,
                         z: Optional[Tensor] = None, noise_std: float = 0.0,
                         ef_sum: Optional[Tensor] = None,
                         mode: Optional[str] = None
                         ) -> Tuple[Tensor, Tensor, Tensor, Tensor,
                                    Optional[Tensor]]:
    """The exact trainer's whole server-state update for the int64
    selection ``idx`` (k,) and its fresh (k,) row -> ``(g_t, age', mask,
    sel_count', residual' | None)``: Eq. 8 as a scatter, Eq. 10 in index
    form, the 0/1 mask, the participation count and, with ``ef_sum``, the
    EF residual ``(ef_sum / N)·(1 − mask)``.  With ``superposed`` the row
    is the raw faded sum, and Eq. 7's receiver tail ``(row +
    noise_std·z) / N`` is applied to it first.  The values of ``idx`` must
    be distinct and in [0, d).  On the card one call is one device
    operation (``ref.aou_merge_by_indices_ref`` is the plain version)."""
    if superposed and noise_std > 0.0 and z is None:
        raise ValueError("noise_std > 0 needs a noise draw z")
    z = z if superposed and noise_std > 0.0 else None
    if resolve_mode(mode, g_prev) == "plain":
        return ref.aou_merge_by_indices_ref(
            idx, fresh, g_prev, age, sel_count, n_clients,
            superposed=superposed, z=z, noise_std=noise_std, ef_sum=ef_sum)
    return am.merge_by_indices_cuda(
        idx.to(torch.int64).contiguous(), _f32(fresh), _f32(g_prev),
        _f32(age), sel_count=_f32(sel_count), noise=_f32(z),
        noise_mul=noise_std, n_clients=n_clients, superposed=superposed,
        aux=_f32(ef_sum))


def masked_merge_by_indices(idx: Tensor, sent: Tensor, g_prev: Tensor,
                            age: Tensor, *, noise: Optional[Tensor] = None,
                            noise_scale: float = 0.0,
                            score: Optional[Tensor] = None,
                            mode: Optional[str] = None
                            ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """The exact engine's update for the int64 selection ``idx`` -> ``(g_t,
    age', residual' | None)``: ``aou_merge`` of ``sent + noise_scale·noise``
    over ``g_prev`` with the 0/1 mask of ``idx`` (the arithmetic form, not
    a scatter), and with ``score`` the residual ``score − mask·sent``.
    The values of ``idx`` must be distinct and in [0, d).  On the card one
    call is one device operation (``ref.masked_merge_by_indices_ref`` is
    the plain version)."""
    if resolve_mode(mode, g_prev) == "plain":
        return ref.masked_merge_by_indices_ref(
            idx, sent, g_prev, age, noise=noise, noise_scale=noise_scale,
            score=score)
    g_t, age_out, _, _, res = am.merge_by_indices_cuda(
        idx.to(torch.int64).contiguous(), _f32(sent), _f32(g_prev),
        _f32(age), noise=_f32(noise), noise_mul=noise_scale,
        aux=_f32(score), arith=True)
    return g_t, age_out, res


def block_topk(x: Tensor, block_size: int = 4096, m: int = 16,
               mode: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """Per-block top-m of ``|x|`` (d % block_size == 0) -> ``(vals,
    idxs)``, each (d // block_size, m): values descending, ties toward the
    lower index, global int32 indices."""
    if resolve_mode(mode, x) == "plain":
        return ref.block_topk_ref(x, block_size, m)
    return bt.block_topk_cuda(_f32(x), block_size, m)


def global_topk_from_candidates(vals: Tensor, idxs: Tensor, k: int
                                ) -> Tuple[Tensor, Tensor]:
    """Stage 2 of the two-stage top-k: the global top-k of the (nb, m)
    candidate pool, ties toward the earlier candidate (a stable descending
    sort, as ``lax.top_k``).  Exact whenever no block holds more than m of
    the true top-k."""
    flat_vals = vals.reshape(-1)
    if not 0 <= k <= flat_vals.shape[0]:
        raise ValueError(f"k={k} exceeds the {flat_vals.shape[0]} "
                         f"candidates")
    top_vals, pos = torch.sort(flat_vals, descending=True, stable=True)
    return top_vals[:k], idxs.reshape(-1)[pos[:k]]


def two_stage_topk(x: Tensor, k: int, block_size: int = 4096,
                   m: Optional[int] = None, mode: Optional[str] = None
                   ) -> Tuple[Tensor, Tensor]:
    """Top-k of ``|x|``: per-block candidates (``block_topk``), then the
    global top-k of the pool.  ``m`` defaults to a pool ~4x oversampled
    against a uniform spread of the top-k over the blocks."""
    nb = max(1, x.shape[0] // block_size)   # block_topk rejects the shape
    if m is None:
        m = min(block_size, max(4, (4 * k + nb - 1) // nb))
    vals, idxs = block_topk(x, block_size, m, mode=mode)
    return global_topk_from_candidates(vals, idxs, k)


def sign_mv(votes: Tensor, noise: Optional[Tensor] = None,
            mode: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """FSK majority vote over (N, k) one-bit values -> ``(signs, energy)``;
    ``noise`` (k,) perturbs the superposed energy before the sign."""
    if resolve_mode(mode, votes) == "plain":
        return ref.sign_mv_ref(votes, noise)
    return smv.sign_mv_cuda(_f32(votes), _f32(noise))


def vote_fold(acc: Tensor, x: Tensor, idx: Optional[Tensor] = None,
              mode: Optional[str] = None, row: Optional[Tensor] = None
              ) -> Tensor:
    """The one-bit chunk fold: ``acc[j] += Σ_r (x[r, idx[j]] >= 0 ? +1 :
    −1)`` in place on the (k,) float32 ``acc`` (k = d without ``idx``),
    for the chunk's (C, d) effective gradients ``x`` and the exact path's
    int64 selection ``idx``.  Returns ``acc``.  The counts are the energy
    row of ``sign_mv`` (``x`` needs no ``one_bit`` first: ``v >= 0`` votes
    +1, NaN −1).  ``row`` (C,) weights each client's votes before the
    re-sign, ``((x >= 0 ? 1 : −1)·row[r] >= 0) ? +1 : −1`` — the wireless
    route's ``one_bit(x)·row`` into ``sign_mv``: a zero weight votes +1, a
    negative one flips the vote, NaN votes −1.  On the card one call is
    one device operation for float32 ``x`` with contiguous rows, int64
    ``idx`` and a float32 ``row``."""
    if resolve_mode(mode, x) == "plain":
        return ref.vote_fold_ref(acc, x, idx, row)
    if x.dtype != torch.float32 or x.stride(-1) != 1:
        x = x.to(torch.float32).contiguous()
    if idx is not None:
        idx = idx.to(torch.int64).contiguous()
    if row is not None:
        row = row.to(torch.float32).contiguous()
    return smv.vote_fold_cuda(acc, x, idx, row)


def sign_from_energy(energy: Tensor, noise: Optional[Tensor] = None,
                     mode: Optional[str] = None, *,
                     z: Optional[Tensor] = None, noise_std: float = 0.0,
                     score: bool = False) -> Tuple[Tensor, ...]:
    """Majority stage for a pre-reduced (k,) vote-energy row ->
    ``(signs, energy')``.  The channel noise is ``noise`` as it is, or
    ``noise_std * z`` for a standard-normal draw ``z`` (off when
    ``noise_std`` is 0).  With ``score`` a third row, the packed path's
    selection score ``|energy'| + knuth_jitter(j)``.  On the card one call
    is one device operation."""
    if noise is not None and z is not None:
        raise ValueError("pass the noise or the draw z, not both")
    if noise_std > 0.0 and z is None:
        raise ValueError("noise_std > 0 needs a noise draw z")
    z = z if noise_std > 0.0 else None
    if resolve_mode(mode, energy) == "plain":
        return ref.sign_from_energy_ref(energy, noise, z=z,
                                        noise_std=noise_std, score=score)
    return smv.sign_from_energy_cuda(_f32(energy), _f32(noise), z=_f32(z),
                                     noise_std=noise_std, score=score)


def fairk_update(g: Tensor, g_prev: Tensor, age: Tensor, theta_m, theta_a,
                 mode: Optional[str] = None, sanitize: bool = False
                 ) -> Tuple[Tensor, Tensor]:
    """Fused FAIR-k server pass without the residual stage or decoupled
    ``fresh`` values -> ``(g_t, age')``: the same kernel launch as
    ``fairk_ef_update``."""
    g_t, age_out, _ = fairk_ef_update(g, g_prev, age, theta_m, theta_a,
                                      mode=mode, sanitize=sanitize)
    return g_t, age_out


def fairk_ef_update(g: Tensor, g_prev: Tensor, age: Tensor, theta_m,
                    theta_a, residual: Optional[Tensor] = None,
                    fresh: Optional[Tensor] = None,
                    mode: Optional[str] = None, sanitize: bool = False
                    ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Fused FAIR-k server pass, optionally with the residual
    (error-feedback) stage and decoupled ``fresh`` values:
    ``(g_t, age', residual' | None)``."""
    global FAIRK_UPDATE_CALLS
    FAIRK_UPDATE_CALLS += 1
    packing.G_READS += 1
    tm, ta = _theta(theta_m, g.device), _theta(theta_a, g.device)
    if resolve_mode(mode, g) == "plain":
        return ref.fairk_ef_update_ref(g, g_prev, age, tm, ta,
                                       residual=residual, fresh=fresh,
                                       sanitize=sanitize)
    g_t, age_out, res_out, _ = fk.fairk_update_cuda(
        _f32(g), _f32(g_prev), _f32(age), tm, ta, residual=_f32(residual),
        fresh=_f32(fresh), stats_stride=0, sanitize=sanitize)
    return g_t, age_out, res_out


def fairk_stats_update(g: Tensor, g_prev: Tensor, age: Tensor, theta_m,
                       theta_a, residual: Optional[Tensor] = None,
                       fresh: Optional[Tensor] = None,
                       mode: Optional[str] = None, sanitize: bool = False
                       ) -> Tuple[Tensor, Tensor, Optional[Tensor],
                                  Dict[str, Tensor]]:
    """``fairk_ef_update`` that also returns the selection statistics from
    the same pass: ``n_sel``, ``n_sel_m`` and the strided ``mag_hist`` /
    ``age_hist`` (sample stride ``packing.hist_stride(d)``).  On the card,
    with float32 inputs and thresholds already there, the call is one
    device operation: the kernel writes the statistics row, and the four
    entries are views of it."""
    global FAIRK_UPDATE_CALLS
    FAIRK_UPDATE_CALLS += 1
    packing.G_READS += 1
    tm, ta = _theta(theta_m, g.device), _theta(theta_a, g.device)
    stride = packing.hist_stride(g.shape[0])
    if resolve_mode(mode, g) == "plain":
        return ref.fairk_stats_update_ref(
            g, g_prev, age, tm, ta, residual=residual, fresh=fresh,
            stats_stride=stride, sanitize=sanitize)
    g_t, age_out, res_out, vec = fk.fairk_update_cuda(
        _f32(g), _f32(g_prev), _f32(age), tm, ta, residual=_f32(residual),
        fresh=_f32(fresh), stats_stride=stride, sanitize=sanitize)
    stats = {"n_sel": vec[fk.STATS_N_SEL], "n_sel_m": vec[fk.STATS_N_SEL_M],
             "mag_hist": vec[fk.STATS_MAG_OFF:fk.STATS_AGE_OFF],
             "age_hist": vec[fk.STATS_AGE_OFF:fk.STATS_SIZE]}
    return g_t, age_out, res_out, stats
