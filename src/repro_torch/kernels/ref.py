"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, with ordinary
tensor operations, on any device.  The dispatchers in ``kernels.ops`` use
them for tensors on the CPU; the tests and ``chip_smoke.py`` hold the
kernels against them on the card.  They mirror ``repro.kernels.ref``
line for line.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import aou, oac, packing, selection

Tensor = torch.Tensor

KNUTH = 2654435761


def knuth_jitter(idx: Tensor) -> Tensor:
    """Per-coordinate jitter in [0, 1) from the global index: the uint32
    product ``idx * 2654435761`` (wrapping) mod 2^24, times 2^-24.  The low
    24 bits of a product depend only on the low 24 bits of its factors, so
    int64 arithmetic on those gives the wrapped uint32 result exactly."""
    u = idx.to(torch.int64) & 0xFFFFFFFF
    h = ((u & 0xFFFFFF) * (KNUTH & 0xFFFFFF)) & 0xFFFFFF
    return h.to(torch.float32) / float(1 << 24)


def _hist_counts(bins: Tensor, weight: Tensor, n_bins: int) -> Tensor:
    """Exact integer counts of f32 bin indices where ``weight`` holds, along
    the last axis (one histogram per leading index); NaN bins fall in no
    bin.  Scatter of int64 ones: no host sync."""
    take = weight & ~torch.isnan(bins)
    idx = torch.where(take, bins, torch.full_like(bins, float(n_bins)))
    idx = idx.to(torch.int64)
    counts = torch.zeros(bins.shape[:-1] + (n_bins + 1,), dtype=torch.int64,
                         device=bins.device)
    counts.scatter_add_(-1, idx, torch.ones_like(idx))
    return counts[..., :n_bins].to(torch.float32)


def strided_hists_ref(score: Tensor, age_next: Tensor, valid: Tensor,
                      stride: int) -> Tuple[Tensor, Tensor]:
    """(mag_hist, age_hist) over the global ``[::stride]`` sample of the
    last axis (a (lanes, d) block gives one pair of rows per lane)."""
    w = valid[..., ::stride]
    return (_hist_counts(packing.mag_bin(score[..., ::stride].abs()), w,
                         packing.STATS_MAG_BINS),
            _hist_counts(packing.age_bin(age_next[..., ::stride]), w,
                         packing.STATS_AGE_BINS))


def sign_from_energy_ref(energy: Tensor, noise: Optional[Tensor] = None,
                         z: Optional[Tensor] = None, noise_std: float = 0.0,
                         score: bool = False) -> Tuple[Tensor, ...]:
    """Majority stage for a pre-reduced (k,) vote-energy row:
    ``s = energy (+ noise)``, the noise given as it is or as the draw ``z``
    scaled by ``noise_std`` -> ``(s >= 0 ? +1 : -1, s)``, and with
    ``score`` the packed path's selection score ``|s| + knuth_jitter(j)``
    as a third row."""
    if z is not None:
        noise = noise_std * z
    s = energy
    if noise is not None:
        s = s + noise.to(s.dtype)
    signs = torch.where(s >= 0, 1.0, -1.0).to(energy.dtype)
    if not score:
        return signs, s
    return signs, s, s.abs() + knuth_jitter(torch.arange(s.shape[0],
                                                         device=s.device))


def sign_mv_ref(votes: Tensor, noise: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """FSK majority vote over (N, k) one-bit votes -> (signs, energy).
    ``v >= 0`` votes +1 (so ±0.0 count +1), NaN votes -1."""
    s = torch.where(votes >= 0, 1.0, -1.0).to(torch.float32).sum(dim=0)
    return sign_from_energy_ref(s, noise)


def vote_fold_ref(acc: Tensor, x: Tensor, idx: Optional[Tensor] = None,
                  row: Optional[Tensor] = None) -> Tensor:
    """The one-bit chunk fold, in place: ``acc += `` the vote energy of the
    (C, d) chunk ``x``, gathered at ``idx`` when given; with a (C,) ``row``
    the votes are ``one_bit(x) · row[:, None]`` before ``sign_mv``'s
    re-sign (the reference trainer's wireless fold) -> ``acc``."""
    x = x if idx is None else x[:, idx]
    if row is not None:
        x = torch.where(x >= 0, 1.0, -1.0).to(torch.float32) * row[:, None]
    return acc.add_(sign_mv_ref(x)[1])


def aou_merge_ref(g_new: Tensor, g_old: Tensor, age: Tensor, mask: Tensor
                  ) -> Tuple[Tensor, Tensor]:
    """Fused Eq. (8) merge + Eq. (10) AoU update over four (d,) vectors:
    ``g = m·g_new + (1−m)·g_old``, ``age' = min((age+1)·(1−m), AGE_CAP)``
    (arithmetic form, not a select: NaN and signed zeros come out as in
    ``repro.kernels.ref.aou_merge_ref``; a NaN age stays NaN)."""
    keep = 1.0 - mask
    g = mask * g_new + keep * g_old
    age_next = torch.clamp((age + 1.0) * keep, max=packing.AGE_CAP)
    return g, age_next


def aou_merge_by_indices_ref(idx: Tensor, fresh: Tensor, g_prev: Tensor,
                             age: Tensor, sel_count: Tensor, n_clients: int,
                             superposed: bool = False,
                             z: Optional[Tensor] = None,
                             noise_std: float = 0.0,
                             ef_sum: Optional[Tensor] = None
                             ) -> Tuple[Tensor, Tensor, Tensor, Tensor,
                                        Optional[Tensor]]:
    """The exact trainer's server-state update, as the round composed it
    from separate operations: with ``superposed`` the (k,) row is the raw
    faded sum and gets Eq. 7's receiver tail ``(row + noise_std·z) / N``
    (1/N as the product with ``oac.reciprocal(N)``)
    (the noise only when ``noise_std`` > 0); Eq. 8 as a scatter (a −0.0
    value stays −0.0, a non-finite ``g_prev`` at ``idx`` is replaced);
    the 0/1 selection mask; Eq. 10 in index form (``min(age+1, AGE_CAP)``,
    +0.0 at ``idx`` even for a NaN age); the participation count
    ``sel_count + mask``; with ``ef_sum`` the client-side EF residual
    ``(ef_sum / N)·(1 − mask)`` -> ``(g_t, age', mask, sel_count',
    residual' | None)``."""
    d = g_prev.shape[0]
    if superposed:
        if noise_std > 0.0:
            fresh = fresh + noise_std * z
        fresh = fresh * oac.reciprocal(n_clients)
    g_t = oac.reconstruct(g_prev, idx, fresh)
    mask = selection.mask_from_indices(idx, d)
    residual = ((ef_sum * oac.reciprocal(n_clients)) * (1.0 - mask)
                if ef_sum is not None else None)
    age_next = aou.update_age_by_indices(age, idx)
    return g_t, age_next, mask, sel_count + mask, residual


def masked_merge_by_indices_ref(idx: Tensor, sent: Tensor, g_prev: Tensor,
                                age: Tensor, noise: Optional[Tensor] = None,
                                noise_scale: float = 0.0,
                                score: Optional[Tensor] = None
                                ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """The exact engine's update for a selection ``idx``, as the engine
    composed it: the 0/1 mask, ``sent + noise_scale·noise`` (when ``noise``
    is given), the mask-form merge and age of ``aou_merge_ref`` (so a
    selected −0.0 may come out +0.0 and a non-finite value on either side
    makes NaN), and with ``score`` the residual ``score − mask·sent`` ->
    ``(g_t, age', residual' | None)``."""
    mask = selection.mask_from_indices(idx, g_prev.shape[0])
    sent = sent.to(torch.float32)
    noisy = sent if noise is None else sent + noise_scale * noise
    g_t, age_next = aou_merge_ref(noisy, g_prev.to(torch.float32),
                                  age.to(torch.float32), mask)
    residual = score - mask * sent if score is not None else None
    return g_t, age_next, residual


def check_block_topk(d: int, block_size: int, m: int) -> int:
    """The number of blocks; raises ``ValueError`` on a shape the per-block
    top-m does not take."""
    if block_size < 1 or d < block_size or d % block_size:
        raise ValueError(f"d={d} not divisible by block_size={block_size}")
    if not 1 <= m <= block_size:
        raise ValueError(f"need 1 <= m <= block_size={block_size}, got "
                         f"m={m}")
    if d >= 2**31:
        raise ValueError(f"d={d}: global indices are int32")
    return d // block_size


def block_topk_ref(x: Tensor, block_size: int, m: int
                   ) -> Tuple[Tensor, Tensor]:
    """Per-block top-m magnitudes: x (d,) with d % block_size == 0 ->
    (vals, idxs), each (d // block_size, m): the m largest |x| of every
    contiguous block, descending, ties toward the lower index, and their
    global int32 indices."""
    nb = check_block_topk(x.shape[0], block_size, m)
    xb = x.to(torch.float32).abs().reshape(nb, block_size)
    vals, local = torch.sort(xb, dim=1, descending=True, stable=True)
    base = torch.arange(nb, device=x.device).unsqueeze(1) * block_size
    return vals[:, :m].contiguous(), (local[:, :m] + base).to(torch.int32)


def _fairk_core(g, g_prev, age, theta_m, theta_a, residual, fresh,
                sanitize):
    """Shared elementwise body: (g_t, age', res' | None, score, ok,
    mask, mask_m)."""
    g32 = g.to(torch.float32)
    age32 = age.to(torch.float32)
    res32 = residual.to(torch.float32) if residual is not None else None
    score = g32 + res32 if residual is not None else g32
    jitter = knuth_jitter(torch.arange(g.shape[0], device=g.device))
    valid = age32 >= 0.0
    if sanitize:
        fin = torch.isfinite(score)
        ok = valid & fin
        score = torch.where(fin, score, torch.zeros_like(score))
    else:
        ok = valid
    mask_m = ok & (score.abs() >= theta_m)
    mask = mask_m | (ok & (age32 + jitter >= theta_a) & ~mask_m)
    maskf = mask.to(torch.float32)
    keep = 1.0 - maskf
    sent = fresh.to(torch.float32) if fresh is not None else score
    if sanitize and fresh is not None:
        sent = torch.where(torch.isfinite(sent), sent,
                           torch.zeros_like(sent))
    g_t = maskf * sent + keep * g_prev.to(torch.float32)
    age_next = torch.where(
        valid, torch.clamp((age32 + 1.0) * keep, max=packing.AGE_CAP),
        age32)
    res_next = (torch.where(ok, score - maskf * sent, res32)
                if residual is not None else None)
    return g_t, age_next, res_next, score, ok, mask, mask_m


def fairk_update_ref(g: Tensor, g_prev: Tensor, age: Tensor, theta_m,
                     theta_a, sanitize: bool = False
                     ) -> Tuple[Tensor, Tensor]:
    """The fused FAIR-k server pass without the residual stage or ``fresh``
    values -> ``(g_t, age')`` (see ``fairk_ef_update_ref``)."""
    g_t, age_next, *_ = _fairk_core(g, g_prev, age, theta_m, theta_a, None,
                                    None, sanitize)
    return g_t, age_next


def fairk_ef_update_ref(g: Tensor, g_prev: Tensor, age: Tensor,
                        theta_m, theta_a, residual: Optional[Tensor] = None,
                        fresh: Optional[Tensor] = None,
                        sanitize: bool = False
                        ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """The fused FAIR-k server pass: ``score = g (+ residual)``; two-stage
    mask (|score| >= θ_M, else age + jitter >= θ_A; pads never); merge
    ``g_t = m·sent + (1−m)·g_prev`` with ``sent = fresh or score``; age
    ``min((age+1)(1−m), AGE_CAP)`` with pads passed through; residual
    ``ok ? score − m·sent : residual``.  ``sanitize`` keeps non-finite
    scores out of both stages and zeroes them (and non-finite ``fresh``)."""
    g_t, age_next, res_next, *_ = _fairk_core(
        g, g_prev, age, theta_m, theta_a, residual, fresh, sanitize)
    return g_t, age_next, res_next


def fairk_stats_update_ref(g: Tensor, g_prev: Tensor, age: Tensor,
                           theta_m, theta_a,
                           residual: Optional[Tensor] = None,
                           fresh: Optional[Tensor] = None,
                           stats_stride: int = 1, sanitize: bool = False
                           ) -> Tuple[Tensor, Tensor, Optional[Tensor],
                                      Dict[str, Tensor]]:
    """``fairk_ef_update_ref`` plus the statistics: exact counts ``n_sel``
    and ``n_sel_m`` and the ``mag_hist`` (of |score|) / ``age_hist`` (of
    the post-update age) over the strided sample, weighted by ``ok``."""
    g_t, age_next, res_next, score, ok, mask, mask_m = _fairk_core(
        g, g_prev, age, theta_m, theta_a, residual, fresh, sanitize)
    mag_hist, age_hist = strided_hists_ref(score, age_next, ok, stats_stride)
    stats = {"n_sel": mask.sum().to(torch.float32),
             "n_sel_m": mask_m.sum().to(torch.float32),
             "mag_hist": mag_hist, "age_hist": age_hist}
    return g_t, age_next, res_next, stats
