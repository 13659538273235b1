"""The FAIR-k selection engine on the exact and packed backends (the
subset of ``repro.core.engine`` that the FL round needs).

``SelectionEngine.select_and_merge(g, g_prev, age)`` runs one server
phase: select on ``g``, merge the fresh values over the stale ``g_prev``
(Eq. 8) and advance the age (Eq. 10).

* ``exact``: index-form selection (``core.selection``, all six policies;
  rank form under ``sanitize`` and for a traced split), then one
  ``aou_merge`` kernel launch: for the selected indices the noise, merge,
  age step and residual (``ops.masked_merge_by_indices``); under
  ``sanitize`` the mask-form merge and age step (``masked_merge``).
* ``packed``: thresholds (θ_M, θ_A) from the carried statistics alone,
  then ONE fused kernel pass (``kernels.ops.fairk_stats_update``) that
  selects (Eq. 11), merges, advances the age, folds the error-feedback
  residual and emits the counts and histograms the next round's
  thresholds come from.

A traced split (``select_and_merge(k_m_frac=tensor)``, the adaptive
controller's live ``k_m_frac``) keeps ``k`` static and moves ``k_M =
traced_km(k, k_m_frac)`` as a 0-d device tensor: the exact backend selects
by rank (the same coordinate set as the index form), the packed backend
takes it into its statistics thresholds; neither reads it back to the
host.  The threshold and sharded backends, the sampled-quantile bootstrap
and async lag are not ported yet (ROADMAP Queue 1); asking for them raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import oac, packing, selection
from repro_torch.kernels import ops, ref

Tensor = torch.Tensor

BACKENDS = ("exact", "threshold", "sharded", "packed")
POLICIES = selection.POLICIES
# FAIR-k-family policies expressible as (θ_M, θ_A) thresholds
THRESHOLD_POLICIES = ("fairk", "topk", "roundrobin")
AGE_CAP = packing.AGE_CAP

_NOT_PORTED = "not ported yet (ROADMAP Queue 1 item {item})"


def jitter_from_ids(ids: Tensor) -> Tensor:
    """Deterministic per-coordinate jitter in [0, 1): the Knuth hash of
    the coordinate index (bit-identical to the kernel's recomputation)."""
    return ref.knuth_jitter(ids)


def index_jitter(n: int, offset: int = 0, device=None) -> Tensor:
    """Jitter for coordinates [offset, offset + n)."""
    return jitter_from_ids(torch.arange(offset, offset + n, device=device))


def rank_desc(x: Tensor) -> Tensor:
    """rank[i] = number of entries ranked above x[i] (descending, ties
    toward the lower index, NaN last — ``jnp.argsort(-x, stable=True)``),
    along the last axis (a (lanes, d) block ranks each row)."""
    order = torch.sort(-x, dim=-1, stable=True).indices
    ar = torch.arange(x.shape[-1], device=x.device)
    return torch.empty_like(order).scatter_(
        -1, order, ar.expand_as(order).contiguous())


def fair_k_masks_dynamic(score: Tensor, age: Tensor, k: int, k_m: int
                         ) -> Tuple[Tensor, Tensor]:
    """Rank-form FAIR-k (Eq. 11) -> float32 ``(mask, mask_m)``:
    ``rank(score) < k_m``, then ``rank(age ⊙ ¬mask_m) < k − k_m`` — the
    coordinate set of the index form (ties toward the lower index in
    both), exactly k ones.  ``score`` is the magnitude-stage statistic;
    ``k_m`` an int or an integer tensor (the traced split; a (lanes, 1)
    column gives each row of a (lanes, d) block its own)."""
    mask_m = rank_desc(score) < k_m
    # the magnitude picks leave the age stage; -1 never wins (ages >= 0)
    age_rest = torch.where(mask_m, -1.0, age.to(torch.float32))
    mask_a = rank_desc(age_rest) < (k - k_m)
    return ((mask_m | mask_a).to(torch.float32),
            mask_m.to(torch.float32))


def fair_k_mask_dynamic(score: Tensor, age: Tensor, k: int, k_m: int
                        ) -> Tensor:
    """The combined mask of ``fair_k_masks_dynamic``."""
    return fair_k_masks_dynamic(score, age, k, k_m)[0]


def traced_km(k: int, k_m_frac) -> Tensor:
    """``k_M = round(clip(k_m_frac, 0, 1) · k)`` as int32, computed in
    float32 and rounded half to even (``jnp.round``), on the device of
    ``k_m_frac`` — the one rounding of the traced split (engine backends,
    the trainer's exact route and the sweep lanes all call it)."""
    f = torch.as_tensor(k_m_frac, dtype=torch.float32)
    return torch.round(torch.clamp(f, 0.0, 1.0) * k).to(torch.int32)


def km_frac_of(k_m: Tensor, k: int) -> Tensor:
    """The realised split ``k_M / k`` of a traced budget in float32, as the
    compiled reference computes it (the product with float32 ``1/k``)."""
    if not k:
        return torch.zeros_like(k_m, dtype=torch.float32)
    return k_m.to(torch.float32) * oac.reciprocal(k)


def mask_to_indices(mask: Tensor, k: int) -> Tensor:
    """The ascending int64 indices of a 0/1 mask with exactly ``k`` ones
    (``jnp.nonzero(mask, size=k)``) without a host sync: each selected
    coordinate scatters its index to its position in the running count;
    the unselected ones land in one spare slot that is cut off."""
    sel = mask > 0.0
    pos = torch.cumsum(sel.to(torch.int64), 0) - 1
    pos = torch.where(sel, pos, k)
    out = torch.zeros(k + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, pos, torch.arange(mask.shape[0], device=mask.device))
    return out[:k]


def eff_score(g: Tensor, residual: Optional[Tensor]) -> Tensor:
    """The error-feedback fold ``score = g + residual`` in float32."""
    g32 = g.to(torch.float32)
    return g32 if residual is None else g32 + residual.to(torch.float32)


def masked_merge(fresh: Tensor, g_prev: Tensor, age: Tensor, mask: Tensor,
                 mode: Optional[str] = None) -> Tuple[Tensor, Tensor]:
    """Eq. (8) stale merge + Eq. (10) AoU update in mask form (float32
    out), one ``aou_merge`` kernel pass."""
    return ops.aou_merge(fresh, g_prev, age, mask, mode=mode)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Backend-independent FAIR-k settings (field names and defaults of
    ``repro.core.engine.EngineConfig``).  ``kernel_mode``: None (the kernel
    on CUDA tensors, the plain version on CPU tensors) | "kernel" |
    "plain"."""
    policy: str = "fairk"
    backend: str = "exact"
    rho: float = 0.1
    k_m_frac: float = 0.75
    r_frac: float = 1.5
    k: Optional[int] = None
    k_m: Optional[int] = None
    r: Optional[int] = None
    sample_cap: int = 65536
    exact_theta: bool = False
    global_thresholds: bool = False
    noise_std: float = 0.0
    n_clients: int = 1
    kernel_mode: Optional[str] = None
    fused_stats: bool = False
    warm_start: bool = False
    warm_alpha: float = 0.5
    warm_clip: float = 2.0
    warm_tol: float = 0.25
    warm_streak: int = 3
    reduce_axes: Tuple[str, ...] = ()


def budgets_for(cfg: EngineConfig, d_budget: int) -> Tuple[int, int, int]:
    """(k, k_M, r) for ``d_budget`` real coordinates, with the Remark-1
    policy specialisations applied (top-k: k_M = k; round robin: k_M = 0)."""
    k = cfg.k if cfg.k is not None else max(2, round(cfg.rho * d_budget))
    k_m = cfg.k_m if cfg.k_m is not None else int(round(cfg.k_m_frac * k))
    if cfg.policy == "topk":
        k_m = k
    if cfg.policy == "roundrobin":
        k_m = 0
    r = cfg.r if cfg.r is not None else max(k, round(cfg.r_frac * k))
    return k, k_m, r


class SelectionEngine:
    """``select_and_merge`` on the exact backend, and on the packed backend
    with fused statistics and warm-start thresholds.  ``layout`` (packed
    only) is a ``packing.PackedLayout``; the budgets count its ``d_valid``
    real coordinates."""

    def __init__(self, cfg: EngineConfig, d: int,
                 layout: Optional[packing.PackedLayout] = None):
        if cfg.backend not in BACKENDS:
            raise ValueError(f"unknown backend {cfg.backend!r}; choose from "
                             f"{BACKENDS}")
        if cfg.policy not in POLICIES:
            raise ValueError(f"unknown policy {cfg.policy!r}; choose from "
                             f"{POLICIES}")
        if cfg.backend != "exact" and cfg.policy not in THRESHOLD_POLICIES:
            raise ValueError(
                f"policy {cfg.policy!r} needs index arithmetic — only "
                f"{THRESHOLD_POLICIES} run on the {cfg.backend!r} backend")
        if cfg.backend not in ("exact", "packed"):
            item = {"threshold": 3}.get(cfg.backend, 11)
            raise NotImplementedError(
                f"backend {cfg.backend!r} is "
                + _NOT_PORTED.format(item=item))
        if cfg.reduce_axes:
            raise NotImplementedError(
                "reduce_axes (the sharded launch path) is "
                + _NOT_PORTED.format(item=11))
        self.cfg = cfg
        self.d = d
        self.layout = layout
        self.d_budget = d
        if cfg.backend == "exact":
            return
        if not (cfg.fused_stats and cfg.warm_start) or cfg.exact_theta:
            raise NotImplementedError(
                "the packed backend runs with fused_stats=True, "
                "warm_start=True and exact_theta=False here; the "
                "sampled-quantile and order-statistic thresholds are "
                + _NOT_PORTED.format(item=3))
        if layout is None:
            raise ValueError("packed backend needs a PackedLayout")
        if d != layout.d_packed:
            raise ValueError(f"d={d} != layout.d_packed={layout.d_packed}")
        self.d_budget = layout.d_valid

    # -- budgets ------------------------------------------------------------

    def budgets(self) -> Tuple[int, int, int]:
        """(k, k_M, r) with the Remark-1 policy specialisations applied."""
        return budgets_for(self.cfg, self.d_budget)

    def _rho_parts(self) -> Tuple[float, float]:
        k, k_m, _ = self.budgets()
        return k / self.d_budget, (k_m / k if k else 0.0)

    def _km_traced(self, k_m_frac) -> Tensor:
        """Traced magnitude budget: ``k`` stays static, ``k_M`` is data."""
        return traced_km(self.budgets()[0], k_m_frac)

    def select_traced(self, g: Tensor, age: Tensor, k_m_frac) -> Tensor:
        """FAIR-k with a traced split, as indices of static size k
        (ascending): the rank-form mask of ``(|g|, age)``, then
        ``mask_to_indices`` — the exact trainer's adaptive selection."""
        k = self.budgets()[0]
        mask, _ = fair_k_masks_dynamic(g.to(torch.float32).abs(), age, k,
                                       self._km_traced(k_m_frac))
        return mask_to_indices(mask, k)

    # -- selection ----------------------------------------------------------

    def select(self, g: Tensor, age: Tensor, u: Optional[Tensor] = None
               ) -> Tensor:
        """Exact index-form selection (all six policies): (k,) int64.
        ``u``: the uniform (d,) draw of ``toprand`` / ``randk``."""
        k, k_m, r = self.budgets()
        return selection.select_indices(self.cfg.policy, u, g, age, k=k,
                                        k_m=k_m, r=r)

    # -- server phase --------------------------------------------------------

    def select_and_merge(self, g: Tensor, g_prev: Tensor, age: Tensor, *,
                         noise: Optional[Tensor] = None,
                         u: Optional[Tensor] = None,
                         tstate: Optional[Dict[str, Tensor]] = None,
                         residual: Optional[Tensor] = None,
                         fresh: Optional[Tensor] = None,
                         k_m_frac=None, age_lag: Optional[int] = None,
                         erase: Optional[Tensor] = None,
                         sanitize: bool = False
                         ) -> Tuple[Tensor, Tensor, Dict[str, Any]]:
        """One server phase: select on ``g``, merge fresh values over stale
        ``g_prev`` (Eq. 8), advance the age (Eq. 10).  Returns f32
        ``(g_t, age', stats)``; ``stats["tstate"]`` is the successor
        threshold state.

        ``noise``: the standard-normal (d,) draw of the channel noise
        (JAX draws it from the round's key inside the engine); with
        ``noise_std`` > 0 the selected coordinates get
        ``noise_std / n_clients · noise``.  ``u``: the uniform (d,) draw
        of the random policies on the exact backend (JAX draws it from
        the selection half of the same key).  ``residual``: the
        error-feedback accumulator, successor in ``stats["residual"]``.
        ``fresh``: transmitted values when they differ from the score
        (the one-bit majority-vote signs).  ``sanitize`` keeps non-finite
        scores out of both stages; ``erase`` (> 0) demotes coordinates to
        NaN first, and needs ``sanitize``.  ``tstate`` (packed only) is
        the carried threshold state.  The exact backend's stats carry the
        index vector ``idx`` (without ``sanitize``), and with
        ``fused_stats`` the counts and histograms of the packed kernel."""
        if k_m_frac is not None and self.cfg.policy != "fairk":
            raise ValueError(
                f"traced k_m_frac adapts the FAIR-k split only — policy "
                f"{self.cfg.policy!r} pins or ignores it")
        if age_lag:
            raise NotImplementedError("age_lag (async rounds) is "
                                      + _NOT_PORTED.format(item=7))
        if tuple(g.shape) != (self.d,):
            raise ValueError(f"expected shape ({self.d},), got "
                             f"{tuple(g.shape)}")
        if self.cfg.noise_std > 0.0 and noise is None:
            raise ValueError("noise_std > 0 needs a noise draw (identical "
                             "noise every round is not a channel)")
        if erase is not None and not sanitize:
            raise ValueError("erase needs sanitize=True — erased "
                             "coordinates degrade through the NaN path")
        if sanitize and self.cfg.policy not in THRESHOLD_POLICIES:
            raise ValueError(
                f"sanitize runs selection in threshold/rank form — policy "
                f"{self.cfg.policy!r} needs index arithmetic; choose from "
                f"{THRESHOLD_POLICIES}")
        if erase is not None:
            g = torch.where(erase > 0.0,
                            torch.full_like(g, float("nan"),
                                            dtype=torch.float32),
                            g.to(torch.float32))
        if self.cfg.backend == "exact":
            return self._exact_update(g, g_prev, age, noise, u, residual,
                                      fresh, sanitize, k_m_frac)
        if tstate is None:
            raise NotImplementedError(
                "the packed round without a carried tstate needs the "
                "sampled-quantile bootstrap, which is "
                + _NOT_PORTED.format(item=3))
        return self._packed_update(g, g_prev, age, noise, tstate, residual,
                                   fresh, sanitize, k_m_frac)

    def _noisy(self, fresh: Tensor, noise: Optional[Tensor]) -> Tensor:
        cfg = self.cfg
        if noise is None or cfg.noise_std <= 0.0:
            return fresh.to(torch.float32)
        return (fresh.to(torch.float32)
                + (cfg.noise_std / cfg.n_clients) * noise)

    def _exact_update(self, g, g_prev, age, noise, u, residual=None,
                      fresh=None, sanitize=False, k_m_frac=None):
        """Index-form selection on the score (rank form for a traced
        split), then one ``aou_merge`` launch: the merge, age step and
        residual for the selected indices (or, under ``sanitize``, the
        mask-form merge for the rank-form mask)."""
        cfg = self.cfg
        k, k_m, _ = self.budgets()
        score = eff_score(g, residual)
        fin = mask_m_s = None
        if k_m_frac is not None:
            k_m = self._km_traced(k_m_frac)
        if not sanitize:
            idx = (self.select(score, age, u) if k_m_frac is None
                   else self.select_traced(score, age, k_m_frac))
            sent = score if fresh is None else fresh.to(torch.float32)
            noisy = noise is not None and cfg.noise_std > 0.0
            g_t, age_next, res_next = ops.masked_merge_by_indices(
                idx, sent, g_prev, age, noise=noise if noisy else None,
                noise_scale=cfg.noise_std / cfg.n_clients,
                score=score if residual is not None else None,
                mode=cfg.kernel_mode)
            stats = {"idx": idx, "k": k,
                     "n_selected": torch.full((), float(k),
                                              device=g.device)}
        else:
            # rank form on demoted statistics: non-finite coordinates rank
            # below every healthy one in both stages, and the final AND
            # keeps them out even when k exceeds the healthy count
            fin = torch.isfinite(score)
            score = torch.where(fin, score, 0.0)
            mag_eff = torch.where(fin, score.abs(), -1.0)
            age_eff = torch.where(fin, age.to(torch.float32), -1.0)
            mask, mask_m_s = fair_k_masks_dynamic(mag_eff, age_eff, k, k_m)
            finf = fin.to(torch.float32)
            mask = mask * finf
            mask_m_s = mask_m_s * finf
            stats = {"n_selected": mask.sum(), "k": k}
            sent = score
            if fresh is not None:
                sent = fresh.to(torch.float32)
                sent = torch.where(torch.isfinite(sent), sent, 0.0)
            g_t, age_next = masked_merge(self._noisy(sent, noise), g_prev,
                                         age, mask, mode=cfg.kernel_mode)
            if residual is not None:
                # noise-free accounting; sanitized-out coordinates keep
                # their old residual
                res_next = torch.where(fin, score - mask * sent,
                                       residual.to(torch.float32))
        if cfg.fused_stats:
            valid = age.to(torch.float32) >= 0.0
            if fin is not None:
                valid = valid & fin
            mag_hist, age_hist = ref.strided_hists_ref(
                score, age_next, valid, packing.hist_stride(self.d))
            if mask_m_s is not None:
                n_sel_m = mask_m_s.sum()
            elif k_m_frac is not None:
                n_sel_m = k_m.to(torch.float32)
            else:
                n_sel_m = torch.full((), float(k_m), device=g.device)
            stats.update(n_sel_m=n_sel_m, mag_hist=mag_hist,
                         age_hist=age_hist)
        if k_m_frac is not None:
            stats["k_m"] = k_m
        if residual is not None:
            stats["residual"] = res_next
        return g_t, age_next, stats

    def _stats_thresholds(self, tstate, k_m_frac=None
                          ) -> Tuple[Tensor, Tensor, Tensor]:
        """(θ_M, θ_A, streak') from the carried statistics alone: the
        warm-corrected thresholds once the streak is established, else the
        histogram estimates (zero reads of the gradient buffer).  A traced
        ``k_m_frac`` replaces the static split in both."""
        cfg = self.cfg
        k, k_m, _ = self.budgets()
        rho, km_frac = self._rho_parts()
        if k_m_frac is not None:
            k_m = self._km_traced(k_m_frac)
            km_frac = km_frac_of(k_m, k)
        hist_tm, hist_ta = packing.hist_thresholds(
            tstate["mag_hist"], tstate["age_hist"], rho=rho,
            k_m_frac=km_frac)
        pred_tm, pred_ta = packing.warm_corrected_thresholds(
            tstate, k=k, k_m=k_m, alpha=cfg.warm_alpha, clip=cfg.warm_clip)
        on_track = self._on_track(tstate, k)
        use_warm = on_track & (tstate["streak"] >= cfg.warm_streak)
        tm = torch.where(use_warm, pred_tm, hist_tm)
        ta = torch.where(use_warm, pred_ta, hist_ta)
        streak = self._streak_update(tstate, on_track, tm, ta, pred_tm,
                                     pred_ta)
        return tm, ta, streak

    def _on_track(self, tstate, k) -> Tensor:
        """Trust gate 1: last round's count stayed inside the budget
        tolerance."""
        return ((tstate["init"] > 0.0)
                & ((tstate["n_sel"] - k).abs() <= self.cfg.warm_tol * k))

    def _streak_update(self, tstate, on_track, tm, ta, pred_tm, pred_ta
                       ) -> Tensor:
        """Trust gate 2: the warm predictor must keep agreeing with the
        measured thresholds."""
        def both(a, b):
            return torch.isinf(a) & torch.isinf(b)
        ratio_tol = 1.0 + self.cfg.warm_tol
        pred_ok = (
            (both(ta, pred_ta) | ((ta - pred_ta).abs() <= 0.75))
            & (both(tm, pred_tm)
               | ((pred_tm <= tm * ratio_tol) & (pred_tm * ratio_tol >= tm))))
        return torch.where(on_track & pred_ok, tstate["streak"] + 1.0,
                           torch.zeros_like(tstate["streak"]))

    def _packed_update(self, g, g_prev, age, noise, tstate, residual=None,
                       fresh=None, sanitize=False, k_m_frac=None):
        """One fused FAIR-k pass over the whole packed buffer: the round's
        only read of (g, residual)."""
        cfg = self.cfg
        k, _, _ = self.budgets()
        # the fused-stats warm branch of the reference's _packed_thresholds
        theta_m, theta_a, streak = self._stats_thresholds(tstate, k_m_frac)
        g_t, age_next, res_next, kstats = ops.fairk_stats_update(
            g, g_prev, age, theta_m, theta_a, residual=residual,
            fresh=fresh, mode=cfg.kernel_mode, sanitize=sanitize)
        n_sel, n_sel_m = kstats["n_sel"], kstats["n_sel_m"]
        mag_hist, age_hist = kstats["mag_hist"], kstats["age_hist"]
        if sanitize:
            # a fully erased round emits empty histograms; substitute the
            # truth (nothing refreshed: ages advance one bin, magnitudes
            # unobserved) so the next round does not read them as the
            # cold-start full-refresh signal
            keep = (age_hist.sum() <= 0.0) & (tstate["init"] > 0.0)
            mag_hist = torch.where(keep, tstate["mag_hist"], mag_hist)
            age_hist = torch.where(
                keep, packing.advance_age_hist(tstate["age_hist"]), age_hist)
        if cfg.noise_std > 0.0:
            sel = (age_next == 0.0).to(torch.float32)
            g_t = g_t + sel * (cfg.noise_std / cfg.n_clients) * noise
        one = torch.ones((), dtype=torch.float32, device=g.device)
        tstate_next = {"theta_m": theta_m, "theta_a": theta_a,
                       "n_sel_m": n_sel_m, "n_sel": n_sel, "init": one,
                       "streak": streak, "mag_hist": mag_hist,
                       "age_hist": age_hist}
        stats = {"theta_m": theta_m, "theta_a": theta_a,
                 "n_selected": n_sel, "k": k, "tstate": tstate_next,
                 "n_sel_m": n_sel_m, "mag_hist": mag_hist,
                 "age_hist": age_hist}
        if res_next is not None:
            stats["residual"] = res_next
        return g_t, age_next, stats
