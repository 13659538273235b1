"""The FAIR-k selection engine (``repro.core.engine``) on the exact,
threshold and packed backends.

``SelectionEngine.select_and_merge(g, g_prev, age)`` runs one server
phase: select on ``g``, merge the fresh values over the stale ``g_prev``
(Eq. 8) and advance the age (Eq. 10).

* ``exact``: index-form selection (``core.selection``, all six policies;
  rank form under ``sanitize`` and for a traced split), then one
  ``aou_merge`` kernel launch: for the selected indices the noise, merge,
  age step and residual (``ops.masked_merge_by_indices``); under
  ``sanitize`` the mask-form merge and age step (``masked_merge``).
* ``threshold``: (θ_M, θ_A) from sampled quantiles (``sampled_thresholds``,
  ``jnp.quantile``'s arithmetic written out) or, with ``exact_theta``,
  from order statistics; then ONE fused kernel pass (``fairk_update``)
  that selects (Eq. 11), merges, advances the age and folds the
  error-feedback residual — with ``fused_stats`` also the counts and
  histograms.
* ``packed``: the threshold route over a ``packing.PackedLayout`` buffer
  (budgets on its valid coordinates, the quantile sample on them only).
  With ``fused_stats`` and ``warm_start`` the thresholds come from the
  carried statistics alone; without ``fused_stats`` the legacy route
  bootstraps from the sampled quantiles, trusts the warm-corrected
  thresholds once their streak holds, and counts the magnitude stage in a
  second pass.  ``select_and_merge_tree`` packs a parameter tree, runs
  the pass and unpacks.

A traced split (``select_and_merge(k_m_frac=tensor)``, the adaptive
controller's live ``k_m_frac``) keeps ``k`` static and moves ``k_M =
traced_km(k, k_m_frac)`` as a 0-d device tensor; no backend reads it back
to the host.  ``age_lag`` (async rounds) records the delivery lag on the
selected coordinates.

* ``sharded``: the vector is sharded across every axis of a mesh
  (``launch.mesh``, collectives from ``core.collectives``;
  ``SelectionEngine(cfg, d, mesh=...)``, d divisible by
  the mesh's size).  Each rank passes its own shard — coordinates
  ``[my·n, (my+1)·n)`` with ``n = d / size`` and ``my`` its row-major mesh
  index — and gets its shards of ``g_t``, ``age'``, the residual and
  ``sel_mask`` back; the counts and histograms are summed across the mesh
  (``all_reduce`` on the device).  Thresholds come from the carried
  statistics (``fused_stats`` + ``warm_start`` with a ``tstate``), from the
  whole vector (``global_thresholds`` or ``exact_theta``: the shards are
  gathered first), or else from each shard's own sampled quantiles; the
  mask is ``threshold_mask`` with the jitter at global ids, the merge one
  mask-form ``aou_merge`` launch.
* ``reduce_axes`` (packed): the bootstrapped thresholds, the counts and
  the histograms are averaged over those mesh axes (``pmean``), so every
  shard of a sharded model carries one threshold state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import collectives, oac, packing, selection
from repro_torch.kernels import ops, ref

Tensor = torch.Tensor

BACKENDS = ("exact", "threshold", "sharded", "packed")
POLICIES = selection.POLICIES
# FAIR-k-family policies expressible as (θ_M, θ_A) thresholds
THRESHOLD_POLICIES = ("fairk", "topk", "roundrobin")
AGE_CAP = packing.AGE_CAP


def jitter_from_ids(ids: Tensor) -> Tensor:
    """Deterministic per-coordinate jitter in [0, 1): the Knuth hash of
    the coordinate index (bit-identical to the kernel's recomputation)."""
    return ref.knuth_jitter(ids)


def index_jitter(n: int, offset: int = 0, device=None) -> Tensor:
    """Jitter for coordinates [offset, offset + n)."""
    return jitter_from_ids(torch.arange(offset, offset + n, device=device))


def strided_sample(x: Tensor, cap: int) -> Tensor:
    """Every ``max(1, n // cap)``-th entry of ``x``."""
    return x[::max(1, x.shape[0] // cap)]


def quantile(x: Tensor, q) -> Tensor:
    """``jnp.quantile(x, q)`` (linear method) for a 1-D ``x`` and a float
    or 0-d float32 tensor ``q``, with the compiled reference's arithmetic:
    ``pos = float32(q)·(n − 1)`` in float32, ``lo``/``hi`` its floor and
    ceil, ``hw = pos − lo``, ``lw = 1 − hw``, and the result ``fma(hi_v,
    hw, round32(lo_v·lw))`` — XLA contracts the final add into an FMA;
    the FMA is emulated in float64 (the products of two float32 values
    are exact there) and rounded to float32.  Any NaN in ``x`` gives NaN.
    The positions of a float ``q`` are computed on the host, of a tensor
    ``q`` on its device (no host sync either way)."""
    n = x.shape[0]
    s = torch.sort(x.to(torch.float32)).values           # NaN sorts last
    if isinstance(q, Tensor):
        pos = q.to(torch.float32) * float(n - 1)
        lo, hi = torch.floor(pos), torch.ceil(pos)
        hw = pos - lo
        lw = 1.0 - hw
        lo_v = s.take(torch.clamp(lo, 0.0, n - 1).to(torch.int64))
        hi_v = s.take(torch.clamp(hi, 0.0, n - 1).to(torch.int64))
        lw, hw = lw.to(torch.float64), hw.to(torch.float64)
    else:
        pos = np.float32(q) * np.float32(n - 1)
        lo, hi = np.floor(pos), np.ceil(pos)
        hw = np.float32(pos - lo)
        lw = float(np.float32(1.0) - hw)
        hw = float(hw)
        lo_v = s[int(min(max(lo, 0.0), n - 1))]
        hi_v = s[int(min(max(hi, 0.0), n - 1))]
    low = (lo_v.to(torch.float64) * lw).to(torch.float32)
    out = (hi_v.to(torch.float64) * hw + low.to(torch.float64)).to(
        torch.float32)
    return torch.where(torch.isnan(s[-1]), s[-1], out)


def thresholds_from_samples(mag_s: Tensor, age_eff_s: Tensor, *, rho: float,
                            k_m_frac) -> Tuple[Tensor, Tensor]:
    """(θ_M, θ_A) quantiles from drawn samples of |g| and the jittered age:
    θ_M at 1 − ρ·k_m_frac of |g|, θ_A at 1 − ρ_A of the age with ρ_A =
    (ρ − ρ_M)/(1 − ρ_M), a degenerate stage θ = inf.  ``k_m_frac`` a float,
    or a 0-d float32 tensor (the traced split): then the degenerate stages
    are ``where``s on quantiles computed either way."""
    inf = torch.full((), float("inf"), device=mag_s.device)
    if not isinstance(k_m_frac, Tensor):
        rho_m = rho * k_m_frac
        rho_a = (rho - rho_m) / max(1.0 - rho_m, 1e-6)
        theta_m = quantile(mag_s, 1.0 - rho_m) if rho_m > 0.0 else inf
        theta_a = quantile(age_eff_s, 1.0 - rho_a) if rho_a > 0.0 else inf
        return theta_m, theta_a
    rho_m = rho * k_m_frac.to(torch.float32)
    rho_a = (rho - rho_m) / torch.clamp(1.0 - rho_m, min=1e-6)
    theta_m = torch.where(
        rho_m > 0.0, quantile(mag_s, torch.clamp(1.0 - rho_m, 0.0, 1.0)),
        inf)
    theta_a = torch.where(
        rho_a > 0.0, quantile(age_eff_s, torch.clamp(1.0 - rho_a, 0.0,
                                                       1.0)), inf)
    return theta_m, theta_a


def sampled_thresholds(g: Tensor, age: Tensor, *, rho: float, k_m_frac,
                       sample_cap: int, sample_ids: Optional[Tensor] = None,
                       residual: Optional[Tensor] = None,
                       sanitize: bool = False) -> Tuple[Tensor, Tensor]:
    """(θ_M, θ_A) from strided-sample quantiles (no global sort): one read
    pass over a sample of the gradient buffer (``packing.G_READS``).
    ``sample_ids`` (int64 positions, ``PackedLayout.sample_ids``) samples
    only those coordinates — the jitter hashes their buffer positions;
    ``residual`` adds sample-wise (θ_M on |g + residual|); ``sanitize``
    demotes non-finite samples to magnitude 0 and age −1."""
    packing.G_READS += 1
    if sample_ids is None:
        stride = max(1, g.shape[0] // sample_cap)
        ids = torch.arange(0, g.shape[0], stride, device=g.device)
        g_s = g[::stride].to(torch.float32)
        if residual is not None:
            g_s = g_s + residual[::stride].to(torch.float32)
        age_s = age[::stride].to(torch.float32)
    else:
        ids = sample_ids
        g_s = g.take(ids).to(torch.float32)
        if residual is not None:
            g_s = g_s + residual.take(ids).to(torch.float32)
        age_s = age.take(ids).to(torch.float32)
    age_s = age_s + jitter_from_ids(ids)
    if sanitize:
        fin = torch.isfinite(g_s)
        g_s = torch.where(fin, g_s, 0.0)
        age_s = torch.where(fin, age_s, -1.0)
    return thresholds_from_samples(g_s.abs(), age_s, rho=rho,
                                   k_m_frac=k_m_frac)


def _midpoint(vals: Tensor, i, edge) -> Tensor:
    return (vals[i] + vals[edge]) / 2.0


def exact_thresholds(g: Tensor, age: Tensor, *, k: int, k_m: int,
                     sanitize: bool = False) -> Tuple[Tensor, Tensor]:
    """Order-statistic (θ_M, θ_A) that reproduce exact FAIR-k on tie-free
    inputs: θ_M midway between the k_M-th and (k_M+1)-th largest |g|, θ_A
    between the k_A-th and (k_A+1)-th largest jittered age of the
    magnitude stage's complement.  ``sanitize`` ranks non-finite scores
    below every real coordinate in both stages.  O(d log d)."""
    packing.G_READS += 1
    d = g.shape[0]
    k_a = k - k_m
    g32 = g.to(torch.float32)
    mag = g32.abs()
    inf = torch.full((), float("inf"), device=g.device)
    fin = None
    if sanitize:
        fin = torch.isfinite(g32)
        mag = torch.where(fin, mag, -1.0)
    if k_m == 0:
        theta_m = inf
        mask_m = torch.zeros(d, dtype=torch.bool, device=g.device)
    else:
        vals = torch.topk(mag, min(k_m + 1, d)).values
        theta_m = _midpoint(vals, k_m - 1, -1 if k_m >= d else k_m)
        mask_m = mag >= theta_m
    if k_a == 0:
        return theta_m, inf
    age_eff = age.to(torch.float32) + index_jitter(d, device=g.device)
    rest = torch.where(mask_m, -float("inf"), age_eff)
    if fin is not None:
        rest = torch.where(fin, rest, -float("inf"))
    vals = torch.topk(rest, min(k_a + 1, d)).values
    return theta_m, _midpoint(vals, k_a - 1, -1 if k_a >= d else k_a)


def exact_thresholds_dynamic(g: Tensor, age: Tensor, *, k: int, k_m,
                             sanitize: bool = False) -> Tuple[Tensor, Tensor]:
    """``exact_thresholds`` with a traced magnitude budget ``k_m`` (an
    integer 0-d tensor, clipped to [0, k]): the same midpoints, gathered at
    a data-dependent rank from one top-(k+1) per stage."""
    packing.G_READS += 1
    d = g.shape[0]
    kk = min(k + 1, d)
    km = torch.clamp(torch.as_tensor(k_m, device=g.device).to(torch.int64),
                     0, k)
    g32 = g.to(torch.float32)
    mag = g32.abs()
    fin = None
    if sanitize:
        fin = torch.isfinite(g32)
        mag = torch.where(fin, mag, -1.0)
    vals = torch.topk(mag, kk).values
    hi = vals.take(torch.clamp(km - 1, min=0))
    edge = vals.take(torch.clamp(km, max=kk - 1))
    theta_m = torch.where(km == 0, float("inf"), (hi + edge) / 2.0)
    mask_m = mag >= theta_m
    k_a = k - km
    age_eff = age.to(torch.float32) + index_jitter(d, device=g.device)
    rest = torch.where(mask_m, -float("inf"), age_eff)
    if fin is not None:
        rest = torch.where(fin, rest, -float("inf"))
    avals = torch.topk(rest, kk).values
    ahi = avals.take(torch.clamp(k_a - 1, min=0))
    aedge = avals.take(torch.clamp(k_a, max=kk - 1))
    theta_a = torch.where(k_a == 0, float("inf"), (ahi + aedge) / 2.0)
    return theta_m.to(torch.float32), theta_a.to(torch.float32)


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


def threshold_mask(g: Tensor, age: Tensor, theta_m, theta_a,
                   index_offset: int = 0) -> Tuple[Tensor, Tensor]:
    """Dense float32 ``(mask, mask_m)`` of the two-stage threshold rule:
    ``|g| >= θ_M``, else ``age + jitter >= θ_A`` — the fused kernel's
    in-register mask.  On a shard, ``index_offset`` is the shard's global
    start, so the jitter is the unsharded selection's."""
    mask_m = g.to(torch.float32).abs() >= theta_m
    age_eff = age.to(torch.float32) + index_jitter(g.shape[0], index_offset,
                                                   device=g.device)
    mask_a = (age_eff >= theta_a) & ~mask_m
    return ((mask_m | mask_a).to(torch.float32),
            mask_m.to(torch.float32))


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
    """``select_and_merge`` on the exact, threshold, sharded and packed
    backends.  ``mesh`` (a ``DeviceMesh``: the sharded backend, and
    ``reduce_axes``) names the ranks; ``layout`` (packed only) is a
    ``packing.PackedLayout``, and the budgets count its ``d_valid`` real
    coordinates."""

    def __init__(self, cfg: EngineConfig, d: int, mesh=None,
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
        if cfg.backend == "sharded":
            if mesh is None:
                raise ValueError("sharded backend needs a mesh")
            n_dev = collectives.mesh_size(mesh)
            if d % n_dev:
                raise ValueError(f"d={d} not divisible by {n_dev} devices")
        if cfg.reduce_axes:
            # the reference binds the names inside its shard_map and fails
            # at trace time; here the mesh resolves them when built
            if mesh is None:
                raise ValueError(f"reduce_axes {cfg.reduce_axes} names mesh "
                                 "axes — pass the mesh")
            unknown = set(cfg.reduce_axes) - set(collectives.axis_names(mesh))
            if unknown:
                raise ValueError(f"reduce_axes {sorted(unknown)} are not "
                                 f"axes of the mesh "
                                 f"{collectives.axis_names(mesh)}")
        if cfg.backend == "packed":
            if layout is None:
                raise ValueError("packed backend needs a PackedLayout")
            if d != layout.d_packed:
                raise ValueError(f"d={d} != layout.d_packed="
                                 f"{layout.d_packed}")
        self.cfg = cfg
        self.d = d
        self.mesh = mesh
        self.layout = layout
        # the length of the vector one rank passes (its shard when sharded)
        self.n_local = (d // collectives.mesh_size(mesh)
                        if cfg.backend == "sharded" else d)
        # budgets target the real coordinates (pads are dead weight)
        self.d_budget = layout.d_valid if layout is not None else d
        self._ids: Dict[torch.device, Tensor] = {}

    def sample_ids(self, device) -> Optional[Tensor]:
        """The layout's valid-coordinate quantile sample as an index tensor
        on ``device``, built once per device (None without a layout)."""
        if self.layout is None:
            return None
        device = torch.device(device)
        if device not in self._ids:
            self._ids[device] = self.layout.sample_ids(self.cfg.sample_cap,
                                                       device)
        return self._ids[device]

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

    def thresholds(self, g: Tensor, age: Tensor,
                   residual: Optional[Tensor] = None, k_m_frac=None,
                   sanitize: bool = False) -> Tuple[Tensor, Tensor]:
        """(θ_M, θ_A) per config: order statistics with ``exact_theta``,
        else the strided-sample quantiles of the whole buffer.
        ``residual`` folds into the magnitude statistic, ``k_m_frac`` (a
        0-d tensor) overrides the static split, ``sanitize`` keeps
        non-finite scores out of both estimates."""
        k, k_m, _ = self.budgets()
        if k_m_frac is None:
            if self.cfg.exact_theta:
                return exact_thresholds(eff_score(g, residual), age, k=k,
                                        k_m=k_m, sanitize=sanitize)
            rho, km_frac = self._rho_parts()
            return sampled_thresholds(g, age, rho=rho, k_m_frac=km_frac,
                                      sample_cap=self.cfg.sample_cap,
                                      residual=residual, sanitize=sanitize)
        km = self._km_traced(k_m_frac)
        if self.cfg.exact_theta:
            return exact_thresholds_dynamic(eff_score(g, residual), age, k=k,
                                            k_m=km, sanitize=sanitize)
        rho, _ = self._rho_parts()
        return sampled_thresholds(g, age, rho=rho, k_m_frac=km_frac_of(km, k),
                                  sample_cap=self.cfg.sample_cap,
                                  residual=residual, sanitize=sanitize)

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
        ``(g_t, age', stats)``; on the packed backend (and the sharded one
        with ``fused_stats``) ``stats["tstate"]`` is the successor
        threshold state.  On the sharded backend every vector argument and
        result is this rank's shard.

        ``noise``: the standard-normal (d,) draw of the channel noise
        (JAX draws it from the round's key inside the engine); with
        ``noise_std`` > 0 the selected coordinates get
        ``noise_std / n_clients · noise``.  ``u``: the uniform (d,) draw
        of the random policies on the exact backend (JAX draws it from
        the selection half of the same key).  ``residual``: the
        error-feedback accumulator, successor in ``stats["residual"]``.
        ``fresh``: transmitted values when they differ from the score
        (the one-bit majority-vote signs; not on the sharded backend).
        ``sanitize`` keeps non-finite scores out of both stages; ``erase``
        (> 0) demotes coordinates to NaN first, and needs ``sanitize``.
        ``tstate`` (packed, and sharded with ``fused_stats`` and
        ``warm_start``) is the carried threshold state (None: bootstrap
        from the sampled quantiles).  ``age_lag`` (async rounds, an int >= 0): the selected
        coordinates' post-update age is ``age_lag`` instead of 0 and the
        age histogram shifts with it; counts and noise use the selection
        before the shift, returned as ``stats["sel_mask"]``.  The exact
        backend's stats carry the index vector ``idx`` (without
        ``sanitize``), and with ``fused_stats`` the counts and histograms
        of the kernel routes."""
        if age_lag is not None:
            if int(age_lag) < 0:
                raise ValueError(f"age_lag must be >= 0, got {age_lag}")
            age_lag = int(age_lag) or None        # 0 is synchronous
        if k_m_frac is not None and self.cfg.policy != "fairk":
            raise ValueError(
                f"traced k_m_frac adapts the FAIR-k split only — policy "
                f"{self.cfg.policy!r} pins or ignores it")
        if tuple(g.shape) != (self.n_local,):
            raise ValueError(f"expected shape ({self.n_local},), got "
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
                                      fresh, sanitize, k_m_frac, age_lag)
        if self.cfg.backend == "threshold":
            return self._threshold_update(g, g_prev, age, noise, residual,
                                          fresh, sanitize, k_m_frac, age_lag)
        if self.cfg.backend == "sharded":
            return self._sharded_update(g, g_prev, age, noise, tstate,
                                        residual, fresh, sanitize, k_m_frac,
                                        age_lag)
        return self._packed_update(g, g_prev, age, noise, tstate, residual,
                                   fresh, sanitize, k_m_frac, age_lag)

    def _noisy(self, fresh: Tensor, noise: Optional[Tensor]) -> Tensor:
        cfg = self.cfg
        if noise is None or cfg.noise_std <= 0.0:
            return fresh.to(torch.float32)
        return (fresh.to(torch.float32)
                + (cfg.noise_std / cfg.n_clients) * noise)

    def _add_noise(self, g_t: Tensor, age_next: Tensor,
                   noise: Optional[Tensor]) -> Tensor:
        """The channel noise on the coordinates the fused pass selected
        (``age' == 0``) — one masked pass after the kernel."""
        cfg = self.cfg
        if cfg.noise_std <= 0.0:
            return g_t
        sel = (age_next == 0.0).to(torch.float32)
        return g_t + sel * (cfg.noise_std / cfg.n_clients) * noise

    def _exact_update(self, g, g_prev, age, noise, u, residual=None,
                      fresh=None, sanitize=False, k_m_frac=None,
                      age_lag=None):
        """Index-form selection on the score (rank form for a traced
        split), then one ``aou_merge`` launch: the merge, age step and
        residual for the selected indices (or, under ``sanitize``, the
        mask-form merge for the rank-form mask)."""
        cfg = self.cfg
        k, k_m, _ = self.budgets()
        score = eff_score(g, residual)
        fin = mask_m_s = mask = None
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
        if age_lag is not None:
            # async: the selected coordinates carry their delivery lag;
            # the histograms below bin the shifted ages
            age_next = packing.shift_selected_age(age_next, age_lag)
            stats["sel_mask"] = (mask if mask is not None else
                                 selection.mask_from_indices(idx, self.d))
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

    def _threshold_update(self, g, g_prev, age, noise, residual=None,
                          fresh=None, sanitize=False, k_m_frac=None,
                          age_lag=None):
        """Thresholds from the sampled quantiles (or order statistics) of
        this round's buffer, then the fused server pass."""
        theta_m, theta_a = self.thresholds(g, age, residual=residual,
                                           k_m_frac=k_m_frac,
                                           sanitize=sanitize)
        return self._server_pass(g, g_prev, age, theta_m, theta_a, noise,
                                 residual=residual, fresh=fresh,
                                 sanitize=sanitize, age_lag=age_lag)

    def _server_pass(self, g, g_prev, age, theta_m, theta_a, noise, *,
                     residual, fresh, sanitize, age_lag, tstate=None,
                     count_m=False):
        """The server pass of the threshold and packed backends at given
        (θ_M, θ_A): one ``fairk_update`` launch, the counts, the channel
        noise on the selection and the async lag shift -> ``(g_t, age',
        stats)``.  With ``fused_stats`` the counts and histograms are the
        kernel's; without, ``n_selected`` counts the reset ages (pads keep
        the negative sentinel) and ``count_m`` adds the magnitude-stage
        count ``n_sel_m``, a second read of (g, residual).  Counts and
        noise use the selection before the lag shift, returned as
        ``stats["sel_mask"]``."""
        cfg = self.cfg
        if cfg.fused_stats:
            g_t, age_next, res_next, kstats = ops.fairk_stats_update(
                g, g_prev, age, theta_m, theta_a, residual=residual,
                fresh=fresh, mode=cfg.kernel_mode, sanitize=sanitize)
            n_sel = kstats["n_sel"]
            counts = {key: kstats[key]
                      for key in ("n_sel_m", "mag_hist", "age_hist")}
        else:
            g_t, age_next, res_next = ops.fairk_ef_update(
                g, g_prev, age, theta_m, theta_a, residual=residual,
                fresh=fresh, mode=cfg.kernel_mode, sanitize=sanitize)
            # selected coordinates are exactly the age-reset ones (Eq. 10)
            sel = (age_next == 0.0).to(torch.float32)
            n_sel = sel.sum()
            counts = {}
            if count_m:
                packing.G_READS += 1
                counts["n_sel_m"] = (
                    sel * (eff_score(g, residual).abs() >= theta_m)).sum()
        if cfg.reduce_axes and cfg.backend == "packed":
            # the per-shard mean keeps the counts comparable to the local
            # budgets and the carried state equal on every shard; the
            # counts are integers, so one collective for all is exact
            n_sel, *vals = self._all_reduce([n_sel, *counts.values()],
                                            cfg.reduce_axes, mean=True)
            counts = dict(zip(counts, vals))
        if cfg.fused_stats and sanitize and tstate is not None:
            # a fully erased round emits empty histograms; substitute the
            # truth (nothing refreshed: ages advance one bin, magnitudes
            # unobserved) so the next round does not read them as the
            # cold-start full-refresh signal
            keep = ((counts["age_hist"].sum() <= 0.0)
                    & (tstate["init"] > 0.0))
            counts["mag_hist"] = torch.where(keep, tstate["mag_hist"],
                                             counts["mag_hist"])
            counts["age_hist"] = torch.where(
                keep, packing.advance_age_hist(tstate["age_hist"]),
                counts["age_hist"])
        g_t = self._add_noise(g_t, age_next, noise)
        stats = {"theta_m": theta_m, "theta_a": theta_a,
                 "n_selected": n_sel, "k": self.budgets()[0], **counts}
        if age_lag is not None:
            # the carried buffer and histogram record the delivery lag
            stats["sel_mask"] = (age_next == 0.0).to(torch.float32)
            age_next = packing.shift_selected_age(age_next, age_lag)
            if "age_hist" in stats:
                stats["age_hist"] = packing.shift_age_hist(
                    stats["age_hist"], age_lag)
        if res_next is not None:
            stats["residual"] = res_next
        return g_t, age_next, stats

    # -- collectives ---------------------------------------------------------

    def _all_reduce(self, parts: List[Tensor], axes, mean: bool = False
                    ) -> List[Tensor]:
        """Each float32 tensor of ``parts`` summed (``mean``: averaged)
        over the mesh ``axes``, all in one collective (new tensors)."""
        flat = torch.cat([p.reshape(-1) for p in parts])
        flat = (collectives.pmean if mean else collectives.psum)(flat, self.mesh,
                                                           axes)
        return [f.reshape(p.shape) for f, p in zip(
            flat.split([p.numel() for p in parts]), parts)]

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

    def _packed_thresholds(self, g, age, tstate, residual=None,
                           k_m_frac=None, sanitize=False):
        """(θ_M, θ_A, streak') for a packed buffer: order statistics with
        ``exact_theta``; the carried statistics alone with ``fused_stats``
        and ``warm_start`` (``_stats_thresholds``); else the pad-excluding
        sampled quantiles, and — with ``warm_start`` and a carried state —
        the warm-corrected thresholds instead once the trust gates hold.

        The reference skips the quantile pass at run time on warm rounds
        (``lax.cond``).  Here both are computed and one is chosen with
        ``torch.where``: no host sync, and the pass is paid every round."""
        cfg = self.cfg
        k, k_m, _ = self.budgets()
        streak = torch.zeros((), dtype=torch.float32, device=g.device)
        if cfg.exact_theta:
            # pads (|g| = 0, age + jitter < 0) never enter either top-k
            if k_m_frac is not None:
                return (*exact_thresholds_dynamic(
                    eff_score(g, residual), age, k=k,
                    k_m=self._km_traced(k_m_frac), sanitize=sanitize),
                        streak)
            return (*exact_thresholds(eff_score(g, residual), age, k=k,
                                      k_m=k_m, sanitize=sanitize), streak)
        if cfg.fused_stats and cfg.warm_start and tstate is not None:
            return self._stats_thresholds(tstate, k_m_frac)
        rho, km_frac = self._rho_parts()
        if k_m_frac is not None:
            k_m = self._km_traced(k_m_frac)
            km_frac = km_frac_of(k_m, k)
        tm, ta = sampled_thresholds(
            g, age, rho=rho, k_m_frac=km_frac, sample_cap=cfg.sample_cap,
            sample_ids=self.sample_ids(g.device), residual=residual,
            sanitize=sanitize)
        if cfg.reduce_axes:
            # one (θ_M, θ_A) for every shard of the model
            tm, ta = self._all_reduce([tm, ta], cfg.reduce_axes, mean=True)
        if not (cfg.warm_start and tstate is not None):
            return tm, ta, streak
        pred_tm, pred_ta = packing.warm_corrected_thresholds(
            tstate, k=k, k_m=k_m, alpha=cfg.warm_alpha, clip=cfg.warm_clip)
        on_track = self._on_track(tstate, k)
        use_warm = on_track & (tstate["streak"] >= cfg.warm_streak)
        tm = torch.where(use_warm, pred_tm, tm)
        ta = torch.where(use_warm, pred_ta, ta)
        streak = self._streak_update(tstate, on_track, tm, ta, pred_tm,
                                     pred_ta)
        return tm, ta, streak

    def _packed_update(self, g, g_prev, age, noise, tstate, residual=None,
                       fresh=None, sanitize=False, k_m_frac=None,
                       age_lag=None):
        """One fused FAIR-k pass over the whole packed buffer, and the
        successor threshold state in ``stats["tstate"]``.  With
        ``fused_stats`` the pass is the round's only read of (g,
        residual): the kernel emits the counts and histograms.  Without,
        the legacy two-pass accounting, whose histograms are zeros."""
        cfg = self.cfg
        theta_m, theta_a, streak = self._packed_thresholds(
            g, age, tstate, residual, k_m_frac, sanitize)
        g_t, age_next, stats = self._server_pass(
            g, g_prev, age, theta_m, theta_a, noise, residual=residual,
            fresh=fresh, sanitize=sanitize, age_lag=age_lag, tstate=tstate,
            count_m=True)

        def carried(key, n):
            if cfg.fused_stats:
                return stats[key]
            return torch.zeros(n, dtype=torch.float32, device=g.device)
        stats["tstate"] = {
            "theta_m": theta_m, "theta_a": theta_a,
            "n_sel_m": (stats["n_sel_m"] if cfg.fused_stats
                        else stats.pop("n_sel_m")),
            "n_sel": stats["n_selected"],
            "init": torch.ones((), dtype=torch.float32, device=g.device),
            "streak": streak,
            "mag_hist": carried("mag_hist", packing.STATS_MAG_BINS),
            "age_hist": carried("age_hist", packing.STATS_AGE_BINS)}
        return g_t, age_next, stats

    def _sharded_update(self, g, g_prev, age, noise, tstate, residual=None,
                        fresh=None, sanitize=False, k_m_frac=None,
                        age_lag=None):
        """The sharded backend on this rank's shard: thresholds (carried,
        global or per shard), the global-id mask, one mask-form
        ``aou_merge`` launch, the residual, and the counts and histograms
        summed across the mesh.  ``noise`` is this shard's draw."""
        cfg = self.cfg
        if fresh is not None:
            raise ValueError("the sharded backend has no decoupled one-bit "
                             "fresh path — route one_bit through the "
                             "exact/threshold/packed backends")
        k, _, _ = self.budgets()
        rho, km_frac = self._rho_parts()
        dev = g.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        # warm rounds decide from the carried (replicated) statistics
        # alone, so every shard applies one (θ_M, θ_A)
        warm = cfg.fused_stats and cfg.warm_start and tstate is not None
        use_global = cfg.global_thresholds or cfg.exact_theta
        streak = zero
        if warm:
            theta_m, theta_a, streak = self._stats_thresholds(tstate,
                                                              k_m_frac)
        elif use_global:
            def whole(x):
                return (None if x is None
                        else collectives.all_gather_flat(x, self.mesh))
            theta_m, theta_a = self.thresholds(
                whole(g), whole(age), residual=whole(residual),
                k_m_frac=k_m_frac, sanitize=sanitize)
        score = eff_score(g, residual)
        fin = None
        if sanitize:
            # local degradation, no extra collective: the cleaned score
            # keeps 0 · NaN out of the merge, the finite AND keeps corrupt
            # coordinates unselected
            fin = torch.isfinite(score)
            score = torch.where(fin, score, 0.0)
        if warm or use_global:
            tm_l, ta_l = theta_m, theta_a
        else:
            # each shard's own sampled quantiles (jitter at local ids)
            kmf = (km_frac if k_m_frac is None
                   else km_frac_of(self._km_traced(k_m_frac), k))
            tm_l, ta_l = sampled_thresholds(score, age, rho=rho,
                                            k_m_frac=kmf,
                                            sample_cap=cfg.sample_cap)
        # the jitter hashes global ids: the unsharded backends' mask
        mask, mask_m = threshold_mask(
            score, age, tm_l, ta_l,
            index_offset=collectives.axis_index(self.mesh) * self.n_local)
        if fin is not None:
            finf = fin.to(torch.float32)
            mask = mask * finf
            mask_m = mask_m * finf
        g_t, age_next = masked_merge(self._noisy(score, noise), g_prev, age,
                                     mask, mode=cfg.kernel_mode)
        if age_lag is not None:
            # the shard's ages record the lag before the histograms bin
            # them, so the summed partials come out shifted
            age_next = packing.shift_selected_age(age_next, age_lag)
        parts = [mask.sum()]
        if cfg.fused_stats:
            stride = packing.hist_stride(self.d)
            # per-shard partials sum to the unsharded sample only when the
            # shard length is a stride multiple; else stride 1 (counts stay
            # exact, only the sample density changes)
            if self.n_local % stride:
                stride = 1
            valid = age >= 0.0
            if fin is not None:
                valid = valid & fin
            parts += [mask_m.sum(), *ref.strided_hists_ref(
                score, age_next, valid, stride)]
        parts = self._all_reduce(parts, collectives.axis_names(self.mesh))
        n_sel = parts[0]
        stats: Dict[str, Any] = {"n_selected": n_sel, "k": k}
        if age_lag is not None:
            stats["sel_mask"] = mask
        if warm or use_global:
            stats.update(theta_m=theta_m, theta_a=theta_a)
        if cfg.fused_stats:
            n_sel_m, mh, ah = parts[1:]
            stats.update(n_sel_m=n_sel_m, mag_hist=mh, age_hist=ah)
            # a per-shard bootstrap has no global θ to carry: zeros, the
            # reference's placeholders
            tm_c, ta_c = ((theta_m, theta_a) if (warm or use_global)
                          else (zero, zero))
            stats["tstate"] = {
                "theta_m": tm_c, "theta_a": ta_c, "n_sel_m": n_sel_m,
                "n_sel": n_sel,
                "init": torch.ones((), dtype=torch.float32, device=dev),
                "streak": streak, "mag_hist": mh, "age_hist": ah}
        if residual is not None:
            res_next = score - mask * score
            if fin is not None:
                # sanitized-out coordinates keep their old residual
                res_next = torch.where(fin, res_next,
                                       residual.to(torch.float32))
            stats["residual"] = res_next
        return g_t, age_next, stats

    def select_and_merge_tree(self, g_tree, g_prev_tree, age_tree, *,
                              noise: Optional[Tensor] = None,
                              tstate: Optional[Dict[str, Tensor]] = None,
                              residual: Optional[Tensor] = None,
                              k_m_frac=None, sanitize: bool = False):
        """Tree form of the packed backend: pack (g, g_prev, age), run the
        fused pass, unpack ``(g_t, age')`` as float32 trees -> ``(g_t_tree,
        age_tree', stats)``.  ``residual`` is a flat ``(d_packed,)``
        buffer (carried flat across rounds); its successor stays flat in
        ``stats["residual"]``."""
        lay = self.layout
        if lay is None:
            raise ValueError("select_and_merge_tree needs the packed "
                             "backend (construct with layout=...)")
        g = lay.pack(g_tree)
        gp = lay.pack(g_prev_tree)
        ag = lay.pack_age(age_tree)
        g_t, age_next, stats = self._packed_update(
            g, gp, ag, noise, tstate, residual, k_m_frac=k_m_frac,
            sanitize=sanitize)
        return (lay.unpack(g_t, cast=False), lay.unpack(age_next, cast=False),
                stats)


def make_engine(policy: str = "fairk", backend: str = "exact", *,
                d: Optional[int] = None, mesh=None,
                layout: Optional[packing.PackedLayout] = None,
                **cfg_kw) -> SelectionEngine:
    """Engine from a policy and backend name; ``d`` may be omitted when
    ``layout`` pins it (``layout.d_packed``)."""
    if d is None:
        if layout is None:
            raise ValueError("make_engine needs d (or a layout)")
        d = layout.d_packed
    return SelectionEngine(EngineConfig(policy=policy, backend=backend,
                                        **cfg_kw), d, mesh=mesh,
                           layout=layout)
