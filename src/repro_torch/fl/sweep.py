"""Batched sweep driver: many (policy × k_M/k × seed) OAC-FL simulations
advanced together, one (lanes, d) program per round (the port of
``repro.fl.sweep``).

Every grid point ("lane") is one simulated OAC-FL server: quadratic
heterogeneous clients ``f_n(w) = ½‖w − w*_n‖²`` with closed-form local SGD,
Rayleigh fading and channel noise.  All lanes run as one batch: FAIR-k in
rank form (``engine.fair_k_mask_dynamic`` on the rows) takes each lane's
magnitude budget ``k_M`` as data, and the policy id switches the magnitude
score between ``|g_prev|`` (the FAIR-k family: fairk, topk at k_M = k,
roundrobin at k_M = 0) and a uniform draw (randk).  ``fairk_auto`` lanes
carry a ``BudgetController`` state each and re-derive their ``k_M`` every
round from their own staleness histogram; static lanes carry theirs
through untouched.

Each round's Eq. 8 merge and Eq. 10 age step over all lanes is ONE
mask-form ``aou_merge`` launch on the flattened (lanes·d) block; with
``async_lag`` the selected ages then shift to the lag
(``packing.shift_selected_age``) and the controller's age target moves
with it.

Randomness: the lanes' draws — the client optima ``w_stars`` (lanes, N, d)
and, per round, the Rayleigh fading ``h`` (N,), the standard-normal noise
``z`` (d,) and the uniform ``u`` (d,) of the randk lanes — are given as
tensors (``draws``), or come from one ``torch.Generator`` per seed (lanes
with the same seed share their draws, as the reference's lanes share their
key).

Scenario lanes (``faults``, ``population``, ``wireless``, shared by every
lane): iid dropout (a fresh Gilbert–Elliott draw each round, no carried
chain), a virtual population per lane carried through the rounds, or a
per-lane AR(1) fading chain with truncated inversion.  The gates thin the
superposition, which rescales by the realised participation; corruption,
churn and fade blocks and a round with no participant knock their
coordinates out of the rank-form mask before the round's one
``aou_merge`` launch (stale value kept, age climbing).  Population lanes
replace the iid dropout draw.  Their draws are given per lane and round
as well: ``av``, ``fd``, ``nz``, ``pop`` and ``participants``, ``er``,
``fad``, ``csi``, and the initial ``pop0`` and ``fad0``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import channel as chan
from repro_torch.core import controller as budget
from repro_torch.core import faults as fault_mod
from repro_torch.core import oac, packing
from repro_torch.core import population as pop_mod
from repro_torch.core.engine import (fair_k_mask_dynamic, km_frac_of,
                                     traced_km)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops, ref

Tensor = torch.Tensor

POLICY_FAIRK = 0
POLICY_RANDK = 1
SWEEP_POLICIES = {"fairk": POLICY_FAIRK, "topk": POLICY_FAIRK,
                  "roundrobin": POLICY_FAIRK, "randk": POLICY_RANDK,
                  "fairk_auto": POLICY_FAIRK}

@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """One synthetic OAC-FL scenario shared by every lane (field names,
    defaults and checks of ``repro.fl.sweep.SweepConfig``)."""
    d: int = 1024
    n_clients: int = 16
    rho: float = 0.2
    rounds: int = 100
    local_steps: int = 2
    local_lr: float = 0.1
    global_lr: float = 0.05
    shared: float = 3.0
    hetero: float = 1.0
    fading_mean: float = 1.0
    noise_std: float = 0.5
    error_feedback: bool = False
    async_lag: int = 0
    controller: budget.ControllerConfig = budget.ControllerConfig()
    faults: fault_mod.FaultConfig = fault_mod.FaultConfig()
    population: Optional[pop_mod.PopulationConfig] = None
    wireless: Optional[chan.ChannelConfig] = None
    client_chunk: Optional[int] = None

    def __post_init__(self):
        if self.client_chunk is not None:
            if (self.client_chunk < 1
                    or self.n_clients % self.client_chunk):
                raise ValueError(
                    f"client_chunk={self.client_chunk} must be in "
                    f"[1, n_clients] and divide "
                    f"n_clients={self.n_clients}")
        if self.wireless is not None:
            if self.wireless.n_clients != self.n_clients:
                raise ValueError(
                    "the wireless deployment covers the sweep's compute "
                    f"clients: wireless.n_clients="
                    f"{self.wireless.n_clients} must equal "
                    f"n_clients={self.n_clients}")
        if self.population is not None:
            if self.population.participants != self.n_clients:
                raise ValueError(
                    "the sweep's compute clients ARE the sampled cohort: "
                    f"population.participants="
                    f"{self.population.participants} must equal "
                    f"n_clients={self.n_clients}")
            if self.faults.dropout > 0.0:
                raise ValueError(
                    "population availability and FaultConfig.dropout are "
                    "two availability processes gating the same "
                    "superposition — run one at a time")

    @property
    def k(self) -> int:
        return max(1, int(round(self.rho * self.d)))

    @property
    def scenario(self) -> bool:
        return (self.faults.enabled or self.population is not None
                or self.wireless is not None)


def sweep_grid(policies: Sequence[str], k_m_fracs: Sequence[float],
               n_seeds: int, cfg: SweepConfig
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                          list]:
    """Flatten (policy × k_m_frac × seed) into the lane arrays ``(seeds,
    policy_ids, k_ms, adaptives, labels)`` (int32 numpy).  topk / randk pin
    k_M = k and roundrobin k_M = 0 (Remark 1); ``fairk_auto`` lanes raise
    the adaptive flag, their k_M being the controller's initial split."""
    combos = []
    for pol in policies:
        if pol not in SWEEP_POLICIES:
            raise ValueError(f"sweep supports {sorted(SWEEP_POLICIES)}, "
                             f"got {pol!r}")
        if pol == "topk" or pol == "randk":
            fracs = (1.0,)
        elif pol == "roundrobin":
            fracs = (0.0,)
        else:
            fracs = tuple(k_m_fracs)
        for frac in fracs:
            if (pol, frac) not in combos:
                combos.append((pol, frac))
    seeds, pids, kms, adaptives, labels = [], [], [], [], []
    for pol, frac in combos:
        for s in range(n_seeds):
            seeds.append(s)
            pids.append(SWEEP_POLICIES[pol])
            kms.append(int(round(frac * cfg.k)))
            adaptives.append(1 if pol == "fairk_auto" else 0)
            labels.append((pol, frac, s))
    return (np.asarray(seeds, np.int32), np.asarray(pids, np.int32),
            np.asarray(kms, np.int32), np.asarray(adaptives, np.int32),
            labels)


ROUND_KEYS = ("h", "z", "u", "av", "fd", "nz", "pop", "participants", "er",
              "fad", "csi")


def draw_lanes(cfg: SweepConfig, seeds: np.ndarray, device
               ) -> Dict[str, Tensor]:
    """Every lane's draws from one ``torch.Generator`` per distinct seed:
    ``w_stars`` (lanes, N, d) = shared·N(0, 1)^d + hetero·N(0, 1)^{N×d};
    per round ``h`` (lanes, rounds, N) Rayleigh with mean ``fading_mean``,
    ``z`` (lanes, rounds, d) standard normal and ``u`` (lanes, rounds, d)
    uniform in [0, 1); then the scenario's: ``av`` (.., N) dropout
    uniforms (no population), ``fd`` (.., ⌈d/fade_block⌉) and ``nz``
    (.., d) fault uniforms, ``pop`` (.., n_virtual) uniforms and
    ``participants`` (.., N) int64 ids with the initial ``pop0`` (lanes,
    n_virtual), ``er`` (.., ⌈d/erase_block⌉) churn uniforms, ``fad`` (..,
    N, 2) and ``csi`` (.., N) normals with the initial ``fad0`` (lanes, N,
    2)."""
    uniq = sorted(set(int(s) for s in seeds))
    per_seed = {}
    r, n, d = cfg.rounds, cfg.n_clients, cfg.d
    fc, pc, wc = cfg.faults, cfg.population, cfg.wireless
    scale = cfg.fading_mean / math.sqrt(math.pi / 2.0)
    for s in uniq:
        gen = torch.Generator(device=device)
        gen.manual_seed(s)

        def normal(*shape):
            return torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=device)

        def uniform(*shape):
            return torch.rand(shape, generator=gen, dtype=torch.float32,
                              device=device)

        w_stars = cfg.shared * normal(d)[None, :] + cfg.hetero * normal(n, d)
        h = scale * torch.sqrt(-2.0 * torch.log1p(-uniform(r, n)))
        lane = {"w_stars": w_stars, "h": h, "z": normal(r, d),
                "u": uniform(r, d)}
        if fc.enabled and pc is None:
            lane["av"] = uniform(r, n)
        if fc.fade > 0.0:
            lane["fd"] = uniform(r, -(-d // fc.fade_block))
        if fc.nan_rate > 0.0:
            lane["nz"] = uniform(r, d)
        if pc is not None:
            lane["pop0"] = uniform(pc.n_clients)
            lane["pop"], lane["participants"] = pop_mod.draw_round(
                gen, pc, device, (r,))
            lane["er"] = uniform(r, -(-d // pc.erase_block))
        if wc is not None:
            lane["fad0"] = normal(n, 2)
            lane["fad"] = normal(r, n, 2)
            if wc.csi_err > 0.0:
                lane["csi"] = normal(r, n)
        per_seed[s] = lane
    lane_of = [per_seed[int(s)] for s in seeds]
    return {key: torch.stack([lane[key] for lane in lane_of])
            for key in lane_of[0]}


def _hist_lanes(g_t: Tensor, age_next: Tensor) -> Tensor:
    """Each lane's post-update age histogram over all coordinates
    (``ref.strided_hists_ref`` at stride 1), (lanes, 128)."""
    ones = torch.ones_like(age_next, dtype=torch.bool)
    return ref.strided_hists_ref(g_t, age_next, ones, 1)[1]


def _one_round(cfg: SweepConfig, ctrl: budget.BudgetController, carry,
               dr: Dict[str, Tensor], randk: Tensor, k_m0: Tensor,
               adapt: Optional[Tensor], kernel_mode: Optional[str] = None):
    """One OAC-FL round of every lane -> ``(carry', metrics)``.

    ``carry = (w, g_prev, age, res, cs, w_stars, pstate, chstate)``:
    (lanes, d) buffers, the (lanes,) controller state, the (lanes, N, d)
    client optima and the lanes' population and fading states (None
    without that scenario).  ``dr`` holds this round's draws, (lanes, ...)
    each: ``h`` (N), ``z`` (d), ``u`` (d; absent when no lane is randk)
    and the scenario's (see ``draw_lanes``); ``adapt`` marks the
    ``fairk_auto`` lanes (None: none is), whose k_M comes from their
    controller, the others keeping ``k_m0``."""
    w, g_prev, age, res, cs, w_stars, pstate, chstate = carry
    lanes, n, d, k = w.shape[0], cfg.n_clients, cfg.d, cfg.k
    fc, has_pop, has_wl = cfg.faults, cfg.population is not None, (
        cfg.wireless is not None)
    k_m = (torch.where(adapt, traced_km(k, cs["k_m_frac"]), k_m0)
           if adapt is not None else k_m0)
    # selection (Eq. 11) scored on the last reconstructed gradient
    u = dr.get("u")
    score = g_prev.abs() if u is None else torch.where(randk, u,
                                                       g_prev.abs())
    mask = fair_k_mask_dynamic(score, age, k, k_m.to(torch.int64)[:, None])
    # H closed-form local SGD steps on f_n(w) = ½‖w − w*_n‖² give the
    # accumulated gradient shrink·(w − w*_n) (Eq. 5), superposed through
    # the per-client weights chunk by chunk (Eq. 7)
    shrink = (1.0 - (1.0 - cfg.local_lr) ** cfg.local_steps) / cfg.local_lr
    chunk = cfg.client_chunk if cfg.client_chunk is not None else n

    def superpose(wv):
        acc = torch.zeros(lanes, d, dtype=torch.float32, device=w.device)
        for c0 in range(0, n, chunk):
            grads = shrink * (w[:, None, :] - w_stars[:, c0:c0 + chunk])
            acc = acc + torch.einsum("ln,lnd->ld", wv[:, c0:c0 + chunk],
                                     grads)
        return acc

    extra = {}
    n_t = None
    if has_wl:
        # truncated inversion: the survivor gate (times the CSI error)
        # replaces the iid fading; availability composes before it
        chstate, cps = chan.channel_round(chstate, dr["fad"], cfg.wireless)
        gate = cps["sent"]
        wv_scale = (chan.csi_weights(dr["csi"], cfg.wireless)
                    if "csi" in dr else torch.ones_like(gate))
        extra["n_sent"] = cps["n_sent"]
    else:
        gate, wv_scale = None, dr["h"]
    if has_pop:
        pstate, ps = pop_mod.population_round(
            pstate, dr["pop"], dr["participants"], cfg.population)
        part = ps["part"]
        extra["n_t"], extra["churn"] = ps["n_t"], ps["churn"]
    elif fc.enabled:
        part = fault_mod.init_avail_state(dr["av"], fc)
    else:
        part = None
    if part is not None:
        gate = part if gate is None else part * gate
    if gate is not None:
        n_t = gate.sum(-1)[:, None]
        agg = fault_mod.participation_scale(superpose(wv_scale * gate), n_t)
    else:
        agg = superpose(wv_scale) * oac.reciprocal(n)
    if cfg.scenario:
        # corruption, churn and fade blocks and a total outage knock their
        # coordinates out of the mask: unsent, stale value kept
        agg = fault_mod.corrupt(agg, dr.get("nz"), fc)
        erase = torch.zeros_like(agg)
        if has_pop:
            erase = torch.maximum(erase, pop_mod.churn_erase_mask(
                dr["er"], d, ps["churn"][:, None], cfg.population))
        if fc.fade > 0.0:
            erase = torch.maximum(erase, fault_mod.fade_mask(dr["fd"], d, fc))
        erase = fault_mod.erase_with_outage(erase, n_t)
        bad = (erase > 0.0) | ~torch.isfinite(agg)
        agg = torch.where(bad, 0.0, agg)
        mask = mask * (1.0 - bad.to(torch.float32))
    if cfg.error_feedback:
        # server-side EF: the unsent aggregate mass folds back pre-merge
        agg = agg + res
        res = (1.0 - mask) * agg
    noise = (cfg.noise_std / n) * dr["z"]
    # Eqs. 8 and 10 over every lane: one aou_merge launch
    g_flat, age_flat = ops.aou_merge(
        (agg + noise).reshape(-1), g_prev.reshape(-1), age.reshape(-1),
        mask.reshape(-1), mode=kernel_mode)
    g_t, age_next = g_flat.view(lanes, d), age_flat.view(lanes, d)
    if cfg.async_lag:
        # async lanes: the selected contributions land async_lag rounds
        # late
        age_next = packing.shift_selected_age(age_next, cfg.async_lag)
    w_next = w - cfg.global_lr * g_t                             # Eq. (9)
    if adapt is not None:
        # the controller step on the adaptive lanes; static lanes carry
        # their state through untouched
        cs_new = ctrl.update(cs, _hist_lanes(g_t, age_next))
        cs = {key: torch.where(
            adapt.view((lanes,) + (1,) * (new.dim() - 1)), new, cs[key])
            for key, new in cs_new.items()}
    metrics = {"loss": 0.5 * ((w_next[:, None, :] - w_stars) ** 2)
               .sum(-1).mean(-1),
               "mean_age": age_next.mean(-1),
               "max_age": age_next.max(-1).values,
               "frac_fresh": mask.mean(-1), "res_norm": res.abs().mean(-1),
               "km_frac": km_frac_of(k_m, k), **extra}
    return (w_next, g_t, age_next, res, cs, w_stars, pstate, chstate), metrics


def run_grid(cfg: SweepConfig, seeds, policy_ids, k_ms, adaptives,
             draws: Optional[Dict[str, Any]] = None,
             device: DeviceLike = None, kernel_mode: Optional[str] = None
             ) -> Dict[str, Tensor]:
    """Advance every lane ``cfg.rounds`` rounds -> per-lane, per-round
    metric tensors (lanes, rounds) on the device: ``loss``, ``mean_age``,
    ``max_age``, ``frac_fresh``, ``res_norm``, ``km_frac`` (and ``n_t``,
    ``churn`` with a population, ``n_sent`` with the wireless channel).
    ``draws``: ``draw_lanes``' dict (any array type), or None to draw it
    here."""
    dev = resolve_device(device)

    def lane(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    k_m0 = lane(k_ms, torch.int32)
    randk = (lane(policy_ids, torch.int32) == POLICY_RANDK)[:, None]
    adapt = (lane(adaptives, torch.int32) > 0
             if np.asarray(adaptives).any() else None)
    if draws is None:
        draws = draw_lanes(cfg, np.asarray(seeds), dev)
    draws = {key: torch.as_tensor(
        v if isinstance(v, Tensor) else np.asarray(v),
        dtype=torch.int64 if key == "participants" else torch.float32,
        device=dev) for key, v in draws.items()}
    # a randk lane's magnitude score is its uniform draw
    if not bool(randk.any()):
        draws.pop("u", None)
    zeros = torch.zeros(k_m0.shape[0], cfg.d, dtype=torch.float32,
                        device=dev)
    cs = budget.init_controller_state(km_frac_of(k_m0, cfg.k), dev)
    pstate = (pop_mod.init_population_state(draws["pop0"], cfg.population)
              if cfg.population is not None else None)
    chstate = (chan.init_channel_state(draws["fad0"], cfg.wireless)
               if cfg.wireless is not None else None)
    carry = (zeros, zeros, zeros, zeros, cs, draws["w_stars"], pstate,
             chstate)
    # faults, churn and truncation outage block refreshes independently:
    # the controller's thinning is their sum
    thin = min(0.99, (cfg.faults.thin if cfg.faults.enabled else 0.0)
               + (cfg.population.thin if cfg.population is not None
                  else 0.0)
               + (cfg.wireless.thin if cfg.wireless is not None else 0.0))
    ctrl = budget.BudgetController(cfg.controller, rho=cfg.rho,
                                   age_offset=float(cfg.async_lag),
                                   thin=thin)
    per_round = [key for key in ROUND_KEYS if key in draws]
    metrics = []
    for t in range(cfg.rounds):
        carry, m = _one_round(cfg, ctrl, carry,
                              {key: draws[key][:, t] for key in per_round},
                              randk, k_m0, adapt, kernel_mode)
        metrics.append(m)
    return {key: torch.stack([m[key] for m in metrics], dim=1)
            for key in metrics[0]}


def run_sweep(cfg: SweepConfig, policies: Sequence[str] = ("fairk",),
              k_m_fracs: Sequence[float] = (0.75,), n_seeds: int = 4,
              draws: Optional[Dict[str, Any]] = None,
              device: DeviceLike = None, kernel_mode: Optional[str] = None
              ) -> Dict[str, Any]:
    """Run the grid; returns per-lane, per-round numpy metric arrays of
    shape (lanes, rounds) plus the lane ``labels`` ``(policy, frac,
    seed)``.  ``draws`` as in ``draw_lanes`` (lane order of
    ``sweep_grid``), or None for the per-seed generators."""
    seeds, pids, kms, adaptives, labels = sweep_grid(policies, k_m_fracs,
                                                     n_seeds, cfg)
    metrics = run_grid(cfg, seeds, pids, kms, adaptives, draws=draws,
                       device=device, kernel_mode=kernel_mode)
    out = {name: v.cpu().numpy() for name, v in metrics.items()}
    out["labels"] = labels
    return out
