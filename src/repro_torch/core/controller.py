"""Adaptive budget controller: the age histogram drives k_M/k online (the
port of ``repro.core.controller``).

Each round the controller

    measures  the staleness quantile of the EMA'd post-update age
              histogram (the finite-sample π of Lemma 1),
    predicts  the stationary quantile Lemma 1 assigns to the current
              split (a static per-(ρ, k_M/k) table, interpolated over the
              live ``k_m_frac``),
    corrects  ``k_m_frac`` by a clipped, damped proportional step: staler
              than predicted -> budget to the age stage; fresher -> to the
              magnitude stage.

The state is a dict of float32 tensors that stays on the device; ``update``
is tensor arithmetic only (no ``.item()``, no host sync), so a round that
runs it waits on nothing.  Every function works on a state with leading
lane dimensions as well: the sweep grid carries one controller per lane as
(lanes,) scalars and (lanes, 128) histograms.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import markov, packing

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Adaptive-``k_m_frac`` control law (field names and defaults of
    ``repro.core.controller.ControllerConfig``).  The regulated quantity
    is the ``target_quantile`` of the staleness pmf; its setpoint is the
    Lemma-1 prediction for the current split (``target_age=None``) or a
    fixed age in rounds."""
    target_quantile: float = 0.9
    target_age: Optional[float] = None
    gain: float = 0.15
    max_step: float = 0.02
    damping: float = 0.5
    deadband: float = 0.1
    period: int = 5
    ema: float = 0.9
    min_frac: float = 0.05
    max_frac: float = 0.95
    k0_frac: float = 0.25
    chain_d: int = 128
    table_points: int = 7


CTRL_SCALAR_FIELDS = ("k_m_frac", "prev_step", "init", "tick")
CONTROLLER_STATE_SIZE = (len(CTRL_SCALAR_FIELDS)
                         + packing.STATS_AGE_BINS + packing.STATS_MAG_BINS)


def init_controller_state(k_m_frac=0.75, device=None) -> Dict[str, Tensor]:
    """``k_m_frac``: the live split; ``prev_step``: the damped step
    memory; ``init``: 1 once a histogram was observed; ``tick``: rounds
    since the last actuation; ``age_ema`` / ``mag_ema``: the EMA'd
    histograms (``mag_ema`` follows the kernel's |score| histogram only,
    and call sites without one leave it alone).  A ``k_m_frac`` tensor
    with lane dimensions gives one controller per lane."""
    kmf = torch.as_tensor(k_m_frac, dtype=torch.float32, device=device)
    lanes = tuple(kmf.shape)
    z = torch.zeros(lanes, dtype=torch.float32, device=kmf.device)
    return {"k_m_frac": kmf.clone(), "prev_step": z, "init": z.clone(),
            "tick": z.clone(),
            "age_ema": torch.zeros(lanes + (packing.STATS_AGE_BINS,),
                                   dtype=torch.float32, device=kmf.device),
            "mag_ema": torch.zeros(lanes + (packing.STATS_MAG_BINS,),
                                   dtype=torch.float32, device=kmf.device)}


def controller_state_to_vec(cs: Dict[str, Tensor]) -> Tensor:
    """(CONTROLLER_STATE_SIZE,) float32: the four scalars, then the age and
    magnitude EMAs."""
    scalars = torch.stack([torch.as_tensor(cs[f], dtype=torch.float32)
                           for f in CTRL_SCALAR_FIELDS])
    return torch.cat([scalars, cs["age_ema"], cs["mag_ema"]]).to(
        torch.float32)


def controller_state_from_vec(vec: Tensor) -> Dict[str, Tensor]:
    ns = len(CTRL_SCALAR_FIELDS)
    cs = {f: vec[i] for i, f in enumerate(CTRL_SCALAR_FIELDS)}
    cs["age_ema"] = vec[ns:ns + packing.STATS_AGE_BINS]
    cs["mag_ema"] = vec[ns + packing.STATS_AGE_BINS:CONTROLLER_STATE_SIZE]
    return cs


# --- staleness pmf / quantile from the age histogram ----------------------

def staleness_pmf(age_hist: Tensor) -> Tensor:
    """Empirical staleness pmf over the unit age bins (last axis)."""
    h = age_hist.to(torch.float32)
    return h / torch.clamp(h.sum(-1, keepdim=True), min=1.0)


def pmf_quantile(pmf: Tensor, q: float) -> Tensor:
    """Inverse cdf of a unit-bin pmf (last axis) at ``q``, linear inside the
    cut bin (the sub-unit convention of ``packing.hist_thresholds``)."""
    pmf = pmf.to(torch.float32)
    cdf = torch.cumsum(pmf, -1)
    b = torch.clamp((cdf < q).to(torch.float32).sum(-1), 0.0,
                    pmf.shape[-1] - 1).to(torch.int64)
    prev = torch.where(
        b > 0, cdf.gather(-1, torch.clamp(b - 1, min=0)[..., None])[..., 0],
        0.0)
    at_b = pmf.gather(-1, b[..., None])[..., 0]
    frac = torch.clamp((q - prev) / torch.clamp(at_b, min=1e-9), 0.0, 1.0)
    return b.to(torch.float32) + frac


# --- Lemma-1 target table (numpy, built once per (ρ, config)) ------------

@functools.lru_cache(maxsize=256)
def _lemma1_quantile(d: int, k: int, k_m: int, k0: int, q: float) -> float:
    """Stationary staleness quantile of the Sec. IV-B chain."""
    chain = markov.FairKChain(d=d, k=k, k_m=k_m, k0=k0)
    support, pmf = markov.aou_distribution(chain)
    cum = np.cumsum(pmf)
    idx = int((cum < q).sum())
    idx = min(idx, len(pmf) - 1)
    prev = float(cum[idx - 1]) if idx > 0 else 0.0
    frac = float(np.clip((q - prev) / max(float(pmf[idx]), 1e-12), 0.0, 1.0))
    return float(support[idx]) + frac


def lemma1_target_table(cfg: ControllerConfig, rho: float
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(fracs, target quantiles): Lemma 1 on a scaled-down chain at each
    ``k_m_frac`` grid point.  Staleness in rounds depends on the ratios
    (ρ, k_M/k, k_0/k_M), not on d, so a small chain prices the target for
    any model size; the chain needs ρ ≤ 0.5 and two magnitude slots per
    grid point, so its size grows as ~20/ρ, capped at 256."""
    d_c = int(min(256, max(cfg.chain_d, round(20.0 / max(rho, 1e-3)))))
    k_c = int(np.clip(round(rho * d_c), 3, d_c // 2))
    fracs = np.linspace(cfg.min_frac, cfg.max_frac, cfg.table_points)
    targets = []
    for f in fracs:
        k_m_c = int(np.clip(round(f * k_c), 2, k_c - 1))
        k0_c = int(np.clip(round(cfg.k0_frac * k_m_c), 1, k_m_c - 1))
        t = _lemma1_quantile(d_c, k_c, k_m_c, k0_c, cfg.target_quantile)
        targets.append(min(t, packing.STATS_AGE_BINS - 2.0))
    return fracs.astype(np.float32), np.asarray(targets, np.float32)


def interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``jnp.interp(x, xp, fp)`` written out (torch has no interp): the
    right-sided bracket, the slope ``(x − xp[i−1]) / dx · df`` from the left
    knot, a zero-width bracket at the left knot's value, and the end values
    outside the table."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[0] - 1)
    # take(), not [i]: indexing with a 0-d tensor reads it back to the host
    lo_f, lo_x = fp.take(i - 1), xp.take(i - 1)
    df = fp.take(i) - lo_f
    dx = xp.take(i) - lo_x
    delta = x - lo_x
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, lo_f,
                    lo_f + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _blend(a: float, old: Tensor, new: Tensor) -> Tensor:
    """``a·old + (1 − a)·new`` as the compiled reference computes it: XLA
    on the CPU contracts the first product into a fused multiply-add,
    ``fma(a, old, round((1 − a)·new))``, formed here in float64 and
    rounded once."""
    a32 = float(np.float32(a))
    c = (float(np.float32(1.0 - a)) * new.to(torch.float32)).to(
        torch.float64)
    return (a32 * old.to(torch.float64) + c).to(torch.float32)


class BudgetController:
    """Clipped proportional regulation of ``k_m_frac`` on the staleness
    quantile.  Built once per (ρ, config): the Lemma-1 target table is
    static; ``update`` is tensor arithmetic on ``(state, age_hist,
    mag_hist)``."""

    def __init__(self, cfg: ControllerConfig = ControllerConfig(), *,
                 rho: float, age_offset: float = 0.0, thin: float = 0.0):
        self.cfg = cfg
        self.rho = float(rho)
        # async rounds shift the whole stationary pmf right by the lag;
        # participation thinning shifts its mean by thin / (1 - thin)
        if not 0.0 <= thin < 1.0:
            raise ValueError(f"thin must be in [0, 1), got {thin}")
        self.age_offset = float(age_offset) + (thin / (1.0 - thin)
                                               if thin else 0.0)
        if cfg.target_age is None:
            self._table = lemma1_target_table(cfg, self.rho)
        else:
            self._table = None
        self._on = {}

    def _table_on(self, device) -> Tuple[Tensor, Tensor]:
        if device not in self._on:
            self._on[device] = tuple(torch.as_tensor(a, device=device)
                                     for a in self._table)
        return self._on[device]

    def target_for(self, k_m_frac: Tensor) -> Tensor:
        """Setpoint for the regulated quantile at the current split: the
        Lemma-1 table interpolated at ``k_m_frac``, or the fixed
        ``target_age``, plus ``age_offset``."""
        kmf = torch.as_tensor(k_m_frac, dtype=torch.float32)
        if self.cfg.target_age is not None:
            return torch.full_like(kmf, self.cfg.target_age
                                   + self.age_offset)
        fracs, targets = self._table_on(kmf.device)
        tgt = interp(kmf, fracs, targets)
        return tgt + self.age_offset if self.age_offset else tgt

    def update(self, state: Dict[str, Tensor], age_hist: Tensor,
               mag_hist: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """One controller step from this round's histograms: staler than
        the setpoint -> a negative step (more age budget), fresher -> a
        positive one; clipped at ``max_step``, EMA-damped, taken every
        ``period`` rounds outside the deadband.  The first observation only
        seeds the EMA (a round-0 full-refresh histogram must not slam the
        split to ``max_frac``)."""
        cfg = self.cfg
        seen = state["init"] > 0.0
        a_new = age_hist.to(torch.float32)
        age_ema = torch.where(seen[..., None],
                              _blend(cfg.ema, state["age_ema"], a_new),
                              a_new)
        if mag_hist is not None:
            m_new = mag_hist.to(torch.float32)
            mag_ema = torch.where(seen[..., None],
                                  _blend(cfg.ema, state["mag_ema"], m_new),
                                  m_new)
        else:
            mag_ema = state["mag_ema"]
        q_meas = pmf_quantile(staleness_pmf(age_ema), cfg.target_quantile)
        q_tgt = self.target_for(state["k_m_frac"])
        err = (q_meas - q_tgt) / torch.clamp(q_tgt, min=1.0)
        # deadband: inside the Sec. V-A plateau every split is free
        err = torch.sign(err) * torch.clamp(err.abs() - cfg.deadband,
                                            min=0.0)
        tick = state["tick"] + 1.0
        act = seen & (age_ema.sum(-1) > 0.0) & (tick >= cfg.period)
        raw = torch.clamp(-cfg.gain * err, -cfg.max_step, cfg.max_step)
        step = _blend(cfg.damping, state["prev_step"], raw)
        step = torch.where(act, step, 0.0)
        k_m_frac = torch.clamp(state["k_m_frac"] + step, cfg.min_frac,
                               cfg.max_frac)
        return {"k_m_frac": k_m_frac,
                "prev_step": torch.where(act, step, state["prev_step"]),
                "init": torch.ones_like(state["init"]),
                "tick": torch.where(act, 0.0, tick),
                "age_ema": age_ema, "mag_ema": mag_ema}
