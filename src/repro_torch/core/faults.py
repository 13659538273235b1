"""Fault injection and graceful degradation (the port of
``repro.core.faults``): Gilbert–Elliott client dropout, deep-fade block
erasures, NaN/Inf corruption of the aggregate, the guarded 1/N_t rescale,
and the divergence watchdog with its rollback primitive ``tree_select``.

Every function is elementwise tensor arithmetic on the device: the
realised participation ``n_t``, the watchdog's ``trip`` and its cooldown
are 0-d tensors, never read back to the host, and the rollback chooses
with ``torch.where``.  Randomness comes in as tensors (``u`` uniforms in
[0, 1)), with any leading batch axes (the sweep's lanes).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import channel as channel_mod
from repro_torch.core.channel import f32
from repro_torch.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-round fault-channel rates (fields, defaults and checks of
    ``repro.core.faults.FaultConfig``); all zero is the off mode."""
    dropout: float = 0.0        # stationary per-client unavailability
    burst: Optional[float] = None  # mean bad-state dwell (None: iid)
    fade: float = 0.0           # per-block deep-fade erasure probability
    fade_block: int = 128       # coordinates per fade block
    nan_rate: float = 0.0       # per-coordinate non-finite corruption

    def __post_init__(self):
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")
        if not 0.0 <= self.fade < 1.0:
            raise ValueError(f"fade must be in [0, 1), got {self.fade}")
        if not 0.0 <= self.nan_rate < 1.0:
            raise ValueError(
                f"nan_rate must be in [0, 1), got {self.nan_rate}")
        if self.burst is not None and self.burst < 1.0:
            raise ValueError(f"burst must be >= 1 round, got {self.burst}")
        if self.burst is not None and self.dropout > 0.0:
            need = self.dropout / (1.0 - self.dropout)
            if self.burst < need:
                raise ValueError(
                    f"infeasible Gilbert-Elliott chain: dropout="
                    f"{self.dropout} needs burst >= dropout/(1-dropout) = "
                    f"{need:.3f}, got {self.burst} (the good->bad rate "
                    "would exceed 1 and the stationary dropout could not "
                    "be met)")
        if self.fade_block < 1:
            raise ValueError(f"fade_block must be >= 1, got {self.fade_block}")

    @property
    def enabled(self) -> bool:
        return (self.dropout > 0.0 or self.fade > 0.0
                or self.nan_rate > 0.0)

    @property
    def thin(self) -> float:
        """Per-round refresh-blocking probability for the thinned Lemma-1
        law and the controller setpoint: the post-aggregation channels."""
        return min(0.99, self.fade + self.nan_rate)


# -- client availability: Gilbert–Elliott chain ------------------------------

def ge_probs(cfg: FaultConfig) -> Tuple[float, float]:
    """(p_gb, p_bg): good->bad and bad->good transition probabilities."""
    if cfg.dropout <= 0.0:
        return 0.0, 1.0
    if cfg.burst is None:
        return cfg.dropout, 1.0 - cfg.dropout
    p_bg = 1.0 / cfg.burst
    p_gb = min(1.0, cfg.dropout / (1.0 - cfg.dropout) * p_bg)
    return p_gb, p_bg


def init_avail_state(u: Tensor, cfg: FaultConfig) -> Tensor:
    """Stationary availability (1.0 = available) from the uniforms ``u``
    (..., N); all ones when dropout is off."""
    if cfg.dropout <= 0.0:
        return torch.ones_like(u, dtype=torch.float32)
    return (u >= f32(cfg.dropout)).to(torch.float32)


def avail_step(avail: Tensor, u: Tensor, cfg: FaultConfig) -> Tensor:
    """One Gilbert–Elliott transition of the availability vector."""
    p_gb, p_bg = ge_probs(cfg)
    nxt = torch.where(avail > 0.5, u >= f32(p_gb), u < f32(p_bg))
    return nxt.to(torch.float32)


# -- per-round fault channels -------------------------------------------------

def participation_scale(total: Tensor, n_t: Tensor) -> Tensor:
    """The guarded rescale ``total / max(n_t, 1)``, zeros when ``n_t`` is 0.
    A true division, as the compiled reference computes it (its divisor is
    data, not a constant)."""
    n_t = torch.as_tensor(n_t, dtype=torch.float32, device=total.device)
    scaled = total / torch.clamp(n_t, min=1.0)
    return torch.where(n_t > 0.0, scaled, torch.zeros_like(scaled))


def fade_mask(u: Tensor, d: int, cfg: FaultConfig) -> Tensor:
    """(..., d) deep-fade erasure mask from the block uniforms ``u``
    (..., ⌈d/fade_block⌉) — ``channel.block_erase_mask``; zeros when fades
    are off."""
    if cfg.fade <= 0.0:
        return torch.zeros(u.shape[:-1] + (d,), dtype=torch.float32,
                           device=u.device)
    return channel_mod.block_erase_mask(u, d, f32(cfg.fade), cfg.fade_block)


def corrupt(g: Tensor, u: Tensor, cfg: FaultConfig) -> Tensor:
    """Each coordinate becomes NaN, +Inf or −Inf (half, a quarter, a
    quarter) where ``u < nan_rate``; ``g`` itself when corruption is off."""
    if cfg.nan_rate <= 0.0:
        return g
    r = cfg.nan_rate
    nan, inf = float("nan"), float("inf")
    garbage = torch.where(u < f32(0.5 * r), nan,
                          torch.where(u < f32(0.75 * r), inf, -inf))
    return torch.where(u < f32(r), garbage.to(g.dtype), g)


def erase_with_outage(erase: Tensor, n_t: Tensor) -> Tensor:
    """Erase every coordinate of a round with no participant (``n_t`` 0)."""
    n_t = torch.as_tensor(n_t, dtype=torch.float32, device=erase.device)
    return torch.maximum(erase, (n_t <= 0.0).to(torch.float32))


# -- rollback and the divergence watchdog ------------------------------------

def tree_select(pred: Tensor, on_true: Any, on_false: Any) -> Any:
    """``torch.where(pred, a, b)`` over matching nests of tuples, lists and
    dicts (None where both hold None): the rollback primitive, no host
    sync."""
    if on_true is None or on_false is None:
        if on_true is not None or on_false is not None:
            raise ValueError("tree_select: None on one side only")
        return None
    if isinstance(on_true, dict):
        return {k: tree_select(pred, on_true[k], on_false[k])
                for k in on_true}
    if isinstance(on_true, (tuple, list)):
        return type(on_true)(tree_select(pred, a, b)
                             for a, b in zip(on_true, on_false))
    return torch.where(pred, on_true, on_false.to(on_true.dtype))


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Divergence-watchdog settings (``repro.core.faults.WatchdogConfig``)."""
    spike: float = 2.0     # trip above spike x EMA
    ema: float = 0.9       # baseline EMA decay
    warmup: int = 5        # observations before the spike guard arms
    cooldown: int = 10     # rounds of tightened k_m after a trip
    tighten: float = 0.5   # k_m_frac multiplier during cooldown

    def __post_init__(self):
        if self.spike <= 1.0:
            raise ValueError(f"spike must be > 1, got {self.spike}")
        if not 0.0 < self.tighten <= 1.0:
            raise ValueError(f"tighten must be in (0, 1], got {self.tighten}")


WATCHDOG_FIELDS = ("ema_loss", "ema_norm", "obs", "cooldown", "trips")


def init_watchdog_state(device=None) -> Dict[str, Tensor]:
    device = resolve_device(device)
    return {f: torch.zeros((), dtype=torch.float32, device=device)
            for f in WATCHDOG_FIELDS}


def watchdog_step(cfg: WatchdogConfig, state: Dict[str, Tensor],
                  loss: Tensor, unorm: Tensor
                  ) -> Tuple[Dict[str, Tensor], Tensor, Tensor]:
    """One watchdog transition -> ``(state', trip, k_scale)``: a trip on a
    non-finite observation, or once ``warmup`` healthy observations seeded
    the EMAs, on one above ``spike`` x its EMA; tripped observations leave
    the EMAs and the warmup count alone.  ``k_scale`` is ``tighten`` while
    the cooldown runs, else 1."""
    loss = loss.to(torch.float32)
    unorm = unorm.to(torch.float32)
    finite = torch.isfinite(loss) & torch.isfinite(unorm)
    armed = state["obs"] >= float(cfg.warmup)
    spike = f32(cfg.spike)
    spiked = ((loss > spike * state["ema_loss"])
              | (unorm > spike * state["ema_norm"]))
    trip = ~finite | (armed & spiked)
    first = state["obs"] == 0.0
    a, b = f32(cfg.ema), f32(1.0 - cfg.ema)

    def upd(ema, x):
        # fma(ema, ema_t, round((1 − ema)·x)), as the compiled reference
        return torch.where(trip, ema, torch.where(
            first, x, channel_mod.fma32(a, ema, b * x)))

    cool = torch.where(trip, torch.full_like(loss, float(cfg.cooldown)),
                       torch.clamp(state["cooldown"] - 1.0, min=0.0))
    new = {"ema_loss": upd(state["ema_loss"], loss),
           "ema_norm": upd(state["ema_norm"], unorm),
           "obs": torch.where(trip, state["obs"], state["obs"] + 1.0),
           "cooldown": cool,
           "trips": state["trips"] + trip.to(torch.float32)}
    k_scale = torch.where(cool > 0.0, f32(cfg.tighten), 1.0).to(
        torch.float32)
    return new, trip, k_scale
