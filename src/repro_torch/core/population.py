"""Population-scale client simulator (the port of
``repro.core.population``): per-client availability chains for 10^5–10^6
virtual clients in one int8 cohort grid, the per-round participant
cohort, mid-round churn and its block erasures.

* The state ``avail`` is a (n_cohorts, cohort_size) int8 grid (1 up,
  0 down, ``PAD`` = −1 past ``n_clients``); ``t`` a 0-d int32 round
  counter driving the diurnal phase.  Each round draws one flat
  (n_clients,) uniform vector, padded with 2.0 and reshaped into the grid,
  so the trace does not depend on ``cohort_size``.
* Modes: ``iid``, ``ge`` (Gilbert–Elliott bursts) and ``diurnal`` (rate
  ``avail·(1 + depth·sin(2πt/period))``).
* ``population_round`` samples the round's participants (given as ids),
  advances every chain and reports ``part``, ``n_t``, ``churn``, ``slow``,
  ``slow_share``, ``n_avail`` and ``rate``; ``stateless_round`` is the
  launch path's memoryless round, whose draws for round r come from a
  generator seeded with ``(seed, r)``, so round t's ``next`` grid is round
  t+1's ``now`` grid; ``population_scan`` runs the rounds in a loop on the
  device.

Every function works on any leading batch axes (the sweep's lanes carry
one population each) and takes its draws as tensors.  No host sync:
``n_t``, ``churn`` and ``t`` stay on the device.

Arithmetic follows the compiled reference: the diurnal phase is
``t · float32(2π/period)`` (XLA folds the division by the constant
period), the rate ``avail · fma(depth, sin(phase), 1)``; the sine is
taken in float64 and rounded, and the reference's own sine differs from
that in the last place on a few phases (about 4 rates in 2,000 differ
by one ulp, which moves ``u < rate`` for one client in ~10^7).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.channel import f32
from repro_torch.device import resolve_device

Tensor = torch.Tensor

PAD = -1                               # cohort-grid pad sentinel (int8)
KNUTH = 2654435761


@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    """A virtual client population (fields, defaults and checks of
    ``repro.core.population.PopulationConfig``)."""
    n_clients: int = 100_000       # virtual population size
    cohort_size: int = 4096        # clients per cohort row
    participants: int = 8          # clients sampled per round (with
                                   # replacement)
    avail: float = 0.9             # stationary per-client availability
    mode: str = "iid"              # iid | ge | diurnal
    burst: float = 8.0             # mean down-state dwell (ge)
    period: int = 96               # diurnal cycle length in rounds
    depth: float = 0.1             # diurnal swing
    slow_frac: float = 0.0         # static straggler propensity
    exposure: float = 0.5          # share of a vanisher's blocks lost
    erase_block: int = 64          # coordinates per churn-erasure block

    def __post_init__(self):
        if self.n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {self.n_clients}")
        if self.cohort_size < 1:
            raise ValueError(
                f"cohort_size must be >= 1, got {self.cohort_size}")
        if not 1 <= self.participants <= self.n_clients:
            raise ValueError(
                f"participants must be in [1, n_clients={self.n_clients}], "
                f"got {self.participants}")
        if not 0.0 < self.avail <= 1.0:
            raise ValueError(f"avail must be in (0, 1], got {self.avail}")
        if self.mode not in ("iid", "ge", "diurnal"):
            raise ValueError(
                f"mode must be iid|ge|diurnal, got {self.mode!r}")
        if self.mode == "ge":
            if self.burst < 1.0:
                raise ValueError(
                    f"burst must be >= 1 round, got {self.burst}")
            need = (1.0 - self.avail) / self.avail
            if self.burst < need:
                raise ValueError(
                    f"infeasible Gilbert–Elliott chain: avail={self.avail} "
                    f"needs burst >= (1-avail)/avail = {need:.3f}, got "
                    f"{self.burst} (the up->down rate would exceed 1)")
        if self.mode == "diurnal":
            if self.period < 2:
                raise ValueError(
                    f"period must be >= 2 rounds, got {self.period}")
            if not 0.0 <= self.depth:
                raise ValueError(f"depth must be >= 0, got {self.depth}")
            if self.avail * (1.0 + self.depth) > 1.0 + 1e-9:
                raise ValueError(
                    f"diurnal peak avail*(1+depth) = "
                    f"{self.avail * (1.0 + self.depth):.3f} > 1 — the "
                    "clipped wave would shift the time-average off "
                    f"avail={self.avail}; lower depth")
        if not 0.0 <= self.slow_frac < 1.0:
            raise ValueError(
                f"slow_frac must be in [0, 1), got {self.slow_frac}")
        if not 0.0 < self.exposure <= 1.0:
            raise ValueError(
                f"exposure must be in (0, 1], got {self.exposure}")
        if self.erase_block < 1:
            raise ValueError(
                f"erase_block must be >= 1, got {self.erase_block}")

    @property
    def n_cohorts(self) -> int:
        return -(-self.n_clients // self.cohort_size)

    @property
    def n_padded(self) -> int:
        return self.n_cohorts * self.cohort_size

    @property
    def vanish_rate(self) -> float:
        """Stationary per-round P(up -> down) of one client's chain."""
        if self.mode == "ge":
            return (1.0 - self.avail) / (self.avail * self.burst)
        return 1.0 - self.avail

    @property
    def thin(self) -> float:
        """Per-round refresh-blocking probability: churn erasure plus the
        total outage of the sampled cohort."""
        outage = (1.0 - self.avail) ** self.participants
        return min(0.99, self.exposure * self.vanish_rate + outage)


# -- chain algebra -----------------------------------------------------------

def transition_probs(cfg: PopulationConfig) -> Tuple[float, float]:
    """Static (p_gb, p_bg) of the memory-bearing modes (iid: memoryless)."""
    if cfg.mode == "ge":
        p_bg = 1.0 / cfg.burst
        return (1.0 - cfg.avail) / cfg.avail * p_bg, p_bg
    return 1.0 - cfg.avail, cfg.avail


def availability_rate(cfg: PopulationConfig, t, device=None) -> Tensor:
    """The float32 availability rate a(t) (a tensor of ``t``'s shape):
    constant except in diurnal mode.  A tensor ``t`` keeps its device; a
    host ``t`` lands on ``resolve_device(device)``."""
    if not (isinstance(t, Tensor) and device is None):
        t = torch.as_tensor(t, device=resolve_device(device))
    if cfg.mode != "diurnal":
        return torch.full(t.shape, f32(cfg.avail), dtype=torch.float32,
                          device=t.device)
    phase = t.to(torch.float32) * f32(2.0 * np.pi / cfg.period)
    s = torch.sin(phase.to(torch.float64)).to(torch.float32)
    inner = (s.to(torch.float64) * f32(cfg.depth) + 1.0).to(torch.float32)
    return f32(cfg.avail) * inner


def client_jitter(ids: Tensor) -> Tensor:
    """Static per-client propensity in [0, 1): the uint32 Knuth hash
    ``ids · 2654435761`` (wrapping) times 2^-32, in int64 arithmetic on
    16-bit halves (no product leaves int64)."""
    a = ids.to(torch.int64) & 0xFFFFFFFF
    lo, hi = a & 0xFFFF, a >> 16
    h = (lo * KNUTH + (((hi * KNUTH) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return h.to(torch.float32) * 2.0 ** -32


def _flat_uniform(u: Tensor, cfg: PopulationConfig) -> Tensor:
    """(..., n_clients) uniforms -> the (..., n_cohorts, cohort_size) grid,
    pads 2.0 (``>= p`` for every probability)."""
    if u.shape[-1] != cfg.n_clients:
        raise ValueError(f"u must be (..., {cfg.n_clients}), got "
                         f"{tuple(u.shape)}")
    pad = cfg.n_padded - cfg.n_clients
    if pad:
        u = torch.cat([u, torch.full(u.shape[:-1] + (pad,), 2.0,
                                     dtype=u.dtype, device=u.device)], -1)
    return u.reshape(u.shape[:-1] + (cfg.n_cohorts, cfg.cohort_size))


def _grid(x: Tensor) -> Tensor:
    """A per-population scalar (...,) broadcast against the grid."""
    return x[..., None, None]


# -- the packed population state ---------------------------------------------

def init_population_state(u: Tensor, cfg: PopulationConfig
                          ) -> Dict[str, Tensor]:
    """Stationary initial state from (..., n_clients) uniforms."""
    grid = _flat_uniform(u, cfg)
    a0 = availability_rate(cfg, torch.zeros(u.shape[:-1], dtype=torch.int32,
                                            device=u.device))
    avail = (grid < _grid(a0)).to(torch.int8)
    avail = torch.where(grid > 1.0, torch.full_like(avail, PAD), avail)
    return {"avail": avail,
            "t": torch.zeros(u.shape[:-1], dtype=torch.int32,
                             device=u.device)}


def population_step(state: Dict[str, Tensor], u: Tensor,
                    cfg: PopulationConfig) -> Dict[str, Tensor]:
    """Advance every chain one round with the (..., n_clients) uniforms."""
    if cfg.mode == "diurnal":
        a = _grid(availability_rate(cfg, state["t"]))
        p_gb, p_bg = 1.0 - a, a
    else:
        p_gb, p_bg = (f32(p) for p in transition_probs(cfg))
    grid = _flat_uniform(u, cfg)
    avail = state["avail"]
    nxt = torch.where(avail == 1, grid >= p_gb, grid < p_bg).to(torch.int8)
    return {"avail": torch.where(avail >= 0, nxt, avail),
            "t": state["t"] + 1}


def _participation_stats(avail_now: Tensor, avail_next: Tensor, ids: Tensor,
                         cfg: PopulationConfig) -> Dict[str, Tensor]:
    """The round's cohort ``ids`` (..., participants) and its summary."""
    flat_now = avail_now.flatten(-2)
    flat_next = avail_next.flatten(-2)
    ids = ids.to(torch.int64)
    part = (flat_now.gather(-1, ids) == 1).to(torch.float32)
    n_t = part.sum(-1)
    vanish = part * (flat_next.gather(-1, ids) == 0).to(torch.float32)
    slow = part * (client_jitter(ids) < f32(cfg.slow_frac)).to(
        torch.float32)
    denom = torch.clamp(n_t, min=1.0)
    return {"part": part, "n_t": n_t, "churn": vanish.sum(-1) / denom,
            "slow": slow, "slow_share": slow.sum(-1) / denom,
            "n_avail": (flat_now == 1).sum(-1).to(torch.float32)}


def population_round(state: Dict[str, Tensor], u: Tensor, ids: Tensor,
                     cfg: PopulationConfig
                     ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """One population round: the cohort ``ids`` from the current state,
    every chain advanced with ``u``, churn coupled to the transitions ->
    ``(state', stats)``."""
    nxt = population_step(state, u, cfg)
    stats = _participation_stats(state["avail"], nxt["avail"], ids, cfg)
    stats["rate"] = availability_rate(cfg, state["t"])
    return nxt, stats


def round_generator(seed: int, tag: int, t: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, tag, t)`` alone (a
    host computation: ``t`` is a Python int)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, tag, t])
                        .generate_state(1, np.uint64)[0]))
    return gen


def stateless_avail(seed: int, r: int, cfg: PopulationConfig,
                    device=None) -> Tensor:
    """Round r's (n_clients,) int8 availability of the memoryless launch
    path: uniforms from a generator seeded ``(seed, 0xA, r)`` below the
    rate a(r)."""
    device = resolve_device(device)
    u = torch.rand(cfg.n_clients, generator=round_generator(
        seed, 0xA, r, device), dtype=torch.float32, device=device)
    return (u < availability_rate(cfg, r, device)).to(torch.int8)


def stateless_round(seed: int, t: int, cfg: PopulationConfig,
                    device=None) -> Dict[str, Tensor]:
    """Memoryless round ``t`` (a host int) for the launch path (iid |
    diurnal): ``now`` is ``stateless_avail(t)``, ``next`` is
    ``stateless_avail(t + 1)`` — round t+1's ``now`` — and the cohort comes
    from a generator seeded ``(seed, 0xB, t)``."""
    if cfg.mode == "ge":
        raise ValueError(
            "stateless_round supports the memoryless modes (iid, diurnal); "
            "Gilbert–Elliott bursts carry chain state — use "
            "init_population_state / population_round")
    device = resolve_device(device)
    ids = torch.randint(0, cfg.n_clients, (cfg.participants,),
                        generator=round_generator(seed, 0xB, t, device),
                        device=device)
    stats = _participation_stats(
        stateless_avail(seed, t, cfg, device)[None],
        stateless_avail(seed, t + 1, cfg, device)[None], ids, cfg)
    stats["rate"] = availability_rate(cfg, t, device)
    return stats


# -- round-level effects -----------------------------------------------------

def churn_erase_mask(u: Tensor, d: int, churn: Tensor,
                     cfg: PopulationConfig) -> Tensor:
    """(..., d) churn erasure mask from the block uniforms ``u``
    (..., ⌈d/erase_block⌉): a block erases where ``u < exposure · churn``
    (``churn`` shaped to broadcast against ``u``)."""
    p = torch.clamp(churn.to(torch.float32) * f32(cfg.exposure), 0.0, 1.0)
    hit = u < p
    return hit.to(torch.float32).repeat_interleave(
        cfg.erase_block, dim=-1)[..., :d]


def draw_round(gen: torch.Generator, cfg: PopulationConfig, device,
               shape: Tuple[int, ...] = ()) -> Tuple[Tensor, Tensor]:
    """One round's draws on ``gen``: (..., n_clients) uniforms and the
    (..., participants) int64 cohort ids."""
    u = torch.rand(shape + (cfg.n_clients,), generator=gen,
                   dtype=torch.float32, device=device)
    ids = torch.randint(0, cfg.n_clients, shape + (cfg.participants,),
                        generator=gen, device=device)
    return u, ids


def population_scan(cfg: PopulationConfig, rounds: int,
                    gen: torch.Generator, device=None
                    ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """The whole trajectory: a stationary start and ``rounds`` rounds in a
    loop on the device -> ``(final state, traces)``, the per-round traces
    (rounds,) of ``n_avail``, ``n_t``, ``churn``, ``slow_share`` and
    ``rate``."""
    device = gen.device if device is None else device
    state = init_population_state(
        torch.rand(cfg.n_clients, generator=gen, dtype=torch.float32,
                   device=device), cfg)
    keys = ("n_avail", "n_t", "churn", "slow_share", "rate")
    traces = {k: [] for k in keys}
    for _ in range(rounds):
        u, ids = draw_round(gen, cfg, device)
        state, ps = population_round(state, u, ids, cfg)
        for k in keys:
            traces[k].append(ps[k])
    return state, {k: torch.stack(v) for k, v in traces.items()}
