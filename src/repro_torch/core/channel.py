"""Geometric wireless channel (the port of ``repro.core.channel``): static
log-distance path gains, Gauss–Markov Rayleigh block fading, truncated
channel inversion and imperfect CSI.

* ``ChannelConfig`` and its numpy properties ``g_eff``, ``gains``,
  ``outage`` and ``thin`` are copies of the reference's: the deployment is
  a pure function of the config.
* The per-client chain: ``fading_step``, ``init_channel_state``,
  ``channel_round`` (the ``sent`` gate: ``L_n |f_n|^2 >= g_eff``) and
  ``csi_weights`` (``1 + σ_e e_n``).
* The launch path's per-block chain: ``n_blocks``, ``init_block_fading``,
  ``block_outage`` and ``csi_block_factor``; and the block erasure
  primitive ``expand_block_mask`` / ``block_erase_mask`` that
  ``faults.fade_mask`` shares.

Randomness: every function takes its draws as tensors — ``w_normal``
standard normals (..., 2) for a fading step, ``e`` standard normals for
the CSI error, ``u`` uniforms for a block erasure — and works on any
leading batch axes (the sweep's lanes).  ``init_block_fading``'s cold
start is the one fixed draw: a CPU generator seeded ``0xFAD``, moved to
the device, so it is the same on every device.

Arithmetic follows the compiled reference (XLA on the CPU contracts into
fused multiply-adds, ``fma32``): the fading step is
``fma(ρ, f, round(√((1−ρ²)/2)·w))``, the power ``fma(f_im, f_im,
round(f_re²))`` and the CSI factor ``fma(σ_e, e, 1)``.  The power, gain
and gate then equal the reference's bit for bit given the same chain; the step itself differs in
the last place on some coordinates (so does the CSI factor), because the
reference folds its constants into the normal draw's ``erfinv`` value.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

Tensor = torch.Tensor

_SQRT_HALF = math.sqrt(0.5)     # CN(0, 1): each real component N(0, 1/2)
FADING_INIT_KEY = 0xFAD         # seed of the launch path's cold-start draw


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """A geometric wireless deployment (fields, defaults and checks of
    ``repro.core.channel.ChannelConfig``)."""
    n_clients: int = 16        # clients in the deployment (= the trainer's N)
    pmax: float = 10.0         # per-client transmit power budget
    gmin: float = 0.05         # designed truncation threshold on L_n |f_n|^2
    rho_f: float = 0.0         # AR(1) fading correlation in [0, 1)
    csi_err: float = 0.0       # σ_e: residual channel-estimation error
    pl_exp: float = 3.0        # log-distance path-loss exponent
    shadow_db: float = 0.0     # log-normal shadowing std in dB
    near: float = 0.1          # nearest client's normalized distance
    geo_seed: int = 0          # shadowing draw seed (numpy)
    block: int = 128           # coordinates per fading block (launch path)

    def __post_init__(self):
        if self.n_clients < 1:
            raise ValueError(
                f"n_clients must be >= 1, got {self.n_clients}")
        if not (self.pmax > 0.0 and math.isfinite(self.pmax)):
            raise ValueError(
                f"pmax must be a finite positive power budget, got "
                f"{self.pmax}")
        if self.gmin < 0.0:
            raise ValueError(f"gmin must be >= 0, got {self.gmin}")
        if not 0.0 <= self.rho_f < 1.0:
            raise ValueError(
                f"rho_f must be in [0, 1) (rho_f = 1 would freeze the "
                f"fading chain), got {self.rho_f}")
        if self.csi_err < 0.0:
            raise ValueError(f"csi_err must be >= 0, got {self.csi_err}")
        if self.pl_exp < 0.0:
            raise ValueError(f"pl_exp must be >= 0, got {self.pl_exp}")
        if self.shadow_db < 0.0:
            raise ValueError(
                f"shadow_db must be >= 0, got {self.shadow_db}")
        if not 0.0 < self.near <= 1.0:
            raise ValueError(
                f"near must be in (0, 1] (normalized cell radius), got "
                f"{self.near}")
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")

    @property
    def g_eff(self) -> float:
        """Effective truncation threshold ``max(gmin, 1/pmax)``."""
        return max(self.gmin, 1.0 / self.pmax)

    @property
    def gains(self) -> np.ndarray:
        """(n_clients,) float64 static path gains: log-distance loss on
        the grid ``[near, 1]`` plus ``shadow_db`` log-normal shadowing
        from ``numpy.default_rng(geo_seed)``."""
        n = self.n_clients
        dist = self.near + (1.0 - self.near) * (np.arange(n) + 0.5) / n
        gain_db = -10.0 * self.pl_exp * np.log10(dist)
        if self.shadow_db > 0.0:
            rng = np.random.default_rng(self.geo_seed)
            gain_db = gain_db + self.shadow_db * rng.standard_normal(n)
        return 10.0 ** (gain_db / 10.0)

    @property
    def outage(self) -> np.ndarray:
        """(n_clients,) stationary per-client outage
        ``1 − exp(−g_eff/L_n)``."""
        return -np.expm1(-self.g_eff / self.gains)

    @property
    def thin(self) -> float:
        """Per-round refresh-blocking probability: every client truncated
        at once (``markov.truncation_thin``)."""
        return min(0.99, float(np.prod(self.outage)))


def f32(x: float) -> float:
    """A Python float rounded to float32: the reference compares and
    scales float32 arrays by weakly typed constants, i.e. by their
    float32 values."""
    return float(np.float32(x))


# -- block-granular erasure (shared with faults.fade_mask) -------------------

def expand_block_mask(hit: Tensor, d: int, block: int) -> Tensor:
    """Per-block booleans (..., nb) -> the (..., d) float32 erasure mask
    (1.0 = erased)."""
    return hit.to(torch.float32).repeat_interleave(block, dim=-1)[..., :d]


def block_erase_mask(u: Tensor, d: int, p, block: int) -> Tensor:
    """(..., d) erasure mask at ``block`` granularity from the block
    uniforms ``u`` (..., ⌈d/block⌉): a block erases where ``u < p``."""
    return expand_block_mask(u < p, d, block)


# -- per-client fading chain -------------------------------------------------

def fma32(a, b: Tensor, c: Tensor) -> Tensor:
    """``a·b + c`` rounded once to float32 (formed in float64, where the
    product of two float32 values is exact); ``a`` a tensor or a Python
    float holding a float32 value."""
    if isinstance(a, Tensor):
        a = a.to(torch.float64)
    return (a * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


def fading_step(fad: Tensor, w_normal: Tensor, rho_f: float) -> Tensor:
    """One AR(1) transition ``f' = ρ f + √(1 − ρ²) w`` with ``w ~ CN(0, 1)``
    given as the standard normals ``w_normal`` (each component of ``w`` is
    ``√½ · w_normal``); elementwise, any leading axes."""
    scale = np.float32(math.sqrt(1.0 - rho_f * rho_f)) * np.float32(_SQRT_HALF)
    return fma32(f32(rho_f), fad.to(torch.float32),
                  float(scale) * w_normal.to(torch.float32))


def power(fad: Tensor) -> Tensor:
    """``|f|^2`` of a (..., 2) chain: ``fma(f_im, f_im, round(f_re²))``."""
    re, im = fad[..., 0], fad[..., 1]
    return fma32(im, im, re * re)


def init_channel_state(w_normal: Tensor, cfg: ChannelConfig
                       ) -> Dict[str, Tensor]:
    """Stationary initial state from (..., n_clients, 2) standard normals:
    ``fad = √½ · w_normal``."""
    if w_normal.shape[-2:] != (cfg.n_clients, 2):
        raise ValueError(f"w_normal must be (..., {cfg.n_clients}, 2), got "
                         f"{tuple(w_normal.shape)}")
    return {"fad": f32(_SQRT_HALF) * w_normal.to(torch.float32)}


_GAINS: Dict[Tuple[ChannelConfig, torch.device], Tensor] = {}


def _gains(cfg: ChannelConfig, device: torch.device) -> Tensor:
    """The float32 path gains on ``device``, uploaded once per config and
    device (a round makes no host-to-device copy)."""
    key = (cfg, device)
    if key not in _GAINS:
        _GAINS[key] = torch.as_tensor(cfg.gains.astype(np.float32),
                                      device=device)
    return _GAINS[key]


def channel_round(state: Dict[str, Tensor], w_normal: Tensor,
                  cfg: ChannelConfig
                  ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """Advance every client's chain and apply truncated channel inversion
    -> ``(state', stats)``: ``sent`` the (..., N) float32 gate, ``n_sent``
    its count, ``gain`` the instantaneous ``L_n |f_n|^2``."""
    fad = fading_step(state["fad"], w_normal, cfg.rho_f)
    gain = _gains(cfg, fad.device) * power(fad)
    sent = (gain >= f32(cfg.g_eff)).to(torch.float32)
    return {"fad": fad}, {"sent": sent, "n_sent": sent.sum(-1),
                          "gain": gain}


def csi_weights(e: Tensor, cfg: ChannelConfig) -> Tensor:
    """Residual misalignment ``1 + σ_e e_n`` from standard normals ``e``;
    exact ones when ``csi_err`` is 0."""
    if cfg.csi_err <= 0.0:
        return torch.ones_like(e, dtype=torch.float32)
    return fma32(f32(cfg.csi_err), e.to(torch.float32),
                 torch.ones_like(e, dtype=torch.float32))


# -- aggregate-equivalent per-block chain (launch path) ----------------------

def n_blocks(d: int, cfg: ChannelConfig) -> int:
    """Fading blocks covering a (d,) buffer."""
    return -(-d // cfg.block)


def init_block_fading(nb: int, device=None) -> Tensor:
    """(2 nb,) float32 stationary per-block fading: the fixed draw of a CPU
    generator seeded ``FADING_INIT_KEY``, moved to ``device``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(FADING_INIT_KEY)
    w = torch.randn(nb, 2, generator=gen, dtype=torch.float32)
    return (f32(_SQRT_HALF) * w).reshape(-1).to(resolve_device(device))


def block_outage(fad_flat: Tensor, w_normal: Tensor, d: int,
                 cfg: ChannelConfig) -> Tuple[Tensor, Tensor]:
    """One launch-path channel round: advance the per-block chain with the
    (nb, 2) normals and erase every block whose power falls below
    ``−log(1 − thin)`` -> ``(fad_flat', erase (d,))``."""
    nb = n_blocks(d, cfg)
    fad = fading_step(fad_flat.reshape(nb, 2), w_normal, cfg.rho_f)
    thr = f32(-math.log1p(-cfg.thin))
    return fad.reshape(-1), expand_block_mask(power(fad) < thr, d, cfg.block)


def csi_block_factor(e: Tensor, d: int, cfg: ChannelConfig) -> Tensor:
    """(d,) per-block CSI factor ``1 + σ_e/√N · e_b`` from the (nb,)
    normals ``e``; exact ones when ``csi_err`` is 0."""
    if cfg.csi_err <= 0.0:
        return torch.ones(d, dtype=torch.float32, device=e.device)
    scale = f32(cfg.csi_err / math.sqrt(cfg.n_clients))
    e = e.to(torch.float32)
    return fma32(scale, e, torch.ones_like(e)).repeat_interleave(
        cfg.block)[:d]
