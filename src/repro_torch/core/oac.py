"""Over-the-air computation channel and gradient aggregation (paper
Sec. III-A), the port of ``repro.core.oac``:

    ǧ_t = (1/N) ( Σ_n h_{n,t} ǧ_{n,t} + ξ_t )                     (Eq. 7)
    g_t = S_t ∘ ǧ_t + (1 − S_t) ∘ g_{t−1}                          (Eq. 8)

Fading ``h_{n,t}`` is i.i.d. across clients and rounds with mean ``mu_c``
(default Rayleigh with mean 1, the paper's setting); receiver noise has
standard deviation ``noise_std``.  Only the ``k`` selected coordinates
ride the channel, so the aggregate is the compacted ``(k,)`` vector.

Randomness: the port cannot reproduce JAX's threefry streams, so these
functions take their draws as tensors — the fading ``h`` (N,) and the
standard-normal noise ``z`` (k,) — and ``sample_fading`` draws ``h`` from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_RAYLEIGH_MEAN = math.sqrt(math.pi / 2.0)  # mean of Rayleigh(sigma=1)


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Wireless channel parameters (paper Sec. III-A / V-A)."""

    fading: str = "rayleigh"          # "rayleigh" | "gaussian" | "none"
    mean: float = 1.0                 # mu_c
    std: float = 0.0                  # sigma_c; for rayleigh derived from mean
    noise_std: float = 0.0            # sigma_z

    def __post_init__(self):
        if self.fading not in ("rayleigh", "gaussian", "none"):
            raise ValueError(f"fading must be rayleigh|gaussian|none, got "
                             f"{self.fading!r}")
        if self.fading == "rayleigh" and self.std != 0.0:
            raise ValueError(
                f"rayleigh fading derives sigma_c from the mean — std="
                f"{self.std} would be silently ignored; leave std=0 or use "
                f"fading='gaussian'")

    @property
    def mu_c(self) -> float:
        return self.mean

    @property
    def sigma_c2(self) -> float:
        if self.fading == "rayleigh":
            return self.mean**2 * (4.0 - math.pi) / math.pi
        if self.fading == "gaussian":
            return self.std**2
        return 0.0


NOISELESS = ChannelConfig(fading="none", mean=1.0, noise_std=0.0)
PAPER_DEFAULT = ChannelConfig(fading="rayleigh", mean=1.0, noise_std=1.0)


def sample_fading(gen: torch.Generator, n_clients: int, cfg: ChannelConfig,
                  device) -> torch.Tensor:
    """Draw h_{n,t} for all clients for one round, shape (n_clients,)."""
    if cfg.fading == "none":
        return torch.full((n_clients,), cfg.mean, dtype=torch.float32,
                          device=device)
    if cfg.fading == "rayleigh":
        scale = cfg.mean / _RAYLEIGH_MEAN
        u = torch.rand(n_clients, generator=gen, dtype=torch.float32,
                       device=device)
        return scale * torch.sqrt(-2.0 * torch.log1p(-u))
    return cfg.mean + cfg.std * torch.randn(
        n_clients, generator=gen, dtype=torch.float32, device=device)


def reciprocal(n: int) -> float:
    """``1/n`` as the float32 the compiled reference multiplies by: XLA
    rewrites a division by a constant n as ``x * float32(1/n)``, which
    differs from true division in the last place for most n that are not
    powers of two.  Every 1/N of the port's round is this product."""
    return float(np.float32(1.0) / np.float32(n))


def oac_aggregate(client_values: Tensor, h: Tensor, z: Optional[Tensor],
                  cfg: ChannelConfig) -> Tensor:
    """Eq. (7): superpose the (N, k) compacted client vectors through the
    fading ``h`` (N,) and the receiver noise ``noise_std · z`` -> (k,)."""
    return finish_aggregate(h @ client_values, z, client_values.shape[0],
                            cfg)


def finish_aggregate(superposed: Tensor, z: Optional[Tensor],
                     n_clients: int, cfg: ChannelConfig) -> Tensor:
    """Receiver tail of Eq. (7) for a pre-superposed (k,) row: channel
    noise ``noise_std · z``, then the 1/N normalisation (the product with
    ``reciprocal(N)``)."""
    if cfg.noise_std > 0.0:
        if z is None:
            raise ValueError("noise_std > 0 needs a noise draw z")
        superposed = superposed + cfg.noise_std * z
    return superposed * reciprocal(n_clients)


def reconstruct(g_prev: Tensor, idx: Tensor, agg_values: Tensor) -> Tensor:
    """Eq. (8) in index form: refresh the selected coordinates, keep the
    stale rest (a scatter, so a −0.0 aggregate stays −0.0)."""
    return g_prev.index_copy(0, idx, agg_values.to(g_prev.dtype))


def oac_round(g_prev: Tensor, idx: Tensor, client_grads: Tensor, h: Tensor,
              z: Optional[Tensor], cfg: ChannelConfig
              ) -> Tuple[Tensor, Tensor]:
    """One uplink round over dense (N, d) client gradients and the (k,)
    selection ``idx`` -> ``(g_t, agg_k)``: the gather comes before the
    contraction over clients, as in the reference."""
    agg = oac_aggregate(client_grads[:, idx], h, z, cfg)
    return reconstruct(g_prev, idx, agg), agg
