"""Over-the-air computation channel (paper Sec. III-A): the configuration
and the per-round fading draw.

Fading ``h_{n,t}`` is i.i.d. across clients and rounds with mean ``mu_c``
(default Rayleigh with mean 1, the paper's setting); receiver noise has
standard deviation ``noise_std``.  Draws come from an explicit
``torch.Generator`` — the port cannot reproduce JAX's threefry streams, so
its round takes its random numbers as tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch

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
