"""Age-of-Update (AoU) bookkeeping — paper Eq. (10) and the Fig. 5
statistics (the port of ``repro.core.aou``)."""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.packing import AGE_CAP

Tensor = torch.Tensor


def init_age(d: int, device=None) -> Tensor:
    """A_0 = 0 (paper Alg. 1 input)."""
    return torch.zeros(d, dtype=torch.float32, device=device)


def update_age(age: Tensor, mask: Tensor) -> Tensor:
    """Eq. (10): ``A_{t+1} = (A_t + 1) ∘ (1 − S_t)``, clipped at
    ``AGE_CAP`` (a NaN age stays NaN, as ``jnp.minimum`` keeps it)."""
    return torch.clamp((age + 1.0) * (1.0 - mask), max=AGE_CAP)


def update_age_by_indices(age: Tensor, idx: Tensor) -> Tensor:
    """Index form of Eq. (10): increment everywhere (clipped at
    ``AGE_CAP``), zero the selected."""
    return torch.clamp(age + 1.0, max=AGE_CAP).index_fill(0, idx, 0.0)


def max_staleness(d: int, k: int, k_m: int) -> int:
    """Lemma 1's support bound ``T = (d − k_M) / k_A`` (ceil)."""
    k_a = k - k_m
    if k_a <= 0:
        raise ValueError("max staleness is unbounded when k_a = 0 (pure "
                         "Top-k)")
    return -(-(d - k_m) // k_a)


def age_stats(age: Tensor) -> Dict[str, Tensor]:
    """Summary statistics of the Fig. 5a comparison (linear-interpolated
    percentiles, as ``jnp.percentile``)."""
    a = age.to(torch.float32)
    q = torch.quantile(a, torch.tensor([0.5, 0.99], dtype=torch.float32,
                                       device=a.device))
    return {"mean": a.mean(), "max": a.max(), "p50": q[0], "p99": q[1]}
