"""Shared harness for the PyTorch port's tests (``tests/test_torch_*.py``).

Builds identical numpy inputs for the JAX package and the port from a
seed, draws the reference's random numbers from its named key ladder
(``repro.core.keys.split_named``) so both sides see the same fading and
noise, and moves arrays between the frameworks as numpy.  Importing it
caps torch at two threads: the suite runs under several xdist workers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import keys as keys_mod
from repro.core import oac as jax_oac

torch.set_num_threads(2)

D_KERNEL = 5000          # not a multiple of 256: the ragged tail matters


def to_torch(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fairk_inputs(seed: int, d: int = D_KERNEL) -> Dict[str, np.ndarray]:
    """Server-pass inputs: heavy-tailed g (exact zeros and ±0.0 included),
    integer ages 0..130 (past AGE_CAP) with interior pad runs (PAD_AGE),
    a residual, and ±1 one-bit ``fresh`` values with a few zeros."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_t(3, size=d) * 0.1).astype(np.float32)
    g[rng.choice(d, 20, replace=False)] = 0.0
    g[rng.choice(d, 20, replace=False)] = -0.0
    age = rng.integers(0, 131, size=d).astype(np.float32)
    for start in (137, 1024, 2999):
        age[start:start + 41] = -1.0
    age[-7:] = -1.0
    fresh = np.where(rng.random(d) < 0.5, 1.0, -1.0).astype(np.float32)
    fresh[rng.choice(d, 10, replace=False)] = 0.0
    return {"g": g,
            "g_prev": rng.normal(size=d).astype(np.float32),
            "age": age,
            "residual": (rng.normal(size=d) * 0.05).astype(np.float32),
            "fresh": fresh}


def inject_nonfinite(x: np.ndarray, seed: int, n: int = 30) -> np.ndarray:
    """A copy of ``x`` with NaN, +Inf and -Inf at ``n`` positions each."""
    rng = np.random.default_rng(seed)
    out = x.copy()
    pos = rng.choice(x.shape[0], 3 * n, replace=False)
    out[pos[:n]] = np.nan
    out[pos[n:2 * n]] = np.inf
    out[pos[2 * n:]] = -np.inf
    return out


def theta_cases(g: np.ndarray, age: np.ndarray) -> Dict[str, Tuple[float,
                                                                      float]]:
    """θ pairs: both 0 (full refresh), finite quantiles, and each stage
    switched off with inf."""
    mag = np.abs(g[np.isfinite(g)])
    tm = float(np.quantile(mag, 0.9))
    ta = float(np.quantile(age[age >= 0], 0.8)) + 0.5
    return {"zero": (0.0, 0.0), "finite": (tm, ta),
            "inf_m": (float("inf"), ta), "inf_a": (tm, float("inf")),
            "inf_both": (float("inf"), float("inf"))}


def edge_samples(score: np.ndarray, weight: np.ndarray) -> int:
    """How many weighted samples lie within 1e-5 of a quarter-octave bin
    edge: only these may land one bin apart when two libraries' ``log2``
    differ in the last place."""
    with np.errstate(divide="ignore", invalid="ignore"):
        q = 4.0 * np.log2(np.abs(score.astype(np.float64)))
        near = np.isfinite(q) & (np.abs(q - np.round(q)) < 1e-5)
    return int((near & weight).sum())


def round_draws(key, n_clients: int, d: int, channel
                ) -> Dict[str, np.ndarray]:
    """The JAX trainer's draws for one round key: fading ``h`` from
    ``sel`` and the standard-normal channel noise ``z`` from ``ch``."""
    ks = keys_mod.split_named(key, ("sel", "ch"))
    h = jax_oac.sample_fading(ks["sel"], n_clients, channel)
    z = jax.random.normal(ks["ch"], (d,), jnp.float32)
    return {"h": np.asarray(h), "z": np.asarray(z)}
