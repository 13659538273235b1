"""Shared harness for the PyTorch port's tests (``tests/test_torch_*.py``).

Builds identical numpy inputs for the JAX package and the port from a
seed, draws the reference's random numbers from its named key ladder
(``repro.core.keys.split_named``) so both sides see the same fading and
noise, and moves arrays between the frameworks as numpy.  Importing it
caps torch at two threads: the suite runs under several xdist workers.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import keys as keys_mod
from repro.core import oac as jax_oac
from repro.data import partition as jax_partition
from repro.data import synthetic as jax_synthetic
from repro.fl import trainer as jax_trainer
from repro.models import cnn as jax_cnn
from repro_torch.models import cnn

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


def exact_round_draws(key, fl, d: int) -> Dict[str, np.ndarray]:
    """The JAX trainer's draws on the exact backend for one round key:
    ``u`` (d,) from ``sel`` for toprand / randk; on the coherent uplink
    fading ``h`` and noise ``z`` (k,) from the two halves of ``ch``, on
    the one-bit uplink ``z`` (k,) from ``ch`` itself."""
    ks = keys_mod.split_named(key, ("sel", "ch"))
    k = fl.budgets(d)[0]
    draws = {}
    if fl.policy in ("toprand", "randk"):
        draws["u"] = np.asarray(jax.random.uniform(ks["sel"], (d,),
                                                   jnp.float32))
    if fl.one_bit:
        draws["z"] = np.asarray(jax.random.normal(ks["ch"], (k,),
                                                  jnp.float32))
    else:
        key_h, key_z = jax.random.split(ks["ch"])
        draws["h"] = np.asarray(jax_oac.sample_fading(key_h, fl.n_clients,
                                                      fl.channel))
        draws["z"] = np.asarray(jax.random.normal(key_z, (k,), jnp.float32))
    return draws


def engine_draws(key, d: int) -> Dict[str, np.ndarray]:
    """The exact engine's draws for one key: the uniform ``u`` of the
    random policies from the selection half, the standard-normal noise
    ``noise`` (d,) from the other."""
    key_sel, key_noise = jax.random.split(key)
    return {"u": np.asarray(jax.random.uniform(key_sel, (d,), jnp.float32)),
            "noise": np.asarray(jax.random.normal(key_noise, (d,),
                                                  jnp.float32))}


# --- the FL slice on a narrow prototype CNN --------------------------------

def small_fl_task(rounds: int, n_clients: int = 4):
    """(params, batches): a narrow prototype CNN (16x16x1 input, widths
    (4, 6, 8), fc 16, 10 classes, d = 1400) and ``rounds`` rounds of client
    batches for ``n_clients`` clients (4 unless given), H = 2, B = 3 over a
    Dir(0.3) split of max(400, 100 N) samples."""
    # 400 training samples, more for many clients (every Dirichlet shard
    # needs a few)
    spec = jax_synthetic.DatasetSpec("t", (16, 16, 1), 10,
                                     max(400, 100 * n_clients), 50,
                                     sparsity=0.1)
    (xtr, ytr), _ = jax_synthetic.make_dataset(spec, seed=0)
    parts = jax_partition.dirichlet_partition(ytr, n_clients, 0.3, seed=0)
    params = jax_cnn.init_prototype_cnn(jax.random.PRNGKey(1), (16, 16, 1),
                                        10, (4, 6, 8), 16)
    batches = [jax_partition.client_batches(xtr, ytr, parts, 3, 2, seed=t)
               for t in range(rounds)]
    return params, batches


def jax_loss(p, x, y):
    return jax_cnn.softmax_xent(jax_cnn.prototype_cnn(p, x), y)


def torch_loss(p, x, y):
    return cnn.softmax_xent(cnn.prototype_cnn(p, x), y)


def torch_params(params):
    return cnn.params_from_numpy(jax.tree_util.tree_map(np.asarray, params))


def run_jax_rounds(jfl, params, batches, draws_fn: Callable,
                   spies: Sequence[Tuple[object, str, str, int]] = ()):
    """The JAX trainer's loop over ``batches``; per round the state before
    and after it, the draws (``draws_fn(key, d)``), the controller state
    after it (``ctrl``), the round's metrics and the values recorded from
    inside the compiled round.  ``spies``: (module, function name,
    record name, argument position) — the argument is recorded with
    ``jax.debug.callback`` every time the round calls the function."""
    state, unravel = jax_trainer.init_server(params, jfl)
    d = state.w.shape[0]
    captured = {}
    originals = [(mod, name, getattr(mod, name))
                 for mod, name, _, _ in spies]

    def spy(orig, record, pos):
        def wrapped(*a, **kw):
            jax.debug.callback(
                lambda v: captured.__setitem__(record, np.asarray(v)),
                a[pos])
            return orig(*a, **kw)
        return wrapped

    for (mod, name, record, pos), (_, _, orig) in zip(spies, originals):
        setattr(mod, name, spy(orig, record, pos))
    try:
        step = jax_trainer.make_fl_step(jfl, unravel, jax_loss, d)
        key = jax.random.PRNGKey(jfl.seed)
        carry = (state.w, state.g, state.age, state.sel_count,
                 state.residual, state.theta, state.ctrl)
        out = []
        for xs, ys in batches:
            key, sub = jax.random.split(key)
            w, g, age, sc, res, ts, cs = carry
            (w2, g2, age2, sc2, res2, _, ts2, cs2, metrics) = step(
                sub, w, g, age, sc, jnp.asarray(xs), jnp.asarray(ys), res,
                ts, cs)
            jax.effects_barrier()
            out.append({"before": carry,
                        "after": (w2, g2, age2, sc2, res2, ts2),
                        "draws": draws_fn(sub, d),
                        "ctrl": cs2, "metrics": metrics,
                        "captured": dict(captured)})
            carry = (w2, g2, age2, sc2, res2, ts2, cs2)
    finally:
        for mod, name, orig in originals:
            setattr(mod, name, orig)
    return out, d
