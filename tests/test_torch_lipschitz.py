"""The port's Table I estimator (``repro_torch.core.lipschitz``) against
``repro.core.lipschitz.estimate_constants`` on Table I's fast setting: the
MLP 144 → 32 → 6 with the JAX package's initial weights over 8 clients of
300 samples each (Dir(0.1), the most heterogeneous level), 3 perturbation
pairs, the JAX perturbation draws handed to the port.  Each gradient is a
float32 backward pass summed in another order, so the three constants are
held within rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import torch_params

from repro.core import lipschitz as jax_lipschitz
from repro.data import partition, synthetic
from repro.models import cnn as jax_cnn
from repro_torch.core import lipschitz
from repro_torch.models import cnn

N_CLIENTS, N_PAIRS = 8, 3


def _jax_draws(key, d):
    """The perturbation draws ``estimate_constants`` takes from ``key``."""
    out = []
    for _ in range(N_PAIRS):
        key, k1, k2 = jax.random.split(key, 3)
        out.append((np.array(jax.random.normal(k1, (d,))),
                    np.array(jax.random.normal(k2, (N_CLIENTS, d)))))
    return out


def test_estimate_constants_matches_jax():
    spec = synthetic.DatasetSpec("lip", (12, 12, 1), 6, 4000, 100,
                                 noise_std=1.0, sparsity=0.1)
    (xtr, ytr), _ = synthetic.make_dataset(spec, seed=0)
    parts = partition.dirichlet_partition(ytr, N_CLIENTS, 0.1, seed=0)
    subsets = [(xtr[p[:300]], ytr[p[:300]]) for p in parts]
    params = jax_cnn.init_mlp_classifier(jax.random.PRNGKey(0), 144, 6,
                                         hidden=(32,))

    @jax.jit
    def jgrad(p, x, y):
        return jax.grad(lambda q: jax_cnn.softmax_xent(
            jax_cnn.mlp_classifier(q, x), y))(p)

    j = jax_lipschitz.estimate_constants(
        jax.random.PRNGKey(1), params,
        lambda p, n: jgrad(p, jnp.asarray(subsets[n][0]),
                           jnp.asarray(subsets[n][1])),
        N_CLIENTS, n_pairs=N_PAIRS)
    t_subsets = [(torch.as_tensor(x), torch.as_tensor(y))
                 for x, y in subsets]

    def tgrad(p, n):
        x, y = t_subsets[n]
        return torch.func.grad(
            lambda q: cnn.softmax_xent(cnn.mlp_classifier(q, x), y))(p)

    tparams = torch_params(params)
    d = cnn.param_count(tparams)
    t = lipschitz.estimate_constants(
        tparams, tgrad, N_CLIENTS, n_pairs=N_PAIRS,
        draws=_jax_draws(jax.random.PRNGKey(1), d))
    assert set(t) == {"L_tilde2", "L_g2", "L_h2"}
    for key in t:
        np.testing.assert_allclose(t[key], j[key], rtol=1e-4, err_msg=key)
    # the paper's ordering on this task
    assert t["L_tilde2"] > t["L_g2"] > t["L_h2"] > 0.0


def test_estimate_constants_draws_from_a_generator():
    gen = torch.Generator().manual_seed(0)
    params = cnn.init_mlp_classifier(gen, 6, 3, hidden=(4,))
    xs = torch.randn(2, 10, 6, generator=gen)
    ys = torch.randint(0, 3, (2, 10), generator=gen)

    def grad_fn(p, n):
        return torch.func.grad(lambda q: cnn.softmax_xent(
            cnn.mlp_classifier(q, xs[n]), ys[n]))(p)

    a = lipschitz.estimate_constants(params, grad_fn, 2, n_pairs=2,
                                     generator=torch.Generator()
                                     .manual_seed(3))
    b = lipschitz.estimate_constants(params, grad_fn, 2, n_pairs=2,
                                     generator=torch.Generator()
                                     .manual_seed(3))
    assert a == b and all(np.isfinite(v) and v > 0 for v in a.values())
