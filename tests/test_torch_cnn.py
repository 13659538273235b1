"""The port's prototype CNN and MLP against the JAX models, on weights
carried across with ``params_from_numpy``.

``ravel_params`` must equal ``ravel_pytree`` bit for bit (the flat index
decides jitter, histogram sample and selection).  Logits and gradients
agree within rtol 1e-4 / atol 1e-5 (float32 convolutions sum in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torchutil import to_np, to_torch

from repro.models import cnn as jax_cnn
from repro_torch.models import cnn


def _jax_params(kind, seed=0):
    key = jax.random.PRNGKey(seed)
    if kind == "full":
        return jax_cnn.init_prototype_cnn(key), (28, 28, 1), 26
    if kind == "narrow":
        return (jax_cnn.init_prototype_cnn(key, (16, 16, 1), 10, (4, 6, 8),
                                           16), (16, 16, 1), 10)
    return jax_cnn.init_mlp_classifier(key, 64, 5, (16,)), (8, 8, 1), 5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_full_width_param_count():
    p, _, _ = _jax_params("full")
    assert jax_cnn.param_count(p) == 109_210
    assert cnn.param_count(cnn.params_from_numpy(_np_tree(p))) == 109_210
    gen = torch.Generator()
    gen.manual_seed(0)
    assert cnn.param_count(cnn.init_prototype_cnn(gen)) == 109_210


@pytest.mark.parametrize("kind", ["full", "narrow", "mlp"])
def test_ravel_matches_ravel_pytree(kind):
    p, _, _ = _jax_params(kind)
    j_flat, j_unravel = ravel_pytree(p)
    t_params = cnn.params_from_numpy(_np_tree(p))
    t_flat, t_unravel = cnn.ravel_params(t_params)
    np.testing.assert_array_equal(to_np(t_flat).view(np.uint32),
                                  np.asarray(j_flat).view(np.uint32))
    back = t_unravel(t_flat)
    for (jp, jl), (tp, tl) in zip(
            jax.tree_util.tree_flatten_with_path(j_unravel(j_flat))[0],
            jax.tree_util.tree_flatten_with_path(
                jax.tree_util.tree_map(to_np, back))[0]):
        assert jp == tp
        np.testing.assert_array_equal(tl, np.asarray(jl))


@pytest.mark.parametrize("kind", ["full", "narrow", "mlp"])
def test_logits_and_grads_match_jax(kind):
    p, shape, n_cls = _jax_params(kind, seed=3)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6,) + shape).astype(np.float32)
    y = rng.integers(0, n_cls, size=6).astype(np.int32)
    fwd_j = jax_cnn.mlp_classifier if kind == "mlp" else jax_cnn.prototype_cnn
    fwd_t = cnn.mlp_classifier if kind == "mlp" else cnn.prototype_cnn
    j_logits = fwd_j(p, jnp.asarray(x))
    t_params = cnn.params_from_numpy(_np_tree(p))
    t_logits = fwd_t(t_params, to_torch(x))
    np.testing.assert_allclose(to_np(t_logits), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-5)
    j_flat, j_unravel = ravel_pytree(p)

    def j_loss(w):
        return jax_cnn.softmax_xent(fwd_j(j_unravel(w), jnp.asarray(x)),
                                    jnp.asarray(y))

    t_flat, t_unravel = cnn.ravel_params(t_params)

    def t_loss(w):
        return cnn.softmax_xent(fwd_t(t_unravel(w), to_torch(x)),
                                to_torch(y))

    np.testing.assert_allclose(float(t_loss(t_flat)), float(j_loss(j_flat)),
                               rtol=1e-5)
    np.testing.assert_allclose(to_np(torch.func.grad(t_loss)(t_flat)),
                               np.asarray(jax.grad(j_loss)(j_flat)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        float(cnn.accuracy(t_logits, to_torch(y))),
        float(jax_cnn.accuracy(j_logits, jnp.asarray(y))))


def test_module_wrapper_matches_functional():
    p, shape, _ = _jax_params("narrow", seed=1)
    t_params = cnn.params_from_numpy(_np_tree(p))
    model = cnn.PrototypeCNN(t_params)
    x = torch.randn((3,) + shape, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(to_np(model(x).detach()),
                                  to_np(cnn.prototype_cnn(t_params, x)))
    assert sum(p.numel() for p in model.parameters()) == cnn.param_count(
        t_params)


def test_data_copies_match_jax_package():
    from repro.data import partition as jax_part
    from repro.data import synthetic as jax_syn
    from repro_torch.data import partition, synthetic
    spec = synthetic.DatasetSpec("t", (8, 8, 1), 5, 300, 50, sparsity=0.1)
    jspec = jax_syn.DatasetSpec("t", (8, 8, 1), 5, 300, 50, sparsity=0.1)
    (a, b), (c, e) = synthetic.make_dataset(spec, seed=3)
    (ja, jb), (jc, je) = jax_syn.make_dataset(jspec, seed=3)
    for u, v in ((a, ja), (b, jb), (c, jc), (e, je)):
        np.testing.assert_array_equal(u, v)
    parts = partition.dirichlet_partition(b, 6, 0.3, seed=1)
    jparts = jax_part.dirichlet_partition(jb, 6, 0.3, seed=1)
    for u, v in zip(parts, jparts):
        np.testing.assert_array_equal(u, v)
    xs, ys = partition.client_batches(a, b, parts, 4, 3, seed=2)
    jxs, jys = jax_part.client_batches(ja, jb, jparts, 4, 3, seed=2)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)
