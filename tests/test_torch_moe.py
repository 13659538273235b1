"""The MoE FFN (``repro_torch.models.moe``) against the JAX package's
(``repro.models.moe``) on the same numpy inputs and weights.

The port dispatches and combines by index (each kept choice scattered
into its expert slot, each token gathering its K expert rows), the
reference by dense one-hot einsums; the routing integers are the same by
construction and are held exactly (expert choices with tied router
columns, slot positions, drops past the capacity), the values within:
- float32: rtol 1e-5 / atol 1e-6 on the output, the aux loss and the
  gradients (products summed in another order);
- bf16 compute: 2 bf16 ulps relative (rtol 1.6e-2, atol 1e-2) on the
  output (the K weighted terms summed in float32 and rounded once in
  both), gradients within 5e-2 of each leaf's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import to_np

from repro.models import moe as jmoe
from repro_torch import tree as tree_util
from repro_torch.launch.steps import state_from_numpy
from repro_torch.models import moe

D, F, E, K = 32, 48, 4, 2


def _np(x):
    x = x.detach()
    return to_np(x.float() if x.is_floating_point() else x)


def _weights(mlp_type, seed=0, tie=False):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), D, F, E, mlp_type,
                      jnp.float32)
    p = jax.tree.map(np.asarray, p)
    p["router"]["w"] = p["router"]["w"] * 4.0        # sharper routing
    if tie:
        # experts 1 and 2 tie for every token, and so do 0 and 3
        p["router"]["w"][:, 2] = p["router"]["w"][:, 1]
        p["router"]["w"][:, 3] = p["router"]["w"][:, 0]
    return p


def _run(p, x, compute, **kw):
    """(reference (out, aux, grads), port (out, aux, grads)); grads of
    sum(out · r) + aux by the weights and by x."""
    jdt, tdt = jnp.dtype(compute), getattr(torch, compute)
    r = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss(p_, x_):
        out, aux = jmoe.moe_ffn(p_, x_, compute_dtype=jdt, **kw)
        return (out.astype(jnp.float32) * r).sum() + aux, (out, aux)
    (_, (j_out, j_aux)), j_g = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(p, x)

    tp = state_from_numpy(p, "cpu")
    leaves = [tp["router"]["w"]] + [tp[k] for k in sorted(tp)
                                    if k != "router"]
    for t in leaves:
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_ffn(tp, tx, compute_dtype=tdt, **kw)
    loss = (out.float() * torch.from_numpy(r)).sum() + aux
    grads = torch.autograd.grad(loss, leaves + [tx])
    j_leaves = [j_g[0]["router"]["w"]] + [j_g[0][k] for k in sorted(tp)
                                          if k != "router"]
    return (j_out, j_aux, j_leaves + [j_g[1]]), (out, aux, grads)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    dict(mlp_type="swiglu", s=24, factor=1.25),
    dict(mlp_type="gelu", s=24, factor=1.25),
    dict(mlp_type="swiglu", s=24, factor=0.25),     # overflow: drops
    dict(mlp_type="swiglu", s=24, factor=1.25, tie=True),
    dict(mlp_type="swiglu", s=1, b=4, factor=1.25, decode=True),
    dict(mlp_type="swiglu", s=6, b=3, factor=1.0, decode=True),
])
def test_moe_ffn_matches_the_reference(case, compute):
    p = _weights(case["mlp_type"], tie=case.get("tie", False))
    x = np.random.default_rng(1).normal(
        size=(case.get("b", 2), case["s"], D)).astype(np.float32)
    kw = dict(top_k=K, capacity_factor=case["factor"],
              mlp_type=case["mlp_type"],
              decode_mode=case.get("decode", False))
    (j_out, j_aux, j_g), (out, aux, grads) = _run(p, x, compute, **kw)
    assert out.shape == x.shape and out.dtype == torch.float32
    if compute == "float32":
        tol, gtol = dict(rtol=1e-5, atol=1e-6), 1e-5
    else:
        tol, gtol = dict(rtol=1.6e-2, atol=1e-2), 5e-2
    np.testing.assert_allclose(_np(out), np.asarray(j_out, np.float32),
                               **tol)
    np.testing.assert_allclose(float(aux.detach()), float(j_aux), rtol=1e-5)
    for i, (g, jg) in enumerate(zip(grads, j_g)):
        jg = np.asarray(jg, np.float32)
        np.testing.assert_allclose(
            _np(g), jg, rtol=0, atol=gtol * float(np.abs(jg).max()),
            err_msg=f"grad {i}")
    if case["factor"] == 0.25:
        # 24 tokens x 2 choices over 4 experts x 4 slots: drops happen,
        # and a token that lost both choices has an exact zero row
        assert moe.capacity_per_row(24, E, K, 0.25) == 4
        zero = (_np(out) == 0).all(-1)
        np.testing.assert_array_equal(
            zero, (np.asarray(j_out) == 0).all(-1))
        assert zero.any()


def _reference_route(probs, top_k, cap):
    """The reference's routing integers (``moe.py``'s lines, in numpy
    after ``lax.top_k``)."""
    gate_vals, expert_idx = jax.lax.top_k(jnp.asarray(probs), top_k)
    expert_idx = np.asarray(expert_idx)
    b, s, _ = probs.shape
    onehot = np.eye(probs.shape[-1], dtype=np.int32)[expert_idx]
    flat = onehot.reshape(b, s * top_k, -1)
    pos = np.cumsum(flat, axis=1) - flat
    pos = (pos * flat).sum(-1).reshape(b, s, top_k)
    return expert_idx, pos, pos < cap


@pytest.mark.parametrize("cap", [2, 5])
def test_routing_integers_with_ties(cap):
    """Expert choices (ties toward the lower index, every token tied),
    slot positions and drops equal the reference's exactly."""
    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.ones(6), size=(3, 10)).astype(np.float32)
    probs[..., 4] = probs[..., 1]              # tied columns
    probs[0, :, :] = 1.0 / 6                   # a row of all-equal probs
    gates, expert, slot, kept = moe.route(torch.from_numpy(probs), 3, cap)
    j_exp, j_pos, j_kept = _reference_route(probs, 3, cap)
    np.testing.assert_array_equal(_np(expert), j_exp)
    np.testing.assert_array_equal(_np(slot), j_pos)
    np.testing.assert_array_equal(_np(kept), j_kept)
    assert (_np(expert)[0] == np.arange(3)).all()
    np.testing.assert_allclose(_np(gates).sum(-1), 1.0, rtol=1e-6)


def test_init_and_capacity_match_the_reference():
    gen = torch.Generator().manual_seed(0)
    for mlp_type in ("swiglu", "gelu"):
        tp = moe.init_moe(gen, D, F, E, mlp_type, torch.bfloat16, lead=(3,))
        jp = jax.eval_shape(lambda k: jmoe.init_moe(k, D, F, E, mlp_type,
                                                    jnp.bfloat16),
                            jax.random.PRNGKey(0))
        jflat = jax.tree_util.tree_leaves_with_path(jp)
        tflat = tree_util.leaves(tp)
        assert len(tflat) == len(jflat)
        for (path, t), (_, j) in zip(tflat, jflat):
            assert tuple(t.shape) == (3,) + j.shape, path
            assert str(t.dtype) == "torch." + str(j.dtype), path
        assert tp["router"]["w"].dtype == torch.float32
        assert abs(float(tp["wd"].float().std()) - 0.5 / F ** 0.5) < 0.01
    for s, e, k, f in ((512, 40, 8, 1.25), (1, 4, 2, 1.25), (24, 4, 2, 0.25),
                       (4096, 128, 2, 1.0)):
        assert moe.capacity_per_row(s, e, k, f) == jmoe.capacity_per_row(
            s, e, k, f)
