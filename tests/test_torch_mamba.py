"""The Mamba-2 mixer (``repro_torch.models.mamba2``) against the JAX
package's (``repro.models.mamba2``) on the same numpy inputs and
weights: the causal convolution with and without its carry, ``_segsum``
and its gradient through the ``-inf`` mask, the chunked SSD scan (a
ragged length padded with dt = 0, an initial state) and its gradients,
the recurrent step, and the whole layer in its train, prefill (with a
cache) and decode forms.

Tolerances:
- float32: rtol 1e-5 / atol 1e-6 (products and cumsums in another
  order, XLA's float32 ``exp`` one ulp off); the scan's gradients within
  1e-5 of each leaf's largest magnitude;
- bf16 compute: z, x, B and C are rounded to bf16 in both packages, and
  XLA keeps float32 through the convolution's fused sum of K products,
  as the port does; within rtol 1.6e-2 / atol 1e-2 (two bf16 ulps),
  the whole layer's outputs (up to 2 in magnitude: one bf16 ulp there is
  0.0156) within atol 1e-2 of their largest magnitude; the new ``ssm``
  cache is rounded to its bf16 dtype in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import to_np

from repro.configs import get_config as jax_get_config
from repro.models import mamba2 as jm
from repro_torch import tree as tree_util
from repro_torch.configs import get_config
from repro_torch.launch.steps import state_from_numpy
from repro_torch.models import mamba2

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1.6e-2, atol=1e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return to_np(x.float() if x.is_floating_point() else x)
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_with_and_without_carry(dtype):
    rng = np.random.default_rng(0)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = F32 if dtype == "float32" else BF16
    x, w, b = _rand(rng, 2, 9, 12), _rand(rng, 4, 12, scale=0.3), _rand(
        rng, 12)
    state = _rand(rng, 2, 3, 12)
    for st in (None, state):
        jargs = [jnp.asarray(a).astype(jdt) for a in (x, w, b)]
        jst = None if st is None else jnp.asarray(st).astype(jdt)
        want = jax.jit(jm._causal_conv)(*jargs, jst)
        got = mamba2._causal_conv(_t(x, tdt), _t(w, tdt), _t(b, tdt),
                                  None if st is None else _t(st, tdt))
        assert got[0].dtype == tdt and got[1].shape == (2, 3, 12)
        np.testing.assert_allclose(_np(got[0]), _np(want[0]), **tol)
        np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    # one token at a time with the carry equals the whole sequence
    y_all, _ = mamba2._causal_conv(_t(x), _t(w), _t(b))
    carry = None
    for i in range(9):
        y1, carry = mamba2._causal_conv(_t(x[:, i:i + 1]), _t(w), _t(b),
                                        carry)
        np.testing.assert_allclose(_np(y1[:, 0]), _np(y_all[:, i]), **F32)


def test_segsum_and_its_gradient_are_finite():
    rng = np.random.default_rng(1)
    a = -np.abs(_rand(rng, 2, 8, 3))
    np.testing.assert_allclose(_np(mamba2._segsum(_t(a))),
                               np.asarray(jax.jit(jm._segsum)(a)), **F32)
    ta = _t(a).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.exp(mamba2._segsum(ta)).sum(), ta)
    jg = jax.grad(lambda v: jnp.exp(jm._segsum(v)).sum())(jnp.asarray(a))
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(_np(g), np.asarray(jg), rtol=0,
                               atol=1e-5 * float(np.abs(jg).max()))


def _ssd_inputs(rng, s, h=4, p=8, n=6, b=2):
    return (_rand(rng, b, s, h, p), np.abs(_rand(rng, b, s, h, scale=0.5)),
            -np.linspace(0.5, 2.0, h).astype(np.float32),
            _rand(rng, b, s, h, n, scale=0.5),
            _rand(rng, b, s, h, n, scale=0.5))


@pytest.mark.parametrize("s,chunk,init", [(32, 8, False), (20, 8, True),
                                          (5, 16, False)])
def test_ssd_chunked_and_its_gradients(s, chunk, init):
    rng = np.random.default_rng(2)
    x, dt, a, b, c = _ssd_inputs(rng, s)
    st = _rand(rng, 2, 4, 8, 6) if init else None
    r = _rand(rng, 2, s, 4, 8)
    rs = _rand(rng, 2, 4, 8, 6)

    def jloss(*args):
        y, fin = jm.ssd_chunked(*args, chunk=chunk, init_state=st)
        return (y * r).sum() + (fin * rs).sum(), (y, fin)
    (_, (jy, jfin)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(x, dt, a, b, c)
    targs = [_t(v).requires_grad_(True) for v in (x, dt, a, b, c)]
    y, fin = mamba2.ssd_chunked(*targs, chunk=chunk,
                                init_state=None if st is None else _t(st))
    grads = torch.autograd.grad((y * _t(r)).sum() + (fin * _t(rs)).sum(),
                                targs)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)
    np.testing.assert_allclose(_np(fin), np.asarray(jfin), **F32)
    for g, j in zip(grads, jg):
        j = np.asarray(j)
        np.testing.assert_allclose(_np(g), j, rtol=0,
                                   atol=1e-5 * float(np.abs(j).max()))
    # the chunked scan equals the recurrent step run token by token
    state = _t(st) if init else torch.zeros(2, 4, 8, 6)
    for i in range(s):
        y1, state = mamba2.ssd_step(state, _t(x[:, i]), _t(dt[:, i]), _t(a),
                                    _t(b[:, i]), _t(c[:, i]))
        np.testing.assert_allclose(_np(y1), _np(y[:, i]), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(_np(state), _np(fin), rtol=1e-4, atol=1e-5)


def test_ssd_step_matches_the_reference():
    rng = np.random.default_rng(3)
    state = _rand(rng, 2, 4, 8, 6)
    x, dt, b, c = (_rand(rng, 2, 4, 8), np.abs(_rand(rng, 2, 4)),
                   _rand(rng, 2, 4, 6), _rand(rng, 2, 4, 6))
    a = -np.linspace(0.5, 2.0, 4).astype(np.float32)
    want = jax.jit(jm.ssd_step)(state, x, dt, a, b, c)
    got = mamba2.ssd_step(*(_t(v) for v in (state, x, dt, a, b, c)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **F32)


def _cfgs(compute, param_dtype="float32"):
    kw = dict(compute_dtype=compute, param_dtype=param_dtype, ssm_chunk=8)
    return (dataclasses.replace(jax_get_config("mamba2-370m",
                                               reduced_variant=True), **kw),
            dataclasses.replace(get_config("mamba2-370m",
                                           reduced_variant=True), **kw))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mamba_layer_train_prefill_and_decode(compute):
    jcfg, tcfg = _cfgs(compute)
    jdt, tdt = jnp.dtype(compute), getattr(torch, compute)

    def close(got, want, what=""):
        want = _np(want)
        tol = (F32 if compute == "float32" else
               dict(rtol=1.6e-2, atol=1e-2 * float(np.abs(want).max())))
        np.testing.assert_allclose(_np(got), want, **tol, err_msg=what)
    p = jax.tree.map(np.asarray,
                     jm.init_mamba(jax.random.PRNGKey(4), jcfg,
                                   jnp.float32))
    p["dt_bias"] = np.linspace(-2.0, 30.0, p["dt_bias"].shape[0]).astype(
        np.float32)                # softplus above torch's threshold of 20
    tp = state_from_numpy(p, "cpu")
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 20, jcfg.d_model)
    jx, tx = jnp.asarray(x).astype(jdt), _t(x, tdt)

    # train: no cache in, none out
    want, j_none = jax.jit(lambda p_, x_: jm.mamba_layer(p_, x_, jcfg))(
        p, jx)
    got, t_none = mamba2.mamba_layer(tp, tx, tcfg)
    assert j_none is None and t_none is None and got.dtype == tdt
    close(got, want)

    # prefill into a cache, then two decoded tokens
    j_cache = jm.mamba_cache_init(2, jcfg, jdt)
    t_cache = mamba2.mamba_cache_init(2, tcfg, tdt)
    assert {k: (v.shape, v.dtype) for k, v in t_cache.items()} == {
        k: (v.shape, v.dtype) for k, v in
        mamba2.mamba_cache_spec(2, tcfg, tdt).items()}
    want, j_cache = jax.jit(lambda p_, x_, c: jm.mamba_layer(
        p_, x_, jcfg, cache=c))(p, jx, j_cache)
    got, t_cache = mamba2.mamba_layer(tp, tx, tcfg, cache=t_cache)
    close(got, want)
    for step in range(2):
        x1 = _rand(rng, 2, 1, jcfg.d_model)
        want, j_cache = jax.jit(lambda p_, x_, c: jm.mamba_layer(
            p_, x_, jcfg, cache=c, decode=True))(
                p, jnp.asarray(x1).astype(jdt), j_cache)
        got, t_cache = mamba2.mamba_layer(tp, _t(x1, tdt), tcfg,
                                          cache=t_cache, decode=True)
        close(got, want, f"decode {step}")
        for key in ("ssm", "conv_x", "conv_bc"):
            assert t_cache[key].dtype == tdt
            close(t_cache[key], j_cache[key], f"decode {step} {key}")


def test_init_mamba_matches_the_reference_layout():
    """Paths, shapes and dtypes of the reference's tree (``a_log``,
    ``d_skip`` and ``dt_bias`` float32 under bf16 parameters), and its
    deterministic leaves' values."""
    jcfg, tcfg = _cfgs("bfloat16", param_dtype="bfloat16")
    jp = jm.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tp = mamba2.init_mamba(torch.Generator().manual_seed(0), tcfg,
                           torch.bfloat16, lead=(2,))
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = tree_util.leaves(tp)
    assert [p for p, _ in tl] == [tuple(k.key for k in path)
                                  for path, _ in jl]
    for (path, t), (_, j) in zip(tl, jl):
        assert tuple(t.shape) == (2,) + j.shape, path
        assert str(t.dtype) == "torch." + str(j.dtype), path
    for key in ("a_log", "d_skip", "dt_bias"):
        assert tp[key].dtype == torch.float32
        np.testing.assert_allclose(_np(tp[key][1]), np.asarray(jp[key]),
                                   rtol=1e-6)
    assert mamba2.conv_channels(tcfg) == jm.conv_channels(jcfg)
