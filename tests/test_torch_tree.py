"""The multi-leaf packed server phase against the JAX package's on a
transformer-shaped tree (``make_transformer_tree(2, 16, 64)``: 19 leaves,
interior pads after every leaf): ``select_and_merge_tree`` from no
carried state and with a carried one, and four persisted rounds (flat
bf16 ``g_prev``, int8 ``age``) on the legacy, error-feedback and fused
routes.  Then the structural counters of ``torch_packed_bench --smoke``.

Tolerances: trees, flat buffers, ages, counts, histograms and the carried
threshold state equal bit for bit (the reference runs eagerly), except the
carried θ_M and θ_A of the warm-start routes, within one ulp: on the
legacy route the reference computes its bootstrap inside ``lax.cond``, a
compiled branch whose quantile may contract the other product into the
FMA (see ``tests/test_torch_threshold.py``); on the fused route θ_M is
an ``exp2`` of the histogram estimate, which the two libraries may round
apart (as in ``tests/test_torch_engine.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import to_np

from benchmarks import packed_bench as jax_bench
from benchmarks import torch_packed_bench as bench
from repro.core import engine as jax_engine
from repro.core import packing as jax_packing
from repro_torch import tree as tree_util
from repro_torch.core import engine, packing
from repro_torch.kernels import ops

SHAPE = (2, 16, 64)


def _equal(t, j, what=""):
    t, j = to_np(t), np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, what
    if t.dtype == np.float32:
        np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(t, j, err_msg=what)


def _tstate_equal(ts, js, warm, what):
    for key in js:
        if warm and key in ("theta_m", "theta_a"):
            np.testing.assert_array_max_ulp(to_np(ts[key]),
                                            np.asarray(js[key]), maxulp=1)
        else:
            _equal(ts[key], js[key], f"{what} tstate.{key}")


def _tree_equal(t_tree, j_tree, what):
    t_leaves = tree_util.leaves(t_tree)
    j_leaves = jax.tree_util.tree_leaves(j_tree)
    assert len(t_leaves) == len(j_leaves)
    for (path, t), j in zip(t_leaves, j_leaves):
        _equal(t.to(torch.float32) if t.dtype == torch.bfloat16 else t,
               j.astype(jnp.float32) if j.dtype == jnp.bfloat16 else j,
               f"{what} {'/'.join(path)}")


@pytest.fixture(scope="module")
def trees():
    jt = jax_bench.make_transformer_tree(*SHAPE)
    tt = bench.make_transformer_tree(*SHAPE)
    _tree_equal(tt, jt, "tree")
    jgp, jage = jax_bench._server_state(jt)
    tgp, tage = bench.server_state(tt)
    _tree_equal(tgp, jgp, "g_prev")
    _tree_equal(tage, jage, "age")
    return jt, tt, (jgp, jage), (tgp, tage)


def _engines(jt, tt, **kw):
    jl = jax_packing.PackedLayout.from_tree(jt)
    tl = packing.PackedLayout.from_tree(tt)
    cfg = dict(policy="fairk", backend="packed", rho=0.1, k_m_frac=0.75,
               **kw)
    return (jax_engine.SelectionEngine(jax_engine.EngineConfig(**cfg),
                                       jl.d_packed, layout=jl),
            engine.SelectionEngine(engine.EngineConfig(**cfg), tl.d_packed,
                                   layout=tl), jl, tl)


@pytest.mark.parametrize("warm", [False, True])
def test_select_and_merge_tree_matches_jax(trees, warm):
    jt, tt, (jgp, jage), (tgp, tage) = trees
    jeng, teng, jl, tl = _engines(jt, tt, warm_start=warm)
    assert (tl.n_leaves, tl.d_packed) == (jl.n_leaves, jl.d_packed) == (
        19, 9_472)
    jts, tts = None, None
    for r in range(3):
        jg, ja, js = jeng.select_and_merge_tree(jt, jgp, jage, tstate=jts)
        tg, ta, ts = teng.select_and_merge_tree(tt, tgp, tage, tstate=tts)
        _tree_equal(tg, jg, f"round {r} g_t")
        _tree_equal(ta, ja, f"round {r} age'")
        _tstate_equal(ts["tstate"], js["tstate"], warm, f"round {r}")
        jts, tts = js["tstate"], ts["tstate"]
        jgp, jage = jg, ja
        tgp, tage = tg, ta


@pytest.mark.parametrize("route", ["legacy", "ef", "fused", "lag"])
def test_persisted_rounds_match_jax(trees, route):
    """Four persisted rounds: only the fresh grads are packed and only g_t
    unpacked; the carried buffers stay flat (bf16 g_prev, int8 age)."""
    jt, tt, (jgp, jage), (tgp, tage) = trees
    fused = route in ("fused", "lag")
    jeng, teng, jl, tl = _engines(jt, tt, warm_start=True,
                                  fused_stats=fused)
    j_gp = jl.pack(jgp).astype(jnp.bfloat16)
    j_age = jl.pack_age(jage).astype(jnp.int8)
    t_gp = tl.pack(tgp).to(torch.bfloat16)
    t_age = tl.pack_age(tage).to(torch.int8)
    _equal(t_age, j_age, "packed age")
    j_res = jnp.zeros(jl.d_packed) if route == "ef" else None
    t_res = torch.zeros(tl.d_packed) if route == "ef" else None
    jts, tts = jax_packing.init_threshold_state(), \
        packing.init_threshold_state("cpu")
    lag = 2 if route == "lag" else None
    rng = np.random.default_rng(3)
    for r in range(4):
        scale = np.float32(1.0 + 0.3 * rng.random())
        jg_tree = jax.tree_util.tree_map(lambda x: x * scale, jt)
        tg_tree = bench._tree_map(lambda x: x * float(scale), tt)
        p0, u0 = packing.PACK_CALLS, packing.UNPACK_CALLS
        g_flat = tl.pack(tg_tree)
        tg, ta, ts = teng.select_and_merge(g_flat, t_gp, t_age, tstate=tts,
                                           residual=t_res, age_lag=lag)
        t_out = tl.unpack(tg, cast=False)
        assert (packing.PACK_CALLS - p0, packing.UNPACK_CALLS - u0) == (1, 1)
        jg, ja, js = jeng.select_and_merge(jl.pack(jg_tree), j_gp, j_age,
                                           tstate=jts, residual=j_res,
                                           age_lag=lag)
        _tree_equal(t_out, jl.unpack(jg, cast=False), f"round {r} g_t")
        _equal(ta, ja, f"round {r} age'")
        _tstate_equal(ts["tstate"], js["tstate"], True, f"round {r}")
        pads = ~to_np(tl.valid_mask("cpu"))
        assert (to_np(ta)[pads] == packing.PAD_AGE).all()
        if lag:
            sel = to_np(ts["sel_mask"]) > 0
            _equal(ts["sel_mask"], js["sel_mask"], "sel_mask")
            assert (to_np(ta)[sel] == lag).all() and not sel[pads].any()
        if route == "ef":
            _equal(ts["residual"], js["residual"], f"round {r} residual")
            assert (to_np(ts["residual"])[pads] == 0.0).all()
            j_res, t_res = js["residual"], ts["residual"]
        j_gp, j_age = jg.astype(jnp.bfloat16), ja.astype(jnp.int8)
        t_gp, t_age = tg.to(torch.bfloat16), ta.to(torch.int8)
        jts, tts = js["tstate"], ts["tstate"]


def test_structural_counters_of_the_smoke():
    """``torch_packed_bench --smoke``: one fused launch against one per
    leaf; 1 pack and 1 unpack per persisted round (3 and 2 re-packing);
    one read of g on the fused, adaptive, async, sanitize, chaos and
    channel rounds against 3 on the legacy round; no row is skipped."""
    res = bench.smoke("cpu")
    assert res["counts_per_leaf"]["fused_calls"] == res["n_leaves"]
    assert res["counts_packed"]["fused_calls"] == 1
    assert (res["counts_persisted"]["packs"],
            res["counts_persisted"]["unpacks"]) == (1, 1)
    assert res["counts_fused_stats"]["g_reads"] == 1
    assert res["counts_persisted"]["g_reads"] == 3
    for row in ("adaptive", "async", "sanitize", "chaos", "channel"):
        assert res[f"counts_{row}"] == res["counts_fused_stats"], row
    assert sorted(res["skipped"]) == []
    assert np.isfinite(res["chaos_us"]) and np.isfinite(res["channel_us"])


def test_async_round_keeps_the_double_buffer(trees):
    """The async builder: the new shadow holds the straggler share, the
    selected coordinates carry the lag, and the optimizer-facing tree is
    last round's ``pending``."""
    _, tt, _, (tgp, tage) = trees
    fn, crit, lay = bench.build_async_fn(tt)
    gp = lay.pack(tgp).to(torch.bfloat16)
    ag = lay.pack_age(tage).to(torch.int8)
    pending = torch.randn(lay.d_packed).to(torch.bfloat16)
    calls = ops.FAIRK_UPDATE_CALLS
    out_tree, g_t, age_next, ts, shadow, pend, sel = fn(
        tt, gp, ag, packing.init_threshold_state("cpu"), gp, pending)
    assert ops.FAIRK_UPDATE_CALLS - calls == 1
    _tree_equal(out_tree, tree_util.unflatten(
        lay.paths, [v for _, v in tree_util.leaves(crit(pending))]),
        "pending")
    assert (age_next.to(torch.float32)[sel > 0] == 1.0).all()
    strag = engine.index_jitter(lay.d_packed) < 0.25
    assert torch.equal(shadow[~strag], torch.zeros_like(shadow[~strag]))
