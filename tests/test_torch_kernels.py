"""The port's kernel functions (plain PyTorch versions, which the CUDA
kernels are held to on the card) against the JAX package's kernels, run
both through ``repro.kernels.ref`` and through the Pallas kernels in
interpret mode.

Exactness: ages, counts, histograms, signs, energies and top-k indices
equal exactly; ``g_t``, ``residual'``, merged values and top-k values
equal bit for bit (NaN where the reference has NaN).  ``aou_merge`` is
held against interpret mode with ages below 119 only: the TPU kernel
leaves out the ``AGE_CAP`` clip that the oracle and the engine apply.  One exception, counted: a magnitude sample within 1e-5 of a
quarter-octave bin edge may land one bin apart if XLA's and torch's CPU
``log2`` differ in the last place.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import (D_KERNEL, edge_samples, fairk_inputs, inject_nonfinite,
                       theta_cases, to_np, to_torch)

from repro.kernels import ops as jax_ops
from repro_torch.core import packing
from repro_torch.kernels import ops, ref

VARIANTS = {
    "base": dict(res=False, fresh=False, sanitize=False),
    "fresh": dict(res=False, fresh=True, sanitize=False),
    "res": dict(res=True, fresh=False, sanitize=False),
    "res_fresh": dict(res=True, fresh=True, sanitize=False),
    "sanitize": dict(res=False, fresh=False, sanitize=True),
    "res_fresh_sanitize": dict(res=True, fresh=True, sanitize=True),
}


def _case(variant: str, seed: int):
    v = VARIANTS[variant]
    x = fairk_inputs(seed)
    if v["sanitize"]:
        x["g"] = inject_nonfinite(x["g"], seed + 1)
        x["fresh"] = inject_nonfinite(x["fresh"], seed + 2, n=5)
    return v, x


def _same_floats(a, b):
    """Equal bit for bit, except that any NaN matches any NaN."""
    a, b = to_np(a), to_np(b)
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    np.testing.assert_array_equal(nan_a, nan_b)
    np.testing.assert_array_equal(a[~nan_a].view(np.uint32),
                                  b[~nan_b].view(np.uint32))


@pytest.mark.parametrize("jax_mode", ["ref", "interpret"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fairk_stats_update_matches_jax(variant, jax_mode):
    v, x = _case(variant, seed=len(variant))
    cases = theta_cases(x["g"], x["age"])
    for tname, (tm, ta) in cases.items():
        kw_np = {"residual": x["residual"] if v["res"] else None,
                 "fresh": x["fresh"] if v["fresh"] else None}
        j = jax_ops.fairk_stats_update(
            jnp.asarray(x["g"]), jnp.asarray(x["g_prev"]),
            jnp.asarray(x["age"]), tm, ta,
            residual=None if kw_np["residual"] is None
            else jnp.asarray(kw_np["residual"]),
            fresh=None if kw_np["fresh"] is None
            else jnp.asarray(kw_np["fresh"]),
            mode=jax_mode, sanitize=v["sanitize"])
        t = ops.fairk_stats_update(
            to_torch(x["g"]), to_torch(x["g_prev"]), to_torch(x["age"]),
            tm, ta,
            residual=None if kw_np["residual"] is None
            else to_torch(kw_np["residual"]),
            fresh=None if kw_np["fresh"] is None
            else to_torch(kw_np["fresh"]),
            sanitize=v["sanitize"])
        _same_floats(t[0], j[0])
        np.testing.assert_array_equal(to_np(t[1]), to_np(j[1]),
                                      err_msg=tname)
        if v["res"]:
            _same_floats(t[2], j[2])
        else:
            assert t[2] is None and j[2] is None
        for key in ("n_sel", "n_sel_m", "age_hist"):
            np.testing.assert_array_equal(to_np(t[3][key]),
                                          to_np(j[3][key]),
                                          err_msg=f"{tname} {key}")
        # magnitude bins: exact unless a sample sits on a bin edge
        score = x["g"] + (x["residual"] if v["res"] else 0.0)
        ok = x["age"] >= 0
        if v["sanitize"]:
            ok = ok & np.isfinite(score)
        n_edge = edge_samples(score, ok)
        diff = np.abs(to_np(t[3]["mag_hist"]) - to_np(j[3]["mag_hist"]))
        assert diff.sum() <= 2 * n_edge, (tname, diff.sum(), n_edge)
        if tname == "zero":
            assert float(t[3]["n_sel"]) == float(ok.sum())
        if tname == "inf_both":
            assert float(t[3]["n_sel"]) == 0.0


@pytest.mark.parametrize("variant", ["base", "res", "res_fresh_sanitize"])
def test_fairk_ef_update_matches_jax(variant):
    v, x = _case(variant, seed=7)
    tm, ta = theta_cases(x["g"], x["age"])["finite"]
    res = x["residual"] if v["res"] else None
    fresh = x["fresh"] if v["fresh"] else None
    j = jax_ops.fairk_ef_update(
        jnp.asarray(x["g"]), jnp.asarray(x["g_prev"]), jnp.asarray(x["age"]),
        tm, ta, residual=None if res is None else jnp.asarray(res),
        fresh=None if fresh is None else jnp.asarray(fresh),
        mode="interpret", sanitize=v["sanitize"])
    t = ops.fairk_ef_update(
        to_torch(x["g"]), to_torch(x["g_prev"]), to_torch(x["age"]), tm, ta,
        residual=None if res is None else to_torch(res),
        fresh=None if fresh is None else to_torch(fresh),
        sanitize=v["sanitize"])
    _same_floats(t[0], j[0])
    np.testing.assert_array_equal(to_np(t[1]), to_np(j[1]))
    if v["res"]:
        _same_floats(t[2], j[2])


def test_pads_and_age_cap():
    x = fairk_inputs(3)
    g_t, age_next, _ = ref.fairk_ef_update_ref(
        to_torch(x["g"]), to_torch(x["g_prev"]), to_torch(x["age"]),
        torch.tensor(float("inf")), torch.tensor(float("inf")))
    age_next = to_np(age_next)
    pads = x["age"] < 0
    np.testing.assert_array_equal(age_next[pads], -1.0)
    assert age_next[~pads].max() == packing.AGE_CAP
    np.testing.assert_array_equal(to_np(g_t), x["g_prev"])


def test_knuth_jitter_matches_jax():
    from repro.core.engine import jitter_from_ids as jax_jitter
    from repro_torch.core.engine import jitter_from_ids
    ids = np.concatenate([np.arange(0, 70000, 7),
                          np.array([2**24 - 1, 2**24, 2**31 - 1, 2**31,
                                    2**32 - 1])]).astype(np.int64)
    np.testing.assert_array_equal(
        to_np(jitter_from_ids(torch.as_tensor(ids))),
        np.asarray(jax_jitter(jnp.asarray(ids.astype(np.uint32)))))


def _votes(n: int, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, k)).astype(np.float32)
    v[rng.random((n, k)) < 0.05] = 0.0
    v[rng.random((n, k)) < 0.05] = -0.0
    v[0, :7] = np.nan
    return v


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("jax_mode", ["ref", "interpret"])
@pytest.mark.parametrize("n", [1, 4, 7])
def test_sign_mv_matches_jax(n, jax_mode, noisy):
    votes = _votes(n, D_KERNEL, seed=n)
    if n % 2 == 0:
        votes = np.where(np.isnan(votes), votes, np.sign(votes)
                         ).astype(np.float32)
    noise = (np.random.default_rng(1).normal(size=D_KERNEL).astype(np.float32)
             if noisy else None)
    k = D_KERNEL
    jn = None if noise is None else jnp.asarray(noise[:k])
    js, je = jax_ops.sign_mv(jnp.asarray(votes[:, :k]), noise=jn,
                             mode=jax_mode)
    ts, te = ops.sign_mv(to_torch(votes[:, :k]),
                         noise=None if noise is None else to_torch(noise[:k]))
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    np.testing.assert_array_equal(to_np(te), np.asarray(je))


def test_sign_mv_signed_zero_votes_count_plus_one():
    votes = torch.tensor([[0.0, -0.0, -1.0, float("nan")],
                          [-0.0, -0.0, -1.0, 1.0]])
    signs, energy = ops.sign_mv(votes)
    np.testing.assert_array_equal(to_np(energy), [2.0, 2.0, -2.0, 0.0])
    np.testing.assert_array_equal(to_np(signs), [1.0, 1.0, -1.0, 1.0])


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("jax_mode", ["ref", "interpret"])
def test_sign_from_energy_matches_jax(jax_mode, noisy):
    rng = np.random.default_rng(5)
    k = D_KERNEL
    e = (2.0 * rng.integers(-5, 6, size=k)).astype(np.float32)
    e[:5] = [0.0, -0.0, np.nan, np.inf, -np.inf]
    noise = rng.normal(size=k).astype(np.float32) if noisy else None
    js, je = jax_ops.sign_from_energy(
        jnp.asarray(e), noise=None if noise is None else jnp.asarray(noise),
        mode=jax_mode)
    ts, te = ops.sign_from_energy(
        to_torch(e), noise=None if noise is None else to_torch(noise))
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    _same_floats(te, je)


def _fold_inputs(n: int, k: int, seed: int):
    """A chunk's (n, k) effective gradients with NaN, ±0.0 and ±inf, and
    a non-zero accumulator of arbitrary floats."""
    rng = np.random.default_rng(seed)
    eff = rng.normal(size=(n, k)).astype(np.float32)
    eff[rng.random((n, k)) < 0.05] = 0.0
    eff[rng.random((n, k)) < 0.05] = -0.0
    eff[0, :6] = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0]
    eff[-1, 6:9] = [np.nan, np.inf, -0.0]
    acc = (rng.normal(size=k) * 7.0).astype(np.float32)
    acc[:3] = [0.0, -0.0, 3.0]
    return eff, acc


@pytest.mark.parametrize("jax_mode", ["ref", "interpret"])
@pytest.mark.parametrize("n", [1, 4, 7])
def test_vote_fold_matches_jax_sign_mv(n, jax_mode):
    """The packed one-bit fold: ``acc + sign_mv(one_bit(eff))[1]`` as the
    JAX trainer's ``fold_votes`` computes it, in place."""
    from repro.core import quantize as jax_quantize
    eff, acc = _fold_inputs(n, D_KERNEL, seed=10 + n)
    j = jnp.asarray(acc) + jax_ops.sign_mv(
        jax_quantize.one_bit(jnp.asarray(eff)), mode=jax_mode)[1]
    acc_t = to_torch(acc)
    out = ops.vote_fold(acc_t, to_torch(eff))
    assert out is acc_t
    _same_floats(acc_t, j)


@pytest.mark.parametrize("n", [1, 4, 7])
def test_vote_fold_gathered_matches_jax(n):
    """The exact one-bit fold at an unsorted selection, repeated
    coordinates and a selection of one included."""
    from repro.core import quantize as jax_quantize
    eff, _ = _fold_inputs(n, D_KERNEL, seed=20 + n)
    rng = np.random.default_rng(n)
    for idx in (rng.permutation(D_KERNEL)[:1000], np.array([3]),
                np.array([7, 0, 7, D_KERNEL - 1])):
        acc = (rng.normal(size=idx.shape[0]) * 3.0).astype(np.float32)
        j = jnp.asarray(acc) + jax_quantize.one_bit(
            jnp.asarray(eff)[:, jnp.asarray(idx)]).sum(axis=0)
        acc_t = to_torch(acc)
        ops.vote_fold(acc_t, to_torch(eff), to_torch(idx))
        _same_floats(acc_t, j)


def _energy_and_draw(k: int, seed: int):
    rng = np.random.default_rng(seed)
    e = (2.0 * rng.integers(-5, 6, size=k)).astype(np.float32)
    e[:5] = [0.0, -0.0, np.nan, np.inf, -np.inf]
    z = rng.normal(size=k).astype(np.float32)
    z[5:8] = [0.0, -0.0, np.nan]
    return e, z


@pytest.mark.parametrize("jax_mode", ["ref", "interpret"])
@pytest.mark.parametrize("noise_std", [0.0, 0.1, 2.0])
def test_sign_from_energy_of_a_draw_matches_jax(noise_std, jax_mode):
    """The detection fed the draw ``z`` and ``noise_std``: the energy is
    ``energy + noise_std * z`` (the product rounded first), as
    ``repro.core.quantize`` computes it, and the signs follow."""
    e, z = _energy_and_draw(D_KERNEL, seed=int(10 * noise_std))
    je = jnp.asarray(e)
    if noise_std > 0.0:
        je = je + noise_std * jnp.asarray(z)
    js, je_out = jax_ops.sign_from_energy(je, mode=jax_mode)
    ts, te = ops.sign_from_energy(to_torch(e), z=to_torch(z),
                                  noise_std=noise_std)
    _same_floats(te, je)
    _same_floats(te, je_out)
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))


@pytest.mark.parametrize("noise_std", [0.0, 2.0])
def test_sign_from_energy_score_matches_jax(noise_std):
    """The packed path's score ``|energy| + index_jitter(d)``."""
    from repro.core import engine as jax_engine
    e, z = _energy_and_draw(D_KERNEL, seed=3)
    noise = jnp.asarray(noise_std * z) if noise_std > 0.0 else None
    js, je = jax_ops.sign_from_energy(jnp.asarray(e), noise=noise,
                                      mode="interpret")
    j_score = jnp.abs(je) + jax_engine.index_jitter(D_KERNEL)
    ts, te, t_score = ops.sign_from_energy(
        to_torch(e), z=to_torch(z), noise_std=noise_std, score=True)
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    _same_floats(te, je)
    _same_floats(t_score, j_score)


def test_sign_from_energy_takes_one_kind_of_noise():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="not both"):
        ops.sign_from_energy(x, x, z=x, noise_std=1.0)
    with pytest.raises(ValueError, match="needs a noise draw z"):
        ops.sign_from_energy(x, noise_std=1.0)
    # noise_std 0 leaves the draw out, as the call sites always did
    z = torch.full((8,), float("nan"))
    _same_floats(ops.sign_from_energy(x, z=z)[1], x)


def test_kernel_mode_on_cpu_raises():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.sign_from_energy(x, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.vote_fold(x, x[None], mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.aou_merge(x, x, x, x, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.block_topk(x, 4, 2, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fairk_stats_update(x, x, x, 0.0, 0.0, mode="kernel")
    with pytest.raises(ValueError, match="mode"):
        ops.sign_mv(x[None], mode="pallas")


def test_counters_count_dispatches_not_cpu_launches():
    from repro_torch.kernels import aou_merge, block_topk, fairk_update
    from repro_torch.kernels import sign_mv
    before = (ops.FAIRK_UPDATE_CALLS, packing.G_READS,
              fairk_update.LAUNCHES, sign_mv.SIGN_MV_LAUNCHES,
              sign_mv.SIGN_FROM_ENERGY_LAUNCHES, aou_merge.LAUNCHES,
              block_topk.LAUNCHES)
    x = torch.zeros(16)
    ops.fairk_stats_update(x, x, x, 0.0, 0.0)
    ops.sign_mv(x[None])
    ops.vote_fold(x.clone(), x[None])
    ops.sign_from_energy(x, z=x, noise_std=1.0, score=True)
    ops.aou_merge(x, x, x, x)
    ops.two_stage_topk(x, 3, block_size=8)
    after = (ops.FAIRK_UPDATE_CALLS, packing.G_READS,
             fairk_update.LAUNCHES, sign_mv.SIGN_MV_LAUNCHES,
             sign_mv.SIGN_FROM_ENERGY_LAUNCHES, aou_merge.LAUNCHES,
             block_topk.LAUNCHES)
    assert after == (before[0] + 1, before[1] + 1) + before[2:]


def _merge_inputs(d: int, seed: int, max_age: int):
    """(g_new, g_old, age, mask): ±0.0, NaN and ±Inf values in g_new, a
    float mask of 0/1 with a few fractional entries."""
    rng = np.random.default_rng(seed)
    g_new = rng.normal(size=d).astype(np.float32)
    g_new[rng.choice(d, 20, replace=False)] = -0.0
    g_new[:3] = [np.nan, np.inf, -np.inf]
    g_old = rng.normal(size=d).astype(np.float32)
    g_old[rng.choice(d, 20, replace=False)] = -0.0
    age = rng.integers(0, max_age + 1, size=d).astype(np.float32)
    mask = (rng.random(d) < 0.3).astype(np.float32)
    mask[rng.choice(d, 10, replace=False)] = 0.5
    return g_new, g_old, age, mask


@pytest.mark.parametrize("jax_mode", ["ref", "interpret"])
@pytest.mark.parametrize("d", [D_KERNEL, 65_536])
def test_aou_merge_matches_jax(d, jax_mode):
    # ages below 119: the TPU kernel (interpret) leaves out the AGE_CAP clip
    args = _merge_inputs(d, seed=d, max_age=118)
    j = jax_ops.aou_merge(*(jnp.asarray(a) for a in args), mode=jax_mode)
    t = ops.aou_merge(*(to_torch(a) for a in args))
    _same_floats(t[0], j[0])
    _same_floats(t[1], j[1])


def test_aou_merge_clips_at_the_cap_as_the_oracle_and_engine():
    from repro.core import engine as jax_engine
    d = 3001                                     # ragged
    g_new, g_old, age, mask = _merge_inputs(d, seed=4, max_age=130)
    age[:4] = [119.0, 120.0, 121.0, np.nan]
    mask[:4] = 0.0
    t = ops.aou_merge(to_torch(g_new), to_torch(g_old), to_torch(age),
                      to_torch(mask))
    j_ref = jax_ops.aou_merge(jnp.asarray(g_new), jnp.asarray(g_old),
                              jnp.asarray(age), jnp.asarray(mask),
                              mode="ref")
    j_eng = jax_engine.masked_merge(jnp.asarray(g_new), jnp.asarray(g_old),
                                    jnp.asarray(age), jnp.asarray(mask))
    for j in (j_ref, j_eng):
        _same_floats(t[0], j[0])
        _same_floats(t[1], j[1])
    assert float(np.nanmax(to_np(t[1]))) == packing.AGE_CAP
    assert np.isnan(to_np(t[1])[3])


def _topk_input(d: int, seed: int) -> np.ndarray:
    """Finite values with injected ties: repeated magnitudes of both signs
    inside and across blocks, and runs of exact zeros."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=d).astype(np.float32)
    x[rng.choice(d, d // 10, replace=False)] = 1.5
    x[rng.choice(d, d // 10, replace=False)] = -1.5
    x[rng.choice(d, d // 20, replace=False)] = 0.0
    x[rng.choice(d, d // 20, replace=False)] = -0.0
    return x


@pytest.mark.parametrize("jax_mode", ["ref", "interpret"])
@pytest.mark.parametrize("d,bs,m", [(4096, 512, 8), (8192, 1024, 40),
                                    (3000, 1000, 1), (2048, 256, 256)])
def test_block_topk_matches_jax(d, bs, m, jax_mode):
    x = _topk_input(d, seed=d + m)
    jv, ji = jax_ops.block_topk(jnp.asarray(x), bs, m, mode=jax_mode)
    tv, ti = ops.block_topk(to_torch(x), bs, m)
    assert tv.shape == (d // bs, m) and ti.dtype == torch.int32
    _same_floats(tv, jv)
    np.testing.assert_array_equal(to_np(ti), np.asarray(ji))


@pytest.mark.parametrize("k,bs,m", [(40, 512, None), (300, 1024, None),
                                    (100, 256, 4)])
def test_two_stage_topk_matches_jax(k, bs, m):
    x = _topk_input(8192, seed=k)
    jv, ji = jax_ops.two_stage_topk(jnp.asarray(x), k, block_size=bs, m=m,
                                    mode="interpret")
    tv, ti = ops.two_stage_topk(to_torch(x), k, block_size=bs, m=m)
    _same_floats(tv, jv)
    np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
    if m is None:
        # exact here: the global stable-sort top-k of |x|
        order = torch.sort(to_torch(np.abs(x)), descending=True,
                           stable=True).indices[:k]
        np.testing.assert_array_equal(to_np(ti), to_np(order))


def test_global_topk_from_candidates_matches_jax():
    rng = np.random.default_rng(9)
    vals = np.sort(rng.integers(0, 6, size=(16, 8)).astype(np.float32),
                   axis=1)[:, ::-1].copy()
    idxs = rng.permutation(16 * 8).astype(np.int32).reshape(16, 8)
    for k in (1, 17, 128):
        jv, ji = jax_ops.global_topk_from_candidates(jnp.asarray(vals),
                                                     jnp.asarray(idxs), k)
        tv, ti = ops.global_topk_from_candidates(to_torch(vals),
                                                 to_torch(idxs), k)
        _same_floats(tv, jv)
        np.testing.assert_array_equal(to_np(ti), np.asarray(ji))


def _topk_edge_input(kind: str, d: int, bs: int) -> np.ndarray:
    """``_topk_input`` plus NaNs of both signs, infinities of both signs,
    or whole blocks of one magnitude (the first of -2.5, the second of
    zeros)."""
    x = _topk_input(d, seed=d + bs)
    rng = np.random.default_rng(d - bs)
    if kind == "nan":
        x[rng.choice(d, d // 50, replace=False)] = np.nan
        x[rng.choice(d, d // 50, replace=False)] = -np.nan
    elif kind == "inf":
        x[rng.choice(d, d // 50, replace=False)] = np.inf
        x[rng.choice(d, d // 50, replace=False)] = -np.inf
    elif kind == "equal":
        x[:bs] = -2.5
        x[bs:2 * bs] = 0.0
    return x


def test_block_topk_ranks_nan_first_as_jax():
    x = np.array([1.0, np.nan, 3.0, -np.nan, 3.0, 0.0, -0.0, 2.0],
                 np.float32)
    tv, ti = ops.block_topk(to_torch(x), 8, 5)
    np.testing.assert_array_equal(to_np(ti), [[1, 3, 2, 4, 7]])
    for jax_mode in ("ref", "interpret"):
        jv, ji = jax_ops.block_topk(jnp.asarray(x), 8, 5, mode=jax_mode)
        np.testing.assert_array_equal(np.asarray(ji), [[1, 3, 2, 4, 7]])
        _same_floats(tv, jv)


@pytest.mark.parametrize("jax_mode", ["ref", "interpret"])
@pytest.mark.parametrize("kind", ["nan", "inf", "equal"])
@pytest.mark.parametrize("d,bs,m", [(2048, 512, 8), (2048, 512, 1),
                                    (1024, 256, 256), (1024, 512, 37)])
def test_block_topk_edge_values_match_jax(d, bs, m, kind, jax_mode):
    x = _topk_edge_input(kind, d, bs)
    jv, ji = jax_ops.block_topk(jnp.asarray(x), bs, m, mode=jax_mode)
    tv, ti = ops.block_topk(to_torch(x), bs, m)
    _same_floats(tv, jv)
    np.testing.assert_array_equal(to_np(ti), np.asarray(ji))


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("variant", ["base", "res_fresh_sanitize"])
def test_fairk_thresholds_as_floats_or_tensors(variant, stats):
    v, x = _case(variant, seed=13)
    tm, ta = theta_cases(x["g"], x["age"])["finite"]
    args = [to_torch(x[k]) for k in ("g", "g_prev", "age")]
    kw = dict(residual=to_torch(x["residual"]) if v["res"] else None,
              fresh=to_torch(x["fresh"]) if v["fresh"] else None,
              sanitize=v["sanitize"], mode="plain")
    fn = ops.fairk_stats_update if stats else ops.fairk_ef_update
    as_float = fn(*args, float(tm), float(ta), **kw)
    as_tensor = fn(*args, torch.tensor(tm, dtype=torch.float32),
                   torch.tensor(ta, dtype=torch.float32), **kw)
    for a, b in zip(as_float[:3], as_tensor[:3]):
        if a is None:
            assert b is None
        else:
            _same_floats(a, b)
    if stats:
        for key in ("n_sel", "n_sel_m", "mag_hist", "age_hist"):
            assert as_float[3][key].dtype == torch.float32
            _same_floats(as_float[3][key], as_tensor[3][key])


def test_block_topk_shape_checks():
    x = torch.zeros(1000)
    with pytest.raises(ValueError, match="divisible"):
        ops.block_topk(x, 256, 4)
    with pytest.raises(ValueError, match="m="):
        ops.block_topk(x, 500, 501)
    with pytest.raises(ValueError, match="divisible"):
        ops.two_stage_topk(x, 10, block_size=4096)
