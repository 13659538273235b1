"""The port's threshold route against the JAX package's: the strided
sample, the sampled quantiles (``jnp.quantile``'s arithmetic, static and
traced split), the sampled and order-statistic thresholds, the threshold
backend's ``select_and_merge`` (fused statistics on and off), the legacy
packed backend over 8 rounds from no carried state, and ``exact_theta``
against exact FAIR-k.

Tolerances: thresholds, merged values, ages, counts, histograms,
residuals and every threshold-state entry equal bit for bit (noise 0);
``torch.quantile`` would not do (it differs from ``jnp.quantile`` in the
last place on a fifth of these samples).  Where a test says so: the
carried θ of the legacy warm route and the compiled warm correction
within one ulp, ``g_t`` with channel noise within four."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import fairk_inputs, inject_nonfinite, to_np, to_torch

from repro.core import engine as jax_engine
from repro.core import packing as jax_packing
from repro.core import selection as jax_selection
from repro_torch.core import engine, packing
from repro_torch.models.cnn import params_from_numpy


def _bits_equal(t, j, what=""):
    t, j = to_np(t), np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, (what, t.dtype, j.dtype)
    if t.dtype == np.float32:
        np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(t, j, err_msg=what)


@pytest.mark.parametrize("n,cap", [(1, 4), (10, 3), (5000, 1000),
                                   (109_210, 65_536), (70_001, 64)])
def test_strided_sample_matches_jax(n, cap):
    x = np.arange(n, dtype=np.float32)
    _bits_equal(engine.strided_sample(to_torch(x), cap),
                jax_engine.strided_sample(jnp.asarray(x), cap))


@pytest.mark.parametrize("k_m_frac", [0.75, 0.0, 1.0, 0.3])
@pytest.mark.parametrize("n", [1, 2, 999, 65_536, 109_210])
def test_thresholds_from_samples_bit_for_bit(n, k_m_frac):
    """Static split (a float) and the traced one (a 0-d float32), eager
    and under ``jax.jit``; ``k_m_frac`` 0 and 1 switch a stage off."""
    rng = np.random.default_rng(n)
    mag = np.abs(rng.standard_t(3, size=n) * rng.random()).astype(
        np.float32)
    age = (rng.integers(0, 60, size=n)
           + rng.random(n)).astype(np.float32)
    for rho in (0.1, 0.2, 0.37):
        jm, ja = jax_engine.thresholds_from_samples(
            jnp.asarray(mag), jnp.asarray(age), rho=rho, k_m_frac=k_m_frac)
        tm, ta = engine.thresholds_from_samples(
            to_torch(mag), to_torch(age), rho=rho, k_m_frac=k_m_frac)
        _bits_equal(tm, jm, "static theta_m")
        _bits_equal(ta, ja, "static theta_a")
        kmf = np.float32(k_m_frac)
        jit = jax.jit(lambda a, b, f, rho=rho:
                      jax_engine.thresholds_from_samples(a, b, rho=rho,
                                                         k_m_frac=f))
        for jm, ja in (jax_engine.thresholds_from_samples(
                jnp.asarray(mag), jnp.asarray(age), rho=rho,
                k_m_frac=jnp.float32(kmf)),
                jit(jnp.asarray(mag), jnp.asarray(age), jnp.float32(kmf))):
            tm, ta = engine.thresholds_from_samples(
                to_torch(mag), to_torch(age), rho=rho,
                k_m_frac=torch.tensor(kmf))
            _bits_equal(tm, jm, "traced theta_m")
            _bits_equal(ta, ja, "traced theta_a")


def test_quantile_propagates_nan_as_jnp_does():
    x = np.array([3.0, np.nan, 1.0, 2.0], np.float32)
    for q in (0.0, 0.5, 1.0):
        _bits_equal(engine.quantile(to_torch(x), q),
                    jnp.quantile(jnp.asarray(x), q))
    x = np.array([1.0, np.inf, -np.inf, 2.0], np.float32)
    for q in (0.0, 0.4, 0.99, 1.0):
        _bits_equal(engine.quantile(to_torch(x), q),
                    jnp.quantile(jnp.asarray(x), q))


@pytest.mark.parametrize("ids", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("sanitize", [False, True])
@pytest.mark.parametrize("traced", [False, True])
def test_sampled_thresholds_bit_for_bit(ids, residual, sanitize, traced):
    x = fairk_inputs(3, 20_000)
    g = inject_nonfinite(x["g"], 4) if sanitize else x["g"]
    kw = dict(rho=0.1, sample_cap=4096, sanitize=sanitize)
    kmf = np.float32(0.6)
    j_kw = dict(kw, k_m_frac=jnp.float32(kmf) if traced else 0.6)
    t_kw = dict(kw, k_m_frac=torch.tensor(kmf) if traced else 0.6)
    if ids:
        sid = np.arange(3, 20_000, 7)
        j_kw["sample_ids"] = sid.astype(np.int32)
        t_kw["sample_ids"] = torch.as_tensor(sid)
    if residual:
        j_kw["residual"] = jnp.asarray(x["residual"])
        t_kw["residual"] = to_torch(x["residual"])
    jm, ja = jax_engine.sampled_thresholds(jnp.asarray(g),
                                           jnp.asarray(x["age"]), **j_kw)
    reads = packing.G_READS
    tm, ta = engine.sampled_thresholds(to_torch(g), to_torch(x["age"]),
                                       **t_kw)
    assert packing.G_READS == reads + 1
    _bits_equal(tm, jm, "theta_m")
    _bits_equal(ta, ja, "theta_a")
    assert np.isfinite(to_np(tm)) or not sanitize


@pytest.mark.parametrize("k,k_m", [(500, 375), (500, 0), (500, 500),
                                   (5000, 2500), (20_000, 100)])
@pytest.mark.parametrize("sanitize", [False, True])
def test_exact_thresholds_bit_for_bit(k, k_m, sanitize):
    x = fairk_inputs(7, 20_000)
    g = inject_nonfinite(x["g"], 8) if sanitize else x["g"]
    jm, ja = jax_engine.exact_thresholds(jnp.asarray(g),
                                         jnp.asarray(x["age"]), k=k, k_m=k_m,
                                         sanitize=sanitize)
    tm, ta = engine.exact_thresholds(to_torch(g), to_torch(x["age"]), k=k,
                                     k_m=k_m, sanitize=sanitize)
    _bits_equal(tm, jm, "theta_m")
    _bits_equal(ta, ja, "theta_a")
    jdm, jda = jax_engine.exact_thresholds_dynamic(
        jnp.asarray(g), jnp.asarray(x["age"]), k=k, k_m=jnp.int32(k_m),
        sanitize=sanitize)
    tdm, tda = engine.exact_thresholds_dynamic(
        to_torch(g), to_torch(x["age"]), k=k, k_m=torch.tensor(k_m),
        sanitize=sanitize)
    _bits_equal(tdm, jdm, "dynamic theta_m")
    _bits_equal(tda, jda, "dynamic theta_a")


# The threshold backend's reference runs eagerly: a compiled program may
# contract the quantile's other product into the FMA (seen inside a
# jitted ``sampled_thresholds`` with a residual), one ulp off the
# standalone ``jnp.quantile`` the port follows.  Only compiled does the
# reference turn the traced split's ``k_M / k`` into a product with 1/k,
# as the port does: a budget k that is a power of two makes both exact.
_K_TRACED = 256


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("variant", ["plain", "ef", "fresh", "sanitize",
                                     "traced", "exact_theta", "topk",
                                     "lag"])
def test_threshold_backend_select_and_merge(fused, variant):
    d = 6000
    x = fairk_inputs(21, d)
    kw = dict(policy="topk" if variant == "topk" else "fairk",
              backend="threshold", rho=0.1, k_m_frac=0.75, sample_cap=2048,
              fused_stats=fused, exact_theta=variant == "exact_theta",
              k=_K_TRACED if variant == "traced" else None)
    jeng = jax_engine.SelectionEngine(jax_engine.EngineConfig(**kw), d)
    teng = engine.SelectionEngine(engine.EngineConfig(**kw), d)
    assert jeng.budgets() == teng.budgets()
    g = inject_nonfinite(x["g"], 22) if variant == "sanitize" else x["g"]
    j_kw, t_kw = {}, {}
    if variant == "ef":
        j_kw["residual"] = jnp.asarray(x["residual"])
        t_kw["residual"] = to_torch(x["residual"])
    if variant == "fresh":
        j_kw["fresh"] = jnp.asarray(x["fresh"])
        t_kw["fresh"] = to_torch(x["fresh"])
    if variant == "sanitize":
        j_kw["sanitize"] = t_kw["sanitize"] = True
    if variant == "traced":
        j_kw["k_m_frac"] = jnp.float32(0.55)
        t_kw["k_m_frac"] = torch.tensor(np.float32(0.55))
    if variant == "lag":
        j_kw["age_lag"] = t_kw["age_lag"] = 3
    jg, ja, js = jeng.select_and_merge(jnp.asarray(g),
                                       jnp.asarray(x["g_prev"]),
                                       jnp.asarray(x["age"]), **j_kw)
    tg, ta, ts = teng.select_and_merge(to_torch(g), to_torch(x["g_prev"]),
                                       to_torch(x["age"]), **t_kw)
    _bits_equal(tg, jg, "g_t")
    _bits_equal(ta, ja, "age'")
    assert set(ts) == set(js)
    for key in js:
        if key != "k":
            _bits_equal(ts[key], js[key], key)
    assert ts["k"] == js["k"]


def _tree_np(seed):
    """A small multi-leaf tree: pads between every leaf."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (300,), "b": {"w": (17, 40), "u": (5,)}, "c": (1024,)}

    def fill(s):
        return ({k: fill(v) for k, v in s.items()} if isinstance(s, dict)
                else rng.standard_t(3, size=s).astype(np.float32))
    return fill(shapes)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("traced", [False, True])
def test_legacy_packed_backend_eight_rounds(warm, ef, traced):
    """No fused statistics: sampled-quantile bootstrap from ``tstate =
    None``, the warm trust region, the two-pass counts — every carried
    state entry (the streak included), ages, merged values and the
    residual identical for 8 rounds on a padded multi-leaf buffer.  With
    ``warm_start`` the carried θ_M and θ_A agree within one ulp: the
    reference runs the bootstrap inside ``lax.cond``, a compiled branch
    whose quantile may contract the other product into the FMA, and its
    eager warm correction divides by k_M and k_A where the compiled one
    (and the port) multiplies by their float32 reciprocals — exact here,
    where k_M = k_A = 128."""
    tree = _tree_np(0)
    jl = jax_packing.PackedLayout.from_tree(
        jax.tree_util.tree_map(jnp.asarray, tree))
    tl = packing.PackedLayout.from_tree(params_from_numpy(tree))
    # warm_alpha 1: the eager reference computes the default power 0.5
    # with pow, the compiled one (and the port) as a square root — held
    # apart in test_warm_power_is_the_compiled_one
    kw = dict(backend="packed", rho=0.1, k_m_frac=0.5, sample_cap=512,
              warm_start=warm, warm_streak=1, warm_tol=0.5, warm_alpha=1.0,
              k=_K_TRACED)
    jeng = jax_engine.SelectionEngine(jax_engine.EngineConfig(**kw),
                                      jl.d_packed, layout=jl)
    teng = engine.SelectionEngine(engine.EngineConfig(**kw), tl.d_packed,
                                  layout=tl)
    assert jeng.budgets() == teng.budgets()
    rng = np.random.default_rng(1)
    j_gp = jnp.zeros(jl.d_packed)
    # ages spread as in a steady state (uniform over ~1/rho rounds), so
    # the warm predictor's streak can build within 8 rounds
    j_age = jnp.where(jl.valid_mask(), jnp.asarray(
        rng.integers(0, 10, jl.d_packed).astype(np.float32)),
        jax_packing.PAD_AGE)
    j_res = jnp.zeros(jl.d_packed)
    t_gp, t_age, t_res = to_torch(j_gp), to_torch(j_age), to_torch(j_res)
    jts = tts = None
    warm_rounds = 0
    for r in range(8):
        g_np = np.asarray(jl.pack(jax.tree_util.tree_map(
            lambda v: jnp.asarray(v * (1.0 + 0.1 * r)
                                  + 0.01 * rng.normal(size=v.shape)
                                  .astype(np.float32)), tree)))
        j_kw, t_kw = {"tstate": jts}, {"tstate": tts}
        if ef:
            j_kw["residual"], t_kw["residual"] = j_res, t_res
        if traced:
            f = np.float32(0.5 + 0.05 * r)
            j_kw["k_m_frac"], t_kw["k_m_frac"] = jnp.float32(f), \
                torch.tensor(f)
        jg, j_age, js = jeng.select_and_merge(jnp.asarray(g_np), j_gp,
                                              j_age, **j_kw)
        tg, t_age, ts = teng.select_and_merge(to_torch(g_np), t_gp, t_age,
                                              **t_kw)
        _bits_equal(tg, jg, f"round {r} g_t")
        _bits_equal(t_age, j_age, f"round {r} age'")
        for key in js["tstate"]:
            if warm and key in ("theta_m", "theta_a"):
                # see the docstring: the warm rounds' thresholds within
                # one ulp
                np.testing.assert_array_max_ulp(
                    to_np(ts["tstate"][key]), np.asarray(js["tstate"][key]),
                    maxulp=1)
                continue
            _bits_equal(ts["tstate"][key], js["tstate"][key],
                        f"round {r} tstate.{key}")
        pads = ~to_np(tl.valid_mask("cpu"))
        assert (to_np(t_age)[pads] == packing.PAD_AGE).all()
        if ef:
            _bits_equal(ts["residual"], js["residual"], f"round {r} res")
            j_res, t_res = js["residual"], ts["residual"]
        j_gp, t_gp = jg, tg
        jts, tts = js["tstate"], ts["tstate"]
        warm_rounds += int(float(to_np(tts["streak"])) >= 1)
    if warm and not traced:
        assert warm_rounds > 0          # the warm branch was reached


def test_warm_power_is_the_compiled_one():
    """The warm correction's ``(n_m / k_m) ** 0.5``: the compiled reference
    computes the power of an array as the correctly rounded square root
    — so does the port (``packing._pow``), bit for bit; torch's ``pow``
    at 0.5 would differ in the last place on about 1% of these values."""
    x = (np.random.default_rng(5).random(100_000) * 4).astype(np.float32)
    j = np.asarray(jax.jit(lambda v: v ** 0.5)(jnp.asarray(x)))
    t = to_np(packing._pow(to_torch(x), 0.5))
    np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))
    assert (to_np(to_torch(x) ** 0.5) != j).sum() > 0


@pytest.mark.parametrize("traced", [False, True])
def test_warm_correction_matches_the_compiled_reference(traced):
    """``warm_corrected_thresholds`` against the compiled reference (as its
    callers run it): within one ulp, and equal on at least 99% of the
    draws — XLA's scalar ``pow`` at 0.5 is one ulp off ``sqrt`` on a few
    values in a thousand."""
    rng = np.random.default_rng(4)
    k, exact, n = 5000, 0, 200
    for _ in range(n):
        ts = {"theta_m": np.float32(rng.random() * 0.1),
              "theta_a": np.float32(rng.integers(0, 30) + rng.random()),
              "n_sel_m": np.float32(rng.integers(0, 2 * k)),
              "n_sel": np.float32(rng.integers(0, 3 * k)),
              "init": np.float32(1.0), "streak": np.float32(2.0)}
        k_m = int(rng.integers(1, k))
        jfn = jax.jit(lambda t, km: jax_packing.warm_corrected_thresholds(
            t, k=k, k_m=km if traced else k_m))
        jm, ja = jfn({key: jnp.asarray(v) for key, v in ts.items()},
                     jnp.int32(k_m))
        tm, ta = packing.warm_corrected_thresholds(
            {key: torch.tensor(v) for key, v in ts.items()}, k=k,
            k_m=torch.tensor(k_m, dtype=torch.int32) if traced else k_m)
        for t, j in ((tm, jm), (ta, ja)):
            np.testing.assert_array_max_ulp(to_np(t), np.asarray(j),
                                            maxulp=1)
        exact += int(to_np(tm) == np.asarray(jm)
                     and to_np(ta) == np.asarray(ja))
    assert exact >= 0.99 * n, exact


@pytest.mark.parametrize("backend", ["threshold", "packed"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_theta_selects_what_exact_fairk_selects(backend, seed):
    """On tie-free inputs (distinct magnitudes, distinct ages) the
    order-statistic thresholds select exactly the exact FAIR-k set, in
    both packages (as ``tests/test_threshold_vs_exact.py``)."""
    d = 1 << 13
    rng = np.random.default_rng(seed)
    g = rng.normal(size=d).astype(np.float32)
    age = rng.permutation(d).astype(np.float32)
    kw = dict(backend=backend, rho=0.1, k_m_frac=0.75, exact_theta=True)
    lay = (packing.PackedLayout.from_tree(torch.zeros(d), lane=1)
           if backend == "packed" else None)
    teng = engine.SelectionEngine(engine.EngineConfig(**kw), d, layout=lay)
    k, k_m, _ = teng.budgets()
    _, t_age, _ = teng.select_and_merge(to_torch(g), torch.zeros(d),
                                        to_torch(age))
    exact_idx = np.asarray(jax_selection.fair_k_indices(
        jnp.asarray(g), jnp.asarray(age), k=k, k_m=k_m))
    want = np.zeros(d, bool)
    want[exact_idx] = True
    np.testing.assert_array_equal(to_np(t_age) == 0.0, want)
    jeng = jax_engine.make_engine("fairk", "threshold", d=d, rho=0.1,
                                  k_m_frac=0.75, exact_theta=True)
    _, j_age, _ = jeng.select_and_merge(jnp.asarray(g), jnp.zeros(d),
                                        jnp.asarray(age))
    np.testing.assert_array_equal(np.asarray(j_age) == 0.0, want)


def test_make_engine_and_budgets_on_padded_buffers():
    tree = params_from_numpy(_tree_np(3))
    lay = packing.PackedLayout.from_tree(tree)
    eng = engine.make_engine("fairk", "packed", layout=lay, rho=0.1)
    assert eng.d == lay.d_packed and eng.d_budget == lay.d_valid
    jl = jax_packing.PackedLayout.from_tree(
        jax.tree_util.tree_map(jnp.asarray, _tree_np(3)))
    assert eng.budgets() == jax_engine.make_engine(
        "fairk", "packed", layout=jl, rho=0.1).budgets()
    with pytest.raises(ValueError, match="needs d"):
        engine.make_engine("fairk", "exact")


@pytest.mark.parametrize("sanitize", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_no_residual_fairk_update_matches_jax(seed, sanitize):
    """``ops.fairk_update`` (no residual, no ``fresh``; on the CPU the plain
    version) against ``repro.kernels.ops.fairk_update`` in ``ref`` mode
    and its oracle ``fairk_update_ref``: bit for bit, pads included."""
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref
    from repro_torch.kernels import ops, ref
    x = fairk_inputs(seed, 5000)
    g = inject_nonfinite(x["g"], seed) if sanitize else x["g"]
    for tm, ta in ((0.0, 0.0), (0.12, 60.5), (float("inf"), 40.5)):
        jg, ja = jax_ops.fairk_update(jnp.asarray(g),
                                      jnp.asarray(x["g_prev"]),
                                      jnp.asarray(x["age"]), tm, ta,
                                      mode="ref", sanitize=sanitize)
        calls = ops.FAIRK_UPDATE_CALLS
        tg, ta_ = ops.fairk_update(to_torch(g), to_torch(x["g_prev"]),
                                   to_torch(x["age"]), tm, ta,
                                   sanitize=sanitize)
        assert ops.FAIRK_UPDATE_CALLS == calls + 1
        _bits_equal(tg, jg, "g_t")
        _bits_equal(ta_, ja, "age'")
        rg, ra = ref.fairk_update_ref(to_torch(g), to_torch(x["g_prev"]),
                                      to_torch(x["age"]), torch.tensor(tm),
                                      torch.tensor(ta), sanitize=sanitize)
        jrg, jra = jax_ref.fairk_update_ref(
            jnp.asarray(g), jnp.asarray(x["g_prev"]), jnp.asarray(x["age"]),
            jnp.float32(tm), jnp.float32(ta), sanitize=sanitize)
        _bits_equal(rg, jrg, "ref g_t")
        _bits_equal(ra, jra, "ref age'")


@pytest.mark.parametrize("fused", [False, True])
def test_threshold_backend_channel_noise(fused):
    """With channel noise the selected coordinates get ``noise_std / N ·
    z`` after the kernel, ``z`` the reference's draw from the round key:
    ages and counts exact, ``g_t`` within a few ulps (XLA folds the scale
    into its draw — ROADMAP Queue 3)."""
    d = 6000
    x = fairk_inputs(23, d)
    kw = dict(backend="threshold", rho=0.1, k_m_frac=0.75, sample_cap=2048,
              fused_stats=fused, noise_std=0.3, n_clients=7)
    jeng = jax_engine.SelectionEngine(jax_engine.EngineConfig(**kw), d)
    teng = engine.SelectionEngine(engine.EngineConfig(**kw), d)
    key = jax.random.PRNGKey(5)
    z = np.asarray(jax.random.normal(key, (d,), jnp.float32))
    jg, ja, js = jeng.select_and_merge(jnp.asarray(x["g"]),
                                       jnp.asarray(x["g_prev"]),
                                       jnp.asarray(x["age"]), key=key)
    tg, ta, ts = teng.select_and_merge(to_torch(x["g"]),
                                       to_torch(x["g_prev"]),
                                       to_torch(x["age"]), noise=to_torch(z))
    _bits_equal(ta, ja, "age'")
    _bits_equal(ts["n_selected"], js["n_selected"], "n_selected")
    np.testing.assert_array_max_ulp(to_np(tg), np.asarray(jg), maxulp=4)
    with pytest.raises(ValueError, match="noise"):
        teng.select_and_merge(to_torch(x["g"]), to_torch(x["g_prev"]),
                              to_torch(x["age"]))
