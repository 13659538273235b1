"""The port's packing statistics and selection engine against the JAX
package: histogram thresholds, warm-corrected thresholds, six rounds of
packed ``select_and_merge`` carrying the threshold state, six rounds of
the exact backend's ``select_and_merge`` for every policy, and the exact
FAIR-k engine's staleness law.

Tolerances: ages equal exactly; on the packed backend thresholds, merged
values and counts within rtol 1e-6 (the two libraries' ``exp2``/``pow``
may differ in the last place).  The exact backend has no threshold math:
``g_t`` and the residual equal bit for bit, ages, histograms and counts
exactly.  The staleness pmf over 600 rounds lies within TV 0.1 of Lemma 1
(the suite-standard tolerance of ``tests/statutil.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import statutil
import torch
from torchutil import engine_draws, fairk_inputs, to_np, to_torch

from repro.core import markov

from repro.core import engine as jax_engine
from repro.core import packing as jax_packing
from repro_torch.core import engine, packing


def _hists(seed):
    rng = np.random.default_rng(seed)
    mag = rng.integers(0, 50, size=128).astype(np.float32)
    mag[:20] = 0.0
    age = rng.integers(0, 200, size=128).astype(np.float32)
    age[60:] = 0.0
    return mag, age


@pytest.mark.parametrize("rho,k_m_frac", [(0.1, 0.75), (0.2, 0.5),
                                          (0.1, 0.0), (0.1, 1.0),
                                          (0.05, 0.9)])
@pytest.mark.parametrize("seed", [0, 1])
def test_hist_thresholds_match_jax(rho, k_m_frac, seed):
    mag, age = _hists(seed)
    jm, ja = jax_packing.hist_thresholds(jnp.asarray(mag), jnp.asarray(age),
                                         rho=rho, k_m_frac=k_m_frac)
    tm, ta = packing.hist_thresholds(to_torch(mag), to_torch(age), rho=rho,
                                     k_m_frac=k_m_frac)
    np.testing.assert_allclose(to_np(tm), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(to_np(ta), np.asarray(ja), rtol=1e-6)


def test_hist_thresholds_empty_is_full_refresh():
    z = torch.zeros(128)
    tm, ta = packing.hist_thresholds(z, z, rho=0.1, k_m_frac=0.75)
    assert float(tm) == 0.0 and float(ta) == 0.0


@pytest.mark.parametrize("k,k_m", [(1000, 750), (1000, 0), (1000, 1000)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warm_corrected_thresholds_match_jax(k, k_m, seed):
    rng = np.random.default_rng(seed)
    ts_np = {"theta_m": np.float32(rng.random() * 0.1),
             "theta_a": np.float32(rng.integers(0, 30) + rng.random()),
             "n_sel_m": np.float32(rng.integers(0, 2 * k)),
             "n_sel": np.float32(rng.integers(0, 3 * k)),
             "init": np.float32(1.0), "streak": np.float32(2.0)}
    if seed == 2:
        ts_np["theta_m"] = np.float32(np.inf)
    jm, ja = jax_packing.warm_corrected_thresholds(
        {k2: jnp.asarray(v) for k2, v in ts_np.items()}, k=k, k_m=k_m)
    tm, ta = packing.warm_corrected_thresholds(
        {k2: torch.tensor(v) for k2, v in ts_np.items()}, k=k, k_m=k_m)
    np.testing.assert_allclose(to_np(tm), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(to_np(ta), np.asarray(ja), rtol=1e-6)


def test_hist_stride_bins_and_advance_match_jax():
    for d in (1, 5000, 65_535, 65_536, 109_210, 10**6, 10**9):
        assert packing.hist_stride(d) == jax_packing.hist_stride(d)
    mags = np.array([0.0, -0.0, 1e-30, 2.0**-24, 0.1, 1.0, 3.0, 255.9, 1e9,
                     np.inf], np.float32)
    np.testing.assert_array_equal(
        to_np(packing.mag_bin(to_torch(np.abs(mags)))),
        np.asarray(jax_packing.mag_bin(jnp.asarray(np.abs(mags)))))
    ages = np.array([-1.0, 0.0, 0.5, 7.0, 120.0, 130.0], np.float32)
    np.testing.assert_array_equal(
        to_np(packing.age_bin(to_torch(ages))),
        np.asarray(jax_packing.age_bin(jnp.asarray(ages))))
    _, age_hist = _hists(3)
    age_hist[-1] = 5.0
    np.testing.assert_array_equal(
        to_np(packing.advance_age_hist(to_torch(age_hist))),
        np.asarray(jax_packing.advance_age_hist(jnp.asarray(age_hist))))


def _engines(d, noise_std, policy="fairk"):
    kw = dict(policy=policy, backend="packed", rho=0.1, k_m_frac=0.75,
              noise_std=noise_std, n_clients=4, fused_stats=True,
              warm_start=True)
    jeng = jax_engine.SelectionEngine(
        jax_engine.EngineConfig(**kw), d,
        layout=jax_packing.PackedLayout.from_tree(
            [jnp.zeros((d,), jnp.float32)], lane=1))
    teng = engine.SelectionEngine(engine.EngineConfig(**kw), d,
                                  layout=packing.PackedLayout.from_tree(
                                      torch.zeros(d), lane=1))
    return jeng, teng


@pytest.mark.parametrize("mode", ["coherent_noise", "ef", "fresh",
                                  "sanitize", "topk", "roundrobin"])
def test_packed_select_and_merge_six_rounds(mode):
    d = 4000
    noise_std = 0.3 if mode == "coherent_noise" else 0.0
    policy = mode if mode in ("topk", "roundrobin") else "fairk"
    jeng, teng = _engines(d, noise_std, policy)
    assert jeng.budgets() == teng.budgets()
    jts = jax_packing.init_threshold_state()
    tts = packing.init_threshold_state("cpu")
    x = fairk_inputs(11, d)
    j_gp = t_gp = np.zeros(d, np.float32)
    j_age = np.zeros(d, np.float32)
    j_res = np.zeros(d, np.float32)
    t_gp, t_age, t_res = to_torch(j_gp), to_torch(j_age), to_torch(j_res)
    j_gp, j_age, j_res = (jnp.asarray(a) for a in (j_gp, j_age, j_res))
    rng = np.random.default_rng(5)
    for r in range(6):
        g = (x["g"] * (1.0 + 0.2 * r)
             + 0.05 * rng.normal(size=d)).astype(np.float32)
        if mode == "sanitize" and r in (2, 3):
            g[rng.choice(d, 50, replace=False)] = np.nan
        key = jax.random.PRNGKey(r)
        z = np.asarray(jax.random.normal(key, (d,), jnp.float32))
        fresh = np.sign(g).astype(np.float32) if mode == "fresh" else None
        kw_j = dict(tstate=jts, key=key, sanitize=mode == "sanitize")
        kw_t = dict(tstate=tts, noise=to_torch(z),
                    sanitize=mode == "sanitize")
        if mode == "ef":
            kw_j["residual"], kw_t["residual"] = j_res, t_res
        if fresh is not None:
            kw_j["fresh"], kw_t["fresh"] = jnp.asarray(fresh), to_torch(fresh)
        jg, ja, js = jeng.select_and_merge(jnp.asarray(g), j_gp, j_age,
                                           **kw_j)
        tg, ta, tst = teng.select_and_merge(to_torch(g), t_gp, t_age, **kw_t)
        np.testing.assert_array_equal(to_np(ta), np.asarray(ja),
                                      err_msg=f"round {r} ages")
        np.testing.assert_allclose(to_np(tg), np.asarray(jg), rtol=1e-6,
                                   atol=1e-7, err_msg=f"round {r} g_t")
        for key_name in ("theta_m", "theta_a", "n_selected", "n_sel_m"):
            np.testing.assert_allclose(to_np(tst[key_name]),
                                       np.asarray(js[key_name]), rtol=1e-6,
                                       err_msg=f"round {r} {key_name}")
        for key_name in ("mag_hist", "age_hist"):
            np.testing.assert_array_equal(to_np(tst[key_name]),
                                          np.asarray(js[key_name]))
        np.testing.assert_array_equal(to_np(tst["tstate"]["streak"]),
                                      np.asarray(js["tstate"]["streak"]))
        if mode == "ef":
            np.testing.assert_allclose(to_np(tst["residual"]),
                                       np.asarray(js["residual"]),
                                       rtol=1e-6, atol=1e-7)
            j_res, t_res = js["residual"], tst["residual"]
        if r == 0:
            assert float(tst["n_selected"]) == d   # θ = 0: full refresh
        jts, tts = js["tstate"], tst["tstate"]
        j_gp, j_age, t_gp, t_age = jg, ja, tg, ta


def _same_floats(a, b, what):
    a, b = to_np(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    ok = ~np.isnan(a)
    np.testing.assert_array_equal(a[ok].view(np.uint32),
                                  b[ok].view(np.uint32), err_msg=what)


EXACT_MODES = {
    # mode: (policy, noise_std, residual, fresh, sanitize)
    "coherent_noise": ("fairk", 0.3, False, False, False),
    "ef": ("fairk", 0.0, True, False, False),
    "fresh": ("fairk", 0.0, False, True, False),
    "sanitize": ("fairk", 0.3, True, True, True),
    "topk": ("topk", 0.3, False, False, False),
    "roundrobin": ("roundrobin", 0.0, False, False, False),
    "toprand": ("toprand", 0.3, True, False, False),
    "agetopk": ("agetopk", 0.0, False, False, False),
    "randk": ("randk", 0.3, False, False, False),
}


@pytest.mark.parametrize("mode", list(EXACT_MODES))
def test_exact_select_and_merge_six_rounds(mode):
    policy, noise_std, use_res, use_fresh, sanitize = EXACT_MODES[mode]
    d = 3000
    kw = dict(policy=policy, backend="exact", rho=0.1, k_m_frac=0.75,
              noise_std=noise_std, n_clients=4, fused_stats=True)
    jeng = jax_engine.SelectionEngine(jax_engine.EngineConfig(**kw), d)
    teng = engine.SelectionEngine(engine.EngineConfig(**kw), d)
    assert jeng.budgets() == teng.budgets()
    x = fairk_inputs(13, d)
    rng = np.random.default_rng(6)
    zeros = np.zeros(d, np.float32)
    j_gp, j_age, j_res = (jnp.asarray(zeros) for _ in range(3))
    t_gp, t_age, t_res = (to_torch(zeros) for _ in range(3))
    for r in range(6):
        g = (np.abs(x["g"]) * (1.0 + 0.2 * r) * np.sign(rng.normal(size=d))
             + 0.05 * rng.normal(size=d)).astype(np.float32)
        if sanitize and r in (2, 3):
            g[rng.choice(d, 50, replace=False)] = np.nan
            g[rng.choice(d, 5, replace=False)] = np.inf
        key = jax.random.PRNGKey(100 + r)
        draws = engine_draws(key, d)
        fresh = np.sign(g).astype(np.float32)
        if sanitize:
            fresh[rng.choice(d, 7, replace=False)] = np.nan
        kw_j = dict(key=key, sanitize=sanitize)
        kw_t = dict(noise=to_torch(draws["noise"]), u=to_torch(draws["u"]),
                    sanitize=sanitize)
        if use_res:
            kw_j["residual"], kw_t["residual"] = j_res, t_res
        if use_fresh:
            kw_j["fresh"], kw_t["fresh"] = (jnp.asarray(fresh),
                                            to_torch(fresh))
        jg, ja, js = jeng.select_and_merge(jnp.asarray(g), j_gp, j_age,
                                           **kw_j)
        tg, ta, tst = teng.select_and_merge(to_torch(g), t_gp, t_age, **kw_t)
        np.testing.assert_array_equal(to_np(ta), np.asarray(ja),
                                      err_msg=f"round {r} ages")
        _same_floats(tg, jg, f"round {r} g_t")
        if "idx" in js:
            np.testing.assert_array_equal(to_np(tst["idx"]),
                                          np.asarray(js["idx"]))
        for key_name in ("n_selected", "n_sel_m", "mag_hist", "age_hist"):
            np.testing.assert_array_equal(
                to_np(tst[key_name]), np.asarray(js[key_name]),
                err_msg=f"round {r} {key_name}")
        if use_res:
            _same_floats(tst["residual"], js["residual"],
                         f"round {r} residual")
            j_res, t_res = js["residual"], tst["residual"]
        j_gp, j_age, t_gp, t_age = jg, ja, tg, ta


def test_exact_fairk_staleness_follows_lemma1():
    """600 rounds of the exact FAIR-k engine on iid N(0, 1) scores: the
    time-averaged post-update age pmf (150 rounds of burn-in) against
    Lemma 1's stationary law on the same (d, k, k_m) chain."""
    d, k, k_m = 512, 64, 32
    eng = engine.SelectionEngine(engine.EngineConfig(
        policy="fairk", backend="exact", k=k, k_m=k_m, fused_stats=True), d)
    rng = np.random.default_rng(0)
    g_prev = torch.zeros(d)
    age = torch.zeros(d)
    acc = np.zeros(128)
    for r in range(600):
        g = torch.as_tensor(rng.normal(size=d).astype("f4"))
        g_prev, age, stats = eng.select_and_merge(g, g_prev, age)
        if r >= 150:
            acc += to_np(stats["age_hist"])
    k0 = int(round(k_m * (1 - k_m / d)))
    support, pred = markov.aou_distribution(
        markov.FairKChain(d=d, k=k, k_m=k_m, k0=k0))
    statutil.assert_pmf_close(acc, support, pred, tv_tol=0.1,
                              mean_rtol=0.1)


def test_engine_rejects_what_is_not_ported():
    lay = packing.PackedLayout.from_tree(torch.zeros(16), lane=1)
    z = torch.zeros(16)
    exact = engine.SelectionEngine(engine.EngineConfig(backend="exact"), 16)
    g_t, age, stats = exact.select_and_merge(z, z, z)
    assert float(stats["n_selected"]) == exact.budgets()[0]
    # the sharded launch path is not ported (ROADMAP Queue 1 item 11)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 item 11"):
        engine.SelectionEngine(engine.EngineConfig(backend="sharded"), 16)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 item 11"):
        engine.SelectionEngine(engine.EngineConfig(
            backend="packed", reduce_axes=("data",)), 16, layout=lay)
    with pytest.raises(ValueError, match="PackedLayout"):
        engine.SelectionEngine(engine.EngineConfig(backend="packed"), 16)
    with pytest.raises(ValueError, match="index arithmetic"):
        engine.SelectionEngine(engine.EngineConfig(
            backend="packed", policy="randk", fused_stats=True,
            warm_start=True), 16, layout=lay)
    # the threshold backend, the legacy packed route, the bootstrap without
    # a carried state (item 3) and async lag (item 7) are ported
    eng = engine.SelectionEngine(engine.EngineConfig(
        backend="packed", fused_stats=True, warm_start=True), 16, layout=lay)
    thr = engine.SelectionEngine(engine.EngineConfig(backend="threshold"), 16)
    legacy = engine.SelectionEngine(engine.EngineConfig(backend="packed"),
                                    16, layout=lay)
    for e in (eng, legacy, thr, exact):
        e.select_and_merge(z, z, z)
        with pytest.raises(ValueError, match="age_lag"):
            e.select_and_merge(z, z, z, age_lag=-1)
        _, age2, stats = e.select_and_merge(
            z, z, z, tstate=packing.init_threshold_state("cpu"), age_lag=2)
        assert torch.equal(age2[stats["sel_mask"] > 0],
                           torch.full_like(age2[stats["sel_mask"] > 0], 2.0))
        # the traced split is ported (ROADMAP Queue 1 item 5)
        e.select_and_merge(z, z, z, tstate=packing.init_threshold_state(
            "cpu"), k_m_frac=torch.tensor(0.5))
    rand = engine.SelectionEngine(engine.EngineConfig(backend="exact",
                                                      policy="randk"), 16)
    with pytest.raises(ValueError, match="uniform draw"):
        rand.select_and_merge(z, z, z)
    with pytest.raises(ValueError, match="sanitize"):
        rand.select_and_merge(z, z, z, u=z, sanitize=True)
