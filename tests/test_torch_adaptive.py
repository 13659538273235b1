"""The adaptive split through the port — the traced-split selection stack
and the trainer's ``adaptive_km`` / ``fairk_auto`` routes — against the
JAX package, its functions compiled with ``jax.jit`` as the trainer's
round compiles them.

* ``traced_km``, ``rank_desc``, ``fair_k_masks_dynamic`` and the
  sync-free ``mask_to_indices``: exactly, on ties (``f·k = 2.5``), ±0.0,
  NaN and the age stage's −1 sentinel.
* ``select_and_merge(k_m_frac=…)`` for six rounds, the split moving every
  round: on the exact backend (rank form, with and without ``sanitize``)
  ages, selected indices, histograms and counts exactly and ``g_t`` and
  the residual bit for bit without receiver noise; with noise ``g_t``
  within rtol 1e-6 / atol 1e-7 (XLA folds the noise scale into its
  in-graph draw); on the packed backend ages and histograms exactly,
  thresholds, counts and ``g_t`` within rtol 1e-6 (as the static packed
  test: the libraries' ``exp2``/``pow`` may differ in the last place).
* ``train`` with ``adaptive_km=True`` for 8 rounds (the controller acts at
  round 5) on the exact coherent, exact one-bit and packed coherent routes
  of ``torchutil.small_fl_task``, each side with its own clients and the
  JAX draws: ages equal on at least 99.9% of the coordinates, ``w`` within
  atol 1e-5 (a flipped one-bit vote moves a coordinate by 2·lr = 0.006:
  the one-bit route allows that on at most 0.1% of the coordinates),
  ``km_frac`` and the controller's ``k_m_frac`` within atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import (engine_draws, exact_round_draws, fairk_inputs,
                       round_draws, run_jax_rounds, small_fl_task, to_np,
                       to_torch, torch_loss, torch_params)

from repro.core import engine as jax_engine
from repro.core import oac as jax_oac
from repro.core import packing as jax_packing
from repro.fl import trainer as jax_trainer
from repro_torch.core import engine, oac, packing
from repro_torch.fl import trainer


def _bits_equal(a, b, what):
    a, b = to_np(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    ok = ~np.isnan(a)
    np.testing.assert_array_equal(a[ok].view(np.uint32),
                                  b[ok].view(np.uint32), err_msg=what)


# --- the traced-split stack ------------------------------------------------

@pytest.mark.parametrize("k", [1, 5, 7, 10, 64, 1001])
def test_traced_km_rounds_half_to_even_like_jax(k):
    fracs = np.array([-0.5, 0.0, 0.05, 0.1, 0.15, 0.25, 0.35, 0.5, 0.7,
                      0.75, 0.85, 0.95, 1.0, 1.5], np.float32)
    fracs = np.concatenate([fracs, (np.arange(2 * k + 1) / (2 * k))
                            .astype(np.float32)])
    j = jax.jit(jax.vmap(lambda f: jax_engine.traced_km(k, f)))(
        jnp.asarray(fracs))
    t = engine.traced_km(k, to_torch(fracs))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(to_np(t), np.asarray(j))
    # the half-way ties: 2.5 -> 2 and 3.5 -> 4, as jnp.round
    assert int(engine.traced_km(10, torch.tensor(0.25))) == 2
    assert int(engine.traced_km(10, torch.tensor(0.35))) == 4


def _tie_vector(seed, d=257):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=d).astype(np.float32)   # heavy ties
    x[rng.choice(d, 20, replace=False)] = 0.0
    x[rng.choice(d, 20, replace=False)] = -0.0
    x[rng.choice(d, 5, replace=False)] = -1.0
    return x


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("nan", [False, True])
def test_rank_desc_matches_jax_on_ties_and_signed_zeros(seed, nan):
    x = _tie_vector(seed)
    if nan:
        x[[3, 50, 200]] = np.nan
    np.testing.assert_array_equal(
        to_np(engine.rank_desc(to_torch(x))),
        np.asarray(jax.jit(jax_engine.rank_desc)(jnp.asarray(x))))
    # each row of a block ranks as the row alone
    block = np.stack([x, x[::-1].copy()])
    rows = to_np(engine.rank_desc(to_torch(block)))
    np.testing.assert_array_equal(rows[1], to_np(engine.rank_desc(
        to_torch(block[1]))))


@pytest.mark.parametrize("k,k_m", [(40, 0), (40, 13), (40, 40), (257, 100),
                                   (1, 1), (1, 0)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fair_k_masks_dynamic_match_jax(seed, k, k_m):
    score = np.abs(_tie_vector(seed))
    age = np.abs(_tie_vector(seed + 10))           # ages tie too, ±0.0
    jf = jax.jit(lambda s, a, km: jax_engine.fair_k_masks_dynamic(
        s, a, k, km))
    jm, jmm = jf(jnp.asarray(score), jnp.asarray(age), jnp.int32(k_m))
    for km in (k_m, torch.tensor(k_m, dtype=torch.int32)):
        tm, tmm = engine.fair_k_masks_dynamic(to_torch(score), to_torch(age),
                                              k, km)
        _bits_equal(tm, jm, "mask")
        _bits_equal(tmm, jmm, "mask_m")
    assert float(tm.sum()) == k and float(tmm.sum()) == k_m
    idx = engine.mask_to_indices(tm, k)
    np.testing.assert_array_equal(
        to_np(idx), np.asarray(jnp.nonzero(jm, size=k, fill_value=0)[0]))
    # the rank form picks the index form's coordinate set
    eng = engine.SelectionEngine(engine.EngineConfig(k=k, k_m=k_m), 257)
    assert set(to_np(eng.select(to_torch(score),
                                to_torch(age)))) == set(to_np(idx))


def test_select_traced_is_the_trainer_selection():
    g = fairk_inputs(3, 1000)["g"]
    age = np.random.default_rng(0).integers(0, 9, 1000).astype(np.float32)
    eng = engine.SelectionEngine(engine.EngineConfig(rho=0.1), 1000)
    k = eng.budgets()[0]
    for f in (0.0, 0.33, 0.75, 1.0):
        idx = eng.select_traced(to_torch(g), to_torch(age), torch.tensor(f))
        km = jax_engine.traced_km(k, jnp.float32(f))
        jm, _ = jax_engine.fair_k_masks_dynamic(jnp.abs(jnp.asarray(g)),
                                                jnp.asarray(age), k, km)
        np.testing.assert_array_equal(
            to_np(idx), np.asarray(jnp.nonzero(jm, size=k)[0]))
        assert idx.dtype == torch.int64


# --- select_and_merge with a traced split ---------------------------------

FRACS = (0.75, 0.5, 0.2, 0.9, 0.0, 1.0)

EXACT_MODES = {
    # mode: (noise_std, residual, fresh, sanitize)
    "plain": (0.0, False, False, False),
    "ef": (0.0, True, False, False),
    "fresh": (0.0, False, True, False),
    "noise": (0.3, False, False, False),
    "sanitize": (0.0, True, True, True),
    "sanitize_noise": (0.3, True, False, True),
}


@pytest.mark.parametrize("mode", list(EXACT_MODES))
def test_exact_select_and_merge_with_a_traced_split(mode):
    noise_std, use_res, use_fresh, sanitize = EXACT_MODES[mode]
    d = 3000
    kw = dict(policy="fairk", backend="exact", rho=0.1, k_m_frac=0.75,
              noise_std=noise_std, n_clients=4, fused_stats=True)
    jeng = jax_engine.SelectionEngine(jax_engine.EngineConfig(**kw), d)
    teng = engine.SelectionEngine(engine.EngineConfig(**kw), d)

    @jax.jit
    def jstep(g, gp, age, key, kmf, res, fresh):
        return jeng.select_and_merge(g, gp, age, key=key, k_m_frac=kmf,
                                     residual=res, fresh=fresh,
                                     sanitize=sanitize)

    x = fairk_inputs(21, d)
    rng = np.random.default_rng(4)
    zeros = np.zeros(d, np.float32)
    j_gp = j_age = j_res = jnp.asarray(zeros)
    t_gp = t_age = t_res = to_torch(zeros)
    for r, f in enumerate(FRACS):
        g = (np.abs(x["g"]) * (1.0 + 0.2 * r) * np.sign(rng.normal(size=d))
             + 0.05 * rng.normal(size=d)).astype(np.float32)
        if sanitize and r in (2, 3):
            g[rng.choice(d, 50, replace=False)] = np.nan
            g[rng.choice(d, 5, replace=False)] = np.inf
        key = jax.random.PRNGKey(200 + r)
        draws = engine_draws(key, d)
        fresh = np.sign(g).astype(np.float32) if use_fresh else None
        js = jstep(jnp.asarray(g), j_gp, j_age, key, jnp.float32(f),
                   j_res if use_res else None,
                   None if fresh is None else jnp.asarray(fresh))
        jg, ja, jst = js
        tg, ta, tst = teng.select_and_merge(
            to_torch(g), t_gp, t_age, noise=to_torch(draws["noise"]),
            residual=t_res if use_res else None,
            fresh=None if fresh is None else to_torch(fresh),
            k_m_frac=torch.tensor(f), sanitize=sanitize)
        np.testing.assert_array_equal(to_np(ta), np.asarray(ja),
                                      err_msg=f"round {r} ages")
        if noise_std:
            np.testing.assert_allclose(to_np(tg), np.asarray(jg), rtol=1e-6,
                                       atol=1e-7, err_msg=f"round {r} g_t")
        else:
            _bits_equal(tg, jg, f"round {r} g_t")
        assert int(tst["k_m"]) == int(jst["k_m"])
        for key_name in ("n_selected", "n_sel_m", "mag_hist", "age_hist"):
            np.testing.assert_array_equal(
                to_np(tst[key_name]), np.asarray(jst[key_name]),
                err_msg=f"round {r} {key_name}")
        if use_res:
            _bits_equal(tst["residual"], jst["residual"],
                        f"round {r} residual")
            j_res, t_res = jst["residual"], tst["residual"]
        j_gp, j_age, t_gp, t_age = jg, ja, tg, ta


@pytest.mark.parametrize("mode", ["coherent", "noise", "ef", "fresh"])
def test_packed_select_and_merge_with_a_traced_split(mode):
    d = 4000
    noise_std = 0.3 if mode == "noise" else 0.0
    kw = dict(policy="fairk", backend="packed", rho=0.1, k_m_frac=0.75,
              noise_std=noise_std, n_clients=4, fused_stats=True,
              warm_start=True)
    jeng = jax_engine.SelectionEngine(
        jax_engine.EngineConfig(**kw), d,
        layout=jax_packing.PackedLayout.from_tree(
            [jnp.zeros((d,), jnp.float32)], lane=1))
    teng = engine.SelectionEngine(engine.EngineConfig(**kw), d,
                                  layout=packing.PackedLayout.from_tree(
                                      torch.zeros(d), lane=1))

    @jax.jit
    def jstep(g, gp, age, key, kmf, ts, res, fresh):
        return jeng.select_and_merge(g, gp, age, key=key, k_m_frac=kmf,
                                     tstate=ts, residual=res, fresh=fresh)

    jts = jax_packing.init_threshold_state()
    tts = packing.init_threshold_state("cpu")
    x = fairk_inputs(11, d)
    zeros = np.zeros(d, np.float32)
    j_gp = j_age = j_res = jnp.asarray(zeros)
    t_gp = t_age = t_res = to_torch(zeros)
    rng = np.random.default_rng(5)
    for r, f in enumerate(FRACS):
        g = (x["g"] * (1.0 + 0.2 * r)
             + 0.05 * rng.normal(size=d)).astype(np.float32)
        key = jax.random.PRNGKey(r)
        z = np.asarray(jax.random.normal(key, (d,), jnp.float32))
        fresh = np.sign(g).astype(np.float32) if mode == "fresh" else None
        jg, ja, js = jstep(jnp.asarray(g), j_gp, j_age, key, jnp.float32(f),
                           jts, j_res if mode == "ef" else None,
                           None if fresh is None else jnp.asarray(fresh))
        tg, ta, tst = teng.select_and_merge(
            to_torch(g), t_gp, t_age, noise=to_torch(z), tstate=tts,
            residual=t_res if mode == "ef" else None,
            fresh=None if fresh is None else to_torch(fresh),
            k_m_frac=torch.tensor(f))
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
        jts, tts = js["tstate"], tst["tstate"]
        j_gp, j_age, t_gp, t_age = jg, ja, tg, ta


@pytest.mark.parametrize("f", [0.0, 0.3, 0.75, 1.0])
def test_traced_thresholds_match_jax(f):
    rng = np.random.default_rng(2)
    mag = rng.integers(0, 50, 128).astype(np.float32)
    age = rng.integers(0, 200, 128).astype(np.float32)
    j = jax.jit(lambda m, a, kf: jax_packing.hist_thresholds(
        m, a, rho=0.1, k_m_frac=kf))(jnp.asarray(mag), jnp.asarray(age),
                                     jnp.float32(f))
    t = packing.hist_thresholds(to_torch(mag), to_torch(age), rho=0.1,
                                k_m_frac=torch.tensor(f))
    for a, b in zip(t, j):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6)
    ts = {"theta_m": torch.tensor(0.3), "theta_a": torch.tensor(7.25),
          "n_sel_m": torch.tensor(70.0), "n_sel": torch.tensor(101.0)}
    k = 100
    km = engine.traced_km(k, torch.tensor(f))
    jw = jax.jit(lambda t_, kmj: jax_packing.warm_corrected_thresholds(
        t_, k=k, k_m=kmj))({n: jnp.asarray(to_np(v)) for n, v in ts.items()},
                           jnp.asarray(to_np(km)))
    tw = packing.warm_corrected_thresholds(ts, k=k, k_m=km)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6)


def test_a_traced_split_moves_fairk_only():
    eng = engine.SelectionEngine(engine.EngineConfig(policy="topk"), 64)
    z = torch.zeros(64)
    with pytest.raises(ValueError, match="FAIR-k split only"):
        eng.select_and_merge(z, z, z, k_m_frac=torch.tensor(0.5))


# --- the trainer's adaptive routes ----------------------------------------

ROUNDS = 8


@pytest.fixture(scope="module")
def task():
    return small_fl_task(ROUNDS)


def _pair(backend, one_bit, policy="fairk"):
    kw = dict(n_clients=4, local_steps=2, batch_size=3, local_lr=0.05,
              global_lr=0.05, rounds=ROUNDS, backend=backend,
              client_chunk=2, compression_ratio=0.2, seed=0, policy=policy,
              adaptive_km=True, one_bit=one_bit)
    ch = dict(fading="rayleigh", mean=1.0, noise_std=0.1)
    if one_bit:
        kw.update(local_lr=0.003, global_lr=0.003)
        ch = dict(fading="none", mean=1.0, noise_std=2.0)
    return (jax_trainer.FLConfig(channel=jax_oac.ChannelConfig(**ch), **kw),
            trainer.FLConfig(channel=oac.ChannelConfig(**ch), **kw))


@pytest.mark.parametrize("backend,one_bit", [("exact", False),
                                             ("exact", True),
                                             ("packed", False)])
def test_adaptive_rounds_track_the_jax_trainer(task, backend, one_bit):
    params, batches = task
    jfl, tfl = _pair(backend, one_bit)
    if backend == "exact":
        draws_fn = lambda key, d: exact_round_draws(key, jfl, d)  # noqa
    else:
        draws_fn = lambda key, d: round_draws(key, jfl.n_clients, d,  # noqa
                                              jfl.channel)
    jax_rounds, d = run_jax_rounds(jfl, params, batches, draws_fn)
    state, unravel = trainer.init_server(torch_params(params), tfl,
                                         device="cpu")
    step = trainer.make_fl_step(tfl, unravel, torch_loss, d, device="cpu")
    w, g, age, sc = state.w, state.g, state.age, state.sel_count
    res, ts, cs = state.residual, state.theta, state.ctrl
    moved = False
    for t, rnd in enumerate(jax_rounds):
        xs, ys = batches[t]
        draws = {k: to_torch(v) for k, v in rnd["draws"].items()}
        w, g, age, sc, res, _, ts, cs, m = step(
            w, g, age, sc, to_torch(xs), to_torch(ys), res, ts, draws, cs)
        jw, _, jage, _, _, _ = rnd["after"]
        agree = float((to_np(age) == np.asarray(jage)).mean())
        assert agree >= 0.999, f"round {t}: ages agree on {agree:.5f}"
        dw = np.abs(to_np(w) - np.asarray(jw))
        if one_bit:
            assert (dw > 1e-5).mean() <= 1e-3 and dw.max() <= 0.0125
        else:
            assert dw.max() <= 1e-5, f"round {t}: max |dw| {dw.max()}"
        assert abs(float(m["km_frac"])
                   - float(rnd["metrics"]["km_frac"])) <= 1e-6
        for key in ("k_m_frac", "prev_step"):
            assert abs(float(cs[key]) - float(rnd["ctrl"][key])) <= 1e-6
        for key in ("init", "tick"):
            assert float(cs[key]) == float(rnd["ctrl"][key])
        moved |= float(cs["k_m_frac"]) != tfl.k_m_frac
        if backend == "exact":
            assert float(m["n_selected"]) == tfl.budgets(d)[0]
    assert moved, "the controller never moved the split in 8 rounds"


@pytest.mark.parametrize("backend", ["exact", "packed"])
def test_fairk_auto_trains_and_reports_km_frac(task, backend):
    params, batches = task
    _, tfl = _pair(backend, False, policy="fairk_auto")
    tfl = dataclasses.replace(tfl, adaptive_km=False)
    assert tfl.adaptive
    hist = trainer.train(tfl, torch_params(params), torch_loss,
                         lambda t: batches[t % ROUNDS], device="cpu")
    c = tfl.controller
    assert len(hist["km_frac"]) == ROUNDS
    assert all(c.min_frac <= f <= c.max_frac for f in hist["km_frac"])
    assert hist["km_frac"][0] == pytest.approx(0.75)
    st = hist["state"]
    assert float(st.ctrl["init"]) == 1.0
    assert torch.isfinite(st.w).all()


def test_adaptive_needs_fairk_and_the_controller_state(task):
    params, _ = task
    _, tfl = _pair("exact", False)
    with pytest.raises(ValueError, match="adaptive_km"):
        trainer.make_fl_step(dataclasses.replace(tfl, policy="topk"),
                             lambda w: w, torch_loss, 8, device="cpu")
    state, unravel = trainer.init_server(torch_params(params), tfl,
                                         device="cpu")
    step = trainer.make_fl_step(tfl, unravel, torch_loss,
                                state.w.shape[0], device="cpu")
    with pytest.raises(ValueError, match="controller state"):
        step.server_phase(state.w, torch.zeros(3), None, state.g, state.age,
                          state.sel_count, state.residual, state.theta, {})
