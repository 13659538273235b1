"""Async rounds and staged rounds in the port against the JAX package:
``shift_selected_age`` / ``shift_age_hist`` (as ``tests/test_async.py``),
the engine's ``age_lag`` on the exact, threshold and packed backends, the
FL trainer with ``async_lag`` 1 and 2 on each backend (the small CNN task,
N = 4, H = 2, with the JAX trainer's draws), the sweep's async lanes, and
``scan_rounds`` against the per-round loop.

Tolerances: the shift helpers, the engine outputs (noise 0) and the
sweep's ages, ``frac_fresh`` and ``km_frac`` exactly; the sweep's loss and
residual norm within rtol 2e-6 (as ``tests/test_torch_sweep.py``);
whole trainer rounds as ``tests/test_torch_fl.py``: ``w`` within atol
1e-5, ages equal on at least 99.9% of the coordinates (the clients'
float32 sums run in another order), the threshold route's server phase
fed JAX's own aggregate with ages exactly; ``scan_rounds`` bit for
bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sweep import jax_lane_draws
from torchutil import (exact_round_draws, round_draws, run_jax_rounds,
                       small_fl_task, to_np, to_torch, torch_loss,
                       torch_params)

from repro.core import aou as jax_aou
from repro.core import engine as jax_engine
from repro.core import oac as jax_oac
from repro.core import packing as jax_packing
from repro.fl import sweep as jax_sweep
from repro.fl import trainer as jax_trainer
from repro_torch.core import aou, engine, oac, packing
from repro_torch.fl import sweep, trainer
from repro_torch.kernels import ref
from repro_torch.models import cnn

AGE_CAP = packing.AGE_CAP
ROUNDS = 3


def test_shift_selected_age_semantics():
    vals = [0.0, 5.0, 0.0, packing.PAD_AGE, AGE_CAP, AGE_CAP - 1.0]
    for lag in (0, 2, 7):
        out = packing.shift_selected_age(torch.tensor(vals), lag)
        np.testing.assert_array_equal(
            to_np(out), np.asarray(jax_packing.shift_selected_age(
                jnp.asarray(vals, jnp.float32), lag)))
    np.testing.assert_array_equal(
        to_np(packing.shift_selected_age(torch.tensor(vals), 2)),
        [2.0, 5.0, 2.0, packing.PAD_AGE, AGE_CAP, AGE_CAP - 1.0])


@pytest.mark.parametrize("lag", [0, 1, 2, 200])
def test_shift_age_hist_matches_shifted_buffer(lag):
    rng = np.random.default_rng(lag)
    age_next = rng.choice([0.0, 0.0, 1.0, 3.0, 7.0, AGE_CAP],
                          size=4096).astype(np.float32)
    valid = torch.ones(4096, dtype=torch.bool)
    _, h_sync = ref.strided_hists_ref(torch.zeros(4096),
                                      to_torch(age_next), valid, 1)
    _, h_shifted = ref.strided_hists_ref(
        torch.zeros(4096), packing.shift_selected_age(to_torch(age_next),
                                                      lag), valid, 1)
    got = packing.shift_age_hist(h_sync, lag)
    if lag <= AGE_CAP:
        np.testing.assert_array_equal(to_np(got), to_np(h_shifted))
    np.testing.assert_array_equal(
        to_np(got), np.asarray(jax_packing.shift_age_hist(
            jnp.asarray(to_np(h_sync)), lag)))
    if lag == 0:
        assert got is h_sync                          # the identity


def test_int8_buffer_never_wraps_under_lag():
    """As ``tests/test_async.py``: ages past the cap and an async shift on
    top round-trip through the int8 server buffer without wrapping into
    the pad sentinel, for any number of rounds."""
    d = 256
    age = torch.cat([torch.full((d - 8,), AGE_CAP - 1.0),
                     torch.full((8,), packing.PAD_AGE)]).to(torch.int8)
    mask = torch.zeros(d)
    mask[0] = 1.0
    a = age.to(torch.float32)
    for _ in range(10):
        a = aou.update_age(a, mask)
        a = torch.where(age.to(torch.float32) < 0.0, age.to(torch.float32),
                        a)
        a = packing.shift_selected_age(a, 3)
        a8 = a.to(torch.int8)
        assert int(a8.max()) <= int(AGE_CAP)
        assert (to_np(a8)[-8:] == packing.PAD_AGE).all()
        assert (to_np(a8)[:-8] >= 0).all()
        a = a8.to(torch.float32)
    j = jax_aou.update_age(jnp.full((4,), AGE_CAP), jnp.zeros(4))
    assert float(j.max()) == AGE_CAP


def _engine_pair(backend, d, fused=True):
    kw = dict(policy="fairk", backend=backend, rho=0.125, k_m_frac=0.75,
              fused_stats=fused if backend != "exact" else True,
              warm_start=backend == "packed", sample_cap=1024)
    lay_j = lay_t = None
    if backend == "packed":
        lay_j = jax_packing.PackedLayout.from_tree([jnp.zeros((d,))],
                                                   lane=1)
        lay_t = packing.PackedLayout.from_tree(torch.zeros(d), lane=1)
    return (jax_engine.SelectionEngine(jax_engine.EngineConfig(**kw), d,
                                       layout=lay_j),
            engine.SelectionEngine(engine.EngineConfig(**kw), d,
                                   layout=lay_t))


@pytest.mark.parametrize("backend,fused", [("exact", True),
                                           ("threshold", True),
                                           ("threshold", False),
                                           ("packed", True),
                                           ("packed", False)])
@pytest.mark.parametrize("lag", [0, 1, 3])
def test_engine_age_lag_matches_jax(backend, fused, lag):
    """Three rounds: the selected coordinates carry the lag, everything
    else (counts, histograms, the selection mask) as in JAX."""
    d = 2048
    jeng, teng = _engine_pair(backend, d, fused)
    rng = np.random.default_rng(lag)
    j_gp = jnp.zeros(d)
    j_age = jnp.asarray(rng.integers(0, 12, d).astype(np.float32))
    t_gp, t_age = to_torch(j_gp), to_torch(j_age)
    jts = jax_packing.init_threshold_state()
    tts = packing.init_threshold_state("cpu")
    for r in range(3):
        g = rng.normal(size=d).astype(np.float32)
        kw_j = {"age_lag": lag}
        kw_t = {"age_lag": lag}
        if backend == "packed":
            kw_j["tstate"], kw_t["tstate"] = jts, tts
        jg, j_age, js = jeng.select_and_merge(jnp.asarray(g), j_gp, j_age,
                                              **kw_j)
        tg, t_age, ts = teng.select_and_merge(to_torch(g), t_gp, t_age,
                                              **kw_t)
        np.testing.assert_array_equal(to_np(t_age), np.asarray(j_age))
        np.testing.assert_array_equal(to_np(tg).view(np.int32),
                                      np.asarray(jg).view(np.int32))
        assert ("sel_mask" in ts) == bool(lag) == ("sel_mask" in js)
        for key in ("sel_mask", "age_hist", "mag_hist", "n_selected"):
            if key in js:
                np.testing.assert_array_equal(to_np(ts[key]),
                                              np.asarray(js[key]), key)
        if lag:
            sel = to_np(ts["sel_mask"]) > 0
            assert (to_np(t_age)[sel] == lag).all()
        if backend == "packed":
            for key in js["tstate"]:
                np.testing.assert_allclose(to_np(ts["tstate"][key]),
                                           np.asarray(js["tstate"][key]),
                                           rtol=1e-6, err_msg=key)
            jts, tts = js["tstate"], ts["tstate"]
        j_gp, t_gp = jg, tg


def _fl_pair(backend, lag, one_bit=False, policy="fairk"):
    kw = dict(n_clients=4, local_steps=2, batch_size=3, local_lr=0.05,
              global_lr=0.05, rounds=ROUNDS, backend=backend,
              client_chunk=2, compression_ratio=0.2, seed=0,
              async_lag=lag, one_bit=one_bit, policy=policy)
    ch = dict(fading="rayleigh", mean=1.0, noise_std=0.1)
    if one_bit:
        kw.update(local_lr=0.003, global_lr=0.003)
        ch = dict(fading="none", mean=1.0, noise_std=2.0)
    return (jax_trainer.FLConfig(channel=jax_oac.ChannelConfig(**ch), **kw),
            trainer.FLConfig(channel=oac.ChannelConfig(**ch), **kw))


@pytest.fixture(scope="module")
def task():
    return small_fl_task(ROUNDS)


def _jax_rounds(jfl, params, batches, capture=False):
    exact = jfl.backend == "exact"
    spies = ([(jax_engine.SelectionEngine, "select_and_merge", "score", 1)]
             if capture else [])
    return run_jax_rounds(
        jfl, params, batches,
        (lambda key, d: exact_round_draws(key, jfl, d)) if exact
        else (lambda key, d: round_draws(key, jfl.n_clients, d,
                                         jfl.channel)), spies)


WHOLE = [("exact", 1, False, "fairk"), ("exact", 2, True, "fairk"),
         ("threshold", 1, False, "fairk"), ("threshold", 2, True, "fairk"),
         ("packed", 1, False, "fairk"), ("packed", 2, True, "fairk"),
         ("packed", 2, False, "fairk_auto"),
         ("threshold", 2, False, "fairk_auto"),
         ("exact", 2, False, "fairk_auto")]


@pytest.mark.parametrize("backend,lag,one_bit,policy", WHOLE)
def test_whole_async_rounds_track_the_jax_trainer(task, backend, lag,
                                                  one_bit, policy):
    params, batches = task
    jfl, tfl = _fl_pair(backend, lag, one_bit, policy)
    jax_rounds, d = _jax_rounds(jfl, params, batches)
    state, unravel = trainer.init_server(torch_params(params), tfl,
                                         device="cpu")
    step = trainer.make_fl_step(tfl, unravel, torch_loss, d, device="cpu")
    w, g, age, sc = state.w, state.g, state.age, state.sel_count
    res, ts, cs = state.residual, state.theta, state.ctrl
    for t, rnd in enumerate(jax_rounds):
        xs, ys = batches[t]
        draws = {k: to_torch(v) for k, v in rnd["draws"].items()}
        w, g, age, sc, res, sel, ts, cs, m = step(
            w, g, age, sc, to_torch(xs), to_torch(ys), res, ts, draws, cs)
        jw, _, jage, jsc, _, _ = rnd["after"]
        np.testing.assert_allclose(to_np(w), np.asarray(jw), rtol=0,
                                   atol=1e-5, err_msg=f"round {t} w")
        agree = float((to_np(age) == np.asarray(jage)).mean())
        assert agree >= 0.999, f"round {t}: ages agree on {agree:.5f}"
        # the refreshed coordinates carry the lag, none is at age 0
        assert (to_np(age)[to_np(sel) > 0] == lag).all()
        assert float((age == 0.0).sum()) == 0.0
        if backend == "exact":
            assert float(sc.sum()) == float(np.asarray(jsc).sum())
        np.testing.assert_allclose(to_np(cs["k_m_frac"]),
                                   np.asarray(rnd["ctrl"]["k_m_frac"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("backend", ["threshold", "packed"])
@pytest.mark.parametrize("lag", [1, 2])
def test_async_server_phase_on_jax_aggregate_gives_exact_ages(
        task, backend, lag):
    params, batches = task
    jfl, tfl = _fl_pair(backend, lag)
    jax_rounds, d = _jax_rounds(jfl, params, batches, capture=True)
    _, unravel = cnn.ravel_params(torch_params(params))
    step = trainer.make_fl_step(tfl, unravel, torch_loss, d, device="cpu")
    for t, rnd in enumerate(jax_rounds):
        w, g, age, sc, res, ts, _ = rnd["before"]
        out = step.server_phase(
            to_torch(w), to_torch(rnd["captured"]["score"]), None,
            to_torch(g), to_torch(age), to_torch(sc), to_torch(res),
            {k: to_torch(v) for k, v in ts.items()},
            {k: to_torch(v) for k, v in rnd["draws"].items()})
        w2, g2, age2, sc2, _, ts2 = rnd["after"]
        np.testing.assert_array_equal(to_np(out[2]), np.asarray(age2),
                                      err_msg=f"round {t} ages")
        np.testing.assert_array_equal(to_np(out[3]), np.asarray(sc2))
        np.testing.assert_allclose(to_np(out[1]), np.asarray(g2),
                                   rtol=1e-6, atol=1e-7)
        if backend == "packed":
            np.testing.assert_array_equal(to_np(out[6]["age_hist"]),
                                          np.asarray(ts2["age_hist"]))


def test_sweep_async_lanes_match_jax():
    from repro.core import controller as jax_controller
    from repro_torch.core import controller
    kw = dict(d=128, n_clients=4, rounds=10, async_lag=2)
    law = dict(period=3, deadband=0.0)
    pols, fracs = ("fairk", "fairk_auto", "roundrobin"), (0.25, 0.75)
    jcfg = jax_sweep.SweepConfig(
        controller=jax_controller.ControllerConfig(**law), **kw)
    tcfg = sweep.SweepConfig(controller=controller.ControllerConfig(**law),
                             **kw)
    j = jax_sweep.run_sweep(jcfg, pols, fracs, 2)
    seeds = sweep.sweep_grid(pols, fracs, 2, tcfg)[0]
    t = sweep.run_sweep(tcfg, pols, fracs, 2,
                        draws=jax_lane_draws(jcfg, seeds), device="cpu")
    for key in ("mean_age", "max_age", "frac_fresh", "km_frac"):
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    for key in ("loss", "res_norm"):
        np.testing.assert_allclose(t[key], j[key], rtol=2e-6, err_msg=key)
    sync = sweep.run_sweep(dataclasses.replace(tcfg, async_lag=0), pols,
                           fracs, 2, draws=jax_lane_draws(jcfg, seeds),
                           device="cpu")
    assert (t["mean_age"] > sync["mean_age"]).all()


@pytest.mark.parametrize("backend,one_bit,extra", [
    ("packed", False, {}), ("packed", True, {}),
    ("threshold", False, {"error_feedback": True}),
    ("exact", False, {"async_lag": 1}),
    ("packed", False, {"policy": "fairk_auto", "async_lag": 2})])
def test_scan_rounds_walk_the_loop_trajectory(task, backend, one_bit,
                                              extra):
    """``scan_rounds = 3`` (chunks cut at the eval rounds) against the
    per-round loop: identical weights, ages, counts and telemetry."""
    params, batches = task
    _, tfl = _fl_pair(backend, 0, one_bit)
    tfl = dataclasses.replace(tfl, rounds=7, **extra)
    evals = []

    def run(scan):
        evals.append([])
        return trainer.train(
            dataclasses.replace(tfl, scan_rounds=scan),
            torch_params(params), torch_loss,
            lambda t: batches[t % ROUNDS],
            eval_fn=lambda p: evals[-1].append(1) or {"acc": 0.5},
            eval_every=4, device="cpu")

    loop, scanned = run(0), run(3)
    assert len(evals[0]) == len(evals[1]) == 3       # rounds 1, 4 and 7
    assert loop["round"] == scanned["round"] == [1, 4, 7]
    for field in ("w", "g", "age", "sel_count", "residual"):
        a = getattr(loop["state"], field)
        b = getattr(scanned["state"], field)
        assert torch.equal(a, b), field
    for key in ("mean_aou", "max_aou", "km_frac", "n_selected"):
        assert loop[key] == scanned[key], key
    for key in loop["state"].theta:
        assert torch.equal(loop["state"].theta[key],
                           scanned["state"].theta[key]), key


def test_negative_lag_is_rejected():
    _, tfl = _fl_pair("packed", 0)
    with pytest.raises(ValueError, match="async_lag"):
        trainer.make_fl_step(dataclasses.replace(tfl, async_lag=-1),
                             lambda w: w, torch_loss, 8, device="cpu")
    for backend in ("exact", "threshold", "packed"):
        _, eng = _engine_pair(backend, 64)
        z = torch.zeros(64)
        with pytest.raises(ValueError, match="age_lag"):
            eng.select_and_merge(z, z, z, age_lag=-2,
                                 tstate=packing.init_threshold_state("cpu"))
    with pytest.raises(ValueError, match="age_lag"):
        jax_engine.make_engine("fairk", "exact", d=64).select_and_merge(
            jnp.zeros(64), jnp.zeros(64), jnp.zeros(64), age_lag=-2)
