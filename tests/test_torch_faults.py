"""The port's fault layer (``repro_torch.core.faults``) and its trainer
wiring against ``repro.core.faults`` and the JAX trainer, on JAX's own
draws.

Tolerances, per test:

* configs, ``ge_probs``, availability chains, fade masks, the
  total-outage erase and ``corrupt`` (NaN and both infinities): exactly;
* ``participation_scale``: bit for bit against the compiled reference —
  which divides by its data-dependent ``max(n_t, 1)`` (XLA turns only a
  division by a constant into a product with the reciprocal: on 200,000
  values a reciprocal product differs on 50,000–110,000);
* ``watchdog_step``: bit for bit — the compiled EMA is
  ``fma(ema, e, round((1 − ema)·x))`` (the unfused form differs on 4,415
  of 20,000), which the port forms in float64 and rounds once;
* scenario rounds on the narrow CNN (d = 1,400, N = 4, 3 rounds) from
  JAX's state, fault state and draws each round: ages equal on at least
  0.9999 of the coordinates, ``w`` within 1e-6, the availability chain
  exactly, the watchdog's trips exactly and its EMAs within rtol 1e-5
  (the clients' sums run in another order); the server phase fed JAX's
  own aggregate and erasure without receiver noise: ``g_t``, ages and
  counts bit for bit;
* the stationary AoU under iid erasure at rate 0.1 on the port's engine
  and generator: TV < 0.1 against ``markov.thinned_aou_distribution``
  (``tests/statutil.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import statutil
import torch
from torchutil import (assert_step_parity, port_age_hist, scenario_fl_pair,
                       scenario_step_parity, small_fl_task, to_np, to_port,
                       to_torch, torch_loss, torch_params)

from repro.core import engine as jax_engine
from repro.core import faults as jf
from repro_torch.core import faults, markov, packing
from repro_torch.core.engine import make_engine
from repro_torch.fl import trainer
from repro_torch.models import cnn

pytestmark = pytest.mark.chaos

FC = dict(dropout=0.2, burst=4.0, fade=0.05, nan_rate=1e-3, fade_block=64)


@pytest.fixture(scope="module")
def task():
    return small_fl_task(4)


def _bits(x):
    return to_np(x).view(np.uint32)


def test_fault_config_fields_and_checks():
    for kw in (dict(), FC, dict(dropout=0.3), dict(fade=0.1, nan_rate=0.2)):
        t, j = faults.FaultConfig(**kw), jf.FaultConfig(**kw)
        assert (t.enabled, t.thin) == (j.enabled, j.thin)
        assert faults.ge_probs(t) == jf.ge_probs(j)
    for bad in (dict(dropout=1.0), dict(fade=-0.1), dict(nan_rate=1.0),
                dict(burst=0.5), dict(dropout=0.6, burst=1.2),
                dict(fade_block=0)):
        with pytest.raises(ValueError):
            jf.FaultConfig(**bad)
        with pytest.raises(ValueError):
            faults.FaultConfig(**bad)
    for bad in (dict(spike=1.0), dict(tighten=0.0)):
        with pytest.raises(ValueError):
            faults.WatchdogConfig(**bad)


@pytest.mark.parametrize("kw", [dict(dropout=0.2), dict(dropout=0.2,
                                                        burst=4.0),
                                dict(fade=0.1)])
def test_availability_chain_exact(kw):
    n, key = 4096, jax.random.PRNGKey(3)
    tc, jc = faults.FaultConfig(**kw), jf.FaultConfig(**kw)
    u0 = jax.random.uniform(key, (n,))
    a_j = jf.init_avail_state(key, n, jc)
    a_t = faults.init_avail_state(to_torch(u0), tc)
    np.testing.assert_array_equal(to_np(a_t), np.asarray(a_j))
    step = jax.jit(lambda a, k: jf.avail_step(a, k, jc))
    for r in range(5):
        k = jax.random.fold_in(key, r)
        a_j = step(a_j, k)
        a_t = faults.avail_step(a_t, to_torch(jax.random.uniform(k, (n,))),
                                tc)
        np.testing.assert_array_equal(to_np(a_t), np.asarray(a_j))


def test_participation_scale_bit_for_bit():
    rng = np.random.default_rng(0)
    total = (rng.normal(size=20000) * 5).astype(np.float32)
    f = jax.jit(jf.participation_scale)
    for n_t in (0.0, 1.0, 3.0, 7.0, 13.0, 49.0):
        want = f(jnp.asarray(total), jnp.float32(n_t))
        got = faults.participation_scale(to_torch(total),
                                         torch.tensor(n_t))
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_fade_mask_corrupt_and_outage_exact():
    d, key = 5000, jax.random.PRNGKey(7)
    for kw in (dict(fade=0.3, fade_block=64), dict(fade=0.0),
               dict(nan_rate=0.2), dict(nan_rate=0.0)):
        tc, jc = faults.FaultConfig(**kw), jf.FaultConfig(**kw)
        nb = -(-d // tc.fade_block)
        u = to_torch(jax.random.uniform(key, (nb,)))
        np.testing.assert_array_equal(
            to_np(faults.fade_mask(u, d, tc)),
            np.asarray(jax.jit(lambda k: jf.fade_mask(k, d, jc))(key)))
        g = np.random.default_rng(1).normal(size=d).astype(np.float32)
        want = jax.jit(lambda g, k: jf.corrupt(g, k, jc))(jnp.asarray(g),
                                                          key)
        got = faults.corrupt(to_torch(g), to_torch(
            jax.random.uniform(key, (d,))), tc)
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
    erase = (np.random.default_rng(2).random(d) < 0.1).astype(np.float32)
    for n_t in (0.0, 2.0):
        np.testing.assert_array_equal(
            to_np(faults.erase_with_outage(to_torch(erase),
                                           torch.tensor(n_t))),
            np.asarray(jf.erase_with_outage(jnp.asarray(erase), n_t)))


def test_watchdog_step_bit_for_bit():
    """A sequence with warm-up, a spike, a NaN and the cooldown, through
    the jitted reference and the port."""
    cfg_t = faults.WatchdogConfig(warmup=2, cooldown=3)
    cfg_j = jf.WatchdogConfig(warmup=2, cooldown=3)
    rng = np.random.default_rng(0)
    obs = [(float(a), float(b)) for a, b in rng.random((12, 2)) * 3 + 0.5]
    obs[5] = (50.0, 1.0)
    obs[8] = (float("nan"), 1.0)
    st_j, st_t = jf.init_watchdog_state(), faults.init_watchdog_state("cpu")
    step = jax.jit(lambda s, l, u: jf.watchdog_step(cfg_j, s, l, u))
    trips = []
    for loss, unorm in obs:
        st_j, trip_j, ks_j = step(st_j, jnp.float32(loss), jnp.float32(unorm))
        st_t, trip_t, ks_t = faults.watchdog_step(
            cfg_t, st_t, torch.tensor(loss), torch.tensor(unorm))
        assert bool(trip_t) == bool(trip_j)
        trips.append(bool(trip_t))
        assert float(ks_t) == float(ks_j)
        for key in faults.WATCHDOG_FIELDS:
            np.testing.assert_array_equal(_bits(st_t[key]),
                                          _bits(st_j[key]), err_msg=key)
    assert trips[5] and trips[8] and not trips[0]


def test_tree_select_nests():
    pred = torch.tensor(True)
    a = (torch.ones(3), {"x": torch.zeros(2), "y": None}, None)
    b = (torch.zeros(3), {"x": torch.ones(2, dtype=torch.float64),
                          "y": None}, None)
    out = faults.tree_select(pred, a, b)
    assert torch.equal(out[0], a[0]) and out[1]["y"] is None
    assert out[1]["x"].dtype == torch.float32 and out[2] is None
    out = faults.tree_select(~pred, a, b)
    assert torch.equal(out[1]["x"], torch.ones(2))
    with pytest.raises(ValueError):
        faults.tree_select(pred, (None,), (torch.ones(1),))


@pytest.mark.parametrize("backend", ["exact", "threshold", "packed"])
def test_chaos_rounds_track_jax(task, backend):
    params, batches = task
    jfl, tfl = scenario_fl_pair(backend, dict(faults=jf.FaultConfig(**FC)),
                                dict(faults=faults.FaultConfig(**FC)))
    _, _, _, pairs = scenario_step_parity(jfl, tfl, params, batches)
    assert_step_parity(pairs)


@pytest.mark.parametrize("backend", ["exact", "packed"])
def test_chaos_server_phase_on_jax_aggregate_bit_for_bit(task, backend):
    """The engine's inputs recorded inside the compiled JAX round (the
    corrupted aggregate and the erase mask) fed to the port's server
    phase: without receiver noise ``g_t``, ages and the participation
    count bit for bit."""
    params, batches = task
    jfl, tfl = scenario_fl_pair(backend, dict(faults=jf.FaultConfig(**FC)),
                                dict(faults=faults.FaultConfig(**FC)))
    spies = [(jax_engine.SelectionEngine, "select_and_merge", "agg", 1),
             (jax_engine.SelectionEngine, "select_and_merge", "erase",
              "erase")]
    _, _, step, pairs = scenario_step_parity(jfl, tfl, params, batches,
                                             spies)
    for t, (_, rnd) in enumerate(pairs):
        w, g, age, sc, res, ts, cs = to_port(rnd["before"])
        cap = rnd["captured"]
        out = step.server_phase(w, to_torch(cap["agg"]), None, g, age, sc,
                                res, ts, to_port(rnd["draws"]), cstate=cs,
                                erase=to_torch(cap["erase"]), sanitize=True)
        jw, jg, jage, jsc, _, _ = rnd["after"]
        np.testing.assert_array_equal(_bits(out[1]), _bits(jg),
                                      err_msg=f"round {t} g_t")
        np.testing.assert_array_equal(to_np(out[2]), np.asarray(jage))
        np.testing.assert_array_equal(to_np(out[3]), np.asarray(jsc))
        assert not np.isnan(to_np(out[1])).any()


def test_watchdog_rollback_tracks_jax(task):
    """A divergent global step trips the watchdog: the port rolls back and
    counts the trips as the reference does, round by round, and reports
    its AoU metrics from the rolled-back ages (mean within rtol 1e-6, the
    float32 sum's order; max exactly)."""
    params, batches = task
    wd = dict(warmup=1, cooldown=2)
    jfl, tfl = scenario_fl_pair(
        "exact", dict(watchdog=jf.WatchdogConfig(**wd),
                      faults=jf.FaultConfig(nan_rate=0.01)),
        dict(watchdog=faults.WatchdogConfig(**wd),
             faults=faults.FaultConfig(nan_rate=0.01)),
        global_lr=40.0, rounds=4)
    jax_rounds, _, _, pairs = scenario_step_parity(jfl, tfl, params,
                                                   batches)
    assert_step_parity(pairs, w_atol=1e-4)
    assert float(jax_rounds[-1]["fstate_after"]["wd"]["trips"]) > 0.0
    tripped = 0
    for out, rnd in pairs:
        np.testing.assert_allclose(float(out[8]["mean_aou"]),
                                   float(rnd["metrics"]["mean_aou"]),
                                   rtol=1e-6)
        assert float(out[8]["max_aou"]) == float(rnd["metrics"]["max_aou"])
        if float(rnd["fstate_after"]["wd"]["trips"]) > float(
                rnd["fstate"]["wd"]["trips"]):
            tripped += 1
            # a tripped round hands back the snapshot's weights and ages
            np.testing.assert_array_equal(
                to_np(out[0]), np.asarray(rnd["fstate"]["snap"][0]))
            np.testing.assert_array_equal(
                to_np(out[2]), np.asarray(rnd["fstate"]["snap"][2]))
    assert tripped > 0


@pytest.mark.parametrize("backend", ["exact", "packed"])
def test_watchdog_on_a_healthy_run_tracks_jax(task, backend):
    params, batches = task
    jfl, tfl = scenario_fl_pair(
        backend, dict(watchdog=jf.WatchdogConfig(warmup=1)),
        dict(watchdog=faults.WatchdogConfig(warmup=1)), rounds=4)
    _, _, _, pairs = scenario_step_parity(jfl, tfl, params, batches)
    assert_step_parity(pairs)


def test_train_with_chaos_and_the_watchdog(task):
    params, batches = task
    _, tfl = scenario_fl_pair(
        "packed", {}, dict(faults=faults.FaultConfig(**FC),
                           watchdog=faults.WatchdogConfig()), rounds=4)
    hist = trainer.train(tfl, torch_params(params), torch_loss,
                         lambda t: batches[t % 4], device="cpu")
    assert np.isfinite(hist["mean_aou"]).all()
    assert hist["wd_trips"] >= 0.0
    fs = hist["fstate"]
    assert fs["avail"].shape == (4,) and len(fs["snap"]) == 7
    assert set(fs["wd"]) == set(faults.WATCHDOG_FIELDS)
    assert np.isfinite(to_np(hist["state"].w)).all()


def test_faults_off_is_the_plain_round(task):
    """All-zero rates and no watchdog: the 9-output round, and the same
    trajectory as a config that never names faults."""
    params, batches = task
    _, tfl = scenario_fl_pair("packed", {}, {})
    zero = dataclasses.replace(tfl, faults=faults.FaultConfig())
    assert not zero.stateful
    a = trainer.train(tfl, torch_params(params), torch_loss,
                      lambda t: batches[t % 4], device="cpu")
    b = trainer.train(zero, torch_params(params), torch_loss,
                      lambda t: batches[t % 4], device="cpu")
    assert torch.equal(a["state"].w, b["state"].w) and b["fstate"] is None
    # a stateful round refuses to run without its fault state
    st = a["state"]
    _, unravel = cnn.ravel_params(torch_params(params))
    step = trainer.make_fl_step(
        dataclasses.replace(zero, watchdog=faults.WatchdogConfig()),
        unravel, torch_loss, st.w.shape[0], device="cpu")
    with pytest.raises(ValueError, match="fstate"):
        step(st.w, st.g, st.age, st.sel_count, None, None, st.residual,
             st.theta, {}, st.ctrl)


@pytest.mark.parametrize("backend", ["exact", "packed"])
def test_stationary_aou_under_erasure(backend):
    """iid per-coordinate erasure at rate 0.1 thins refreshes; the port's
    stationary post-update AoU follows the thinned Lemma-1 law."""
    d, k, k_m, thin = 512, 64, 32, 0.1
    if backend == "packed":
        eng = make_engine("fairk", "packed",
                          layout=packing.PackedLayout.from_tree(
                              torch.empty(d, device="meta"), lane=1),
                          k=k, k_m=k_m, fused_stats=True, warm_start=True)
        ts = packing.init_threshold_state("cpu")
    else:
        eng = make_engine("fairk", "exact", d=d, k=k, k_m=k_m,
                          fused_stats=True)
        ts = None
    gen = torch.Generator().manual_seed(11)
    acc = port_age_hist(eng, d, lambda r: (torch.rand(d, generator=gen)
                                           < thin).to(torch.float32).numpy(),
                        tstate=ts)
    k0 = int(round(k_m * (1 - k_m / d)))
    support, pred = markov.thinned_aou_distribution(
        markov.FairKChain(d=d, k=k, k_m=k_m, k0=k0), thin)
    statutil.assert_pmf_close(acc, support, pred)
