"""The port's population simulator (``repro_torch.core.population``) and
its trainer and sweep wiring against ``repro.core.population``, the JAX
trainer and ``repro.fl.sweep``, on JAX's own draws.

Tolerances, per test:

* configs, transition probabilities, ``client_jitter`` (the uint32 Knuth
  hash in int64 halves), the int8 cohort grid, the cohort's ``part``,
  ``n_t``, ``churn``, ``slow_share``, ``n_avail`` and the churn erasure
  masks: exactly, in the iid, Gilbert–Elliott and diurnal modes;
* the diurnal rate: the compiled reference's phase ``t · f32(2π/period)``
  exactly; its rate ``avail · fma(depth, sin, 1)`` with XLA's own float32
  sine, which differs in the last place from the correctly rounded one on
  a few phases — at most 1% of 2,000 rounds differ, by one ulp each (the
  grids still match exactly in the tests below);
* trainer rounds from JAX's state, fault state and draws (d = 1,400,
  N = 4): ages on at least 0.9999 of the coordinates, ``w`` within 1e-6,
  the population grid and round counter exactly;
* sweep population lanes (d = 128, N = 4): ages, ``frac_fresh``, ``n_t``
  and ``churn`` exactly, ``loss`` within rtol 2e-6;
* the stationary AoU under the erasures a port population scan produces
  (port generator): TV < 0.1 against
  ``markov.population_aou_distribution`` on exact and packed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import statutil
import torch
from torchutil import (assert_step_parity, jax_sweep_lane_draws,
                       port_age_hist, scenario_fl_pair, scenario_step_parity,
                       small_fl_task, to_np, to_torch, torch_loss,
                       torch_params)

from repro.core import population as jp
from repro.fl import sweep as jax_sweep
from repro_torch.core import markov, packing, population
from repro_torch.core.engine import make_engine
from repro_torch.fl import sweep, trainer

pytestmark = pytest.mark.population

MODES = {"iid": dict(), "ge": dict(mode="ge", burst=4.0, avail=0.8),
         "diurnal": dict(mode="diurnal", avail=0.8, depth=0.2, period=16)}


def _cfgs(**kw):
    base = dict(n_clients=1000, cohort_size=96, participants=8,
                slow_frac=0.2)
    base.update(kw)
    return population.PopulationConfig(**base), jp.PopulationConfig(**base)


@pytest.fixture(scope="module")
def task():
    return small_fl_task(3)


def test_config_fields_checks_and_derived():
    for kw in MODES.values():
        t, j = _cfgs(**kw)
        for attr in ("n_cohorts", "n_padded", "vanish_rate", "thin"):
            assert getattr(t, attr) == getattr(j, attr), attr
        assert population.transition_probs(t) == jp.transition_probs(j)
    for bad in (dict(n_clients=0), dict(participants=2000),
                dict(avail=0.0), dict(mode="x"),
                dict(mode="ge", avail=0.2, burst=2.0),
                dict(mode="diurnal", avail=0.9, depth=0.2),
                dict(slow_frac=1.0), dict(exposure=0.0),
                dict(erase_block=0)):
        with pytest.raises(ValueError):
            jp.PopulationConfig(**{"n_clients": 1000, **bad})
        with pytest.raises(ValueError):
            population.PopulationConfig(**{"n_clients": 1000, **bad})


def test_diurnal_rate_and_client_jitter():
    t_cfg, j_cfg = _cfgs(**MODES["diurnal"])
    ts = np.arange(2000)
    want = np.asarray(jax.jit(jax.vmap(
        lambda t: jp.availability_rate(j_cfg, t)))(jnp.asarray(ts,
                                                               jnp.int32)))
    got = to_np(population.availability_rate(t_cfg, torch.tensor(ts)))
    diff = got.view(np.int32) - want.view(np.int32)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).sum() <= 20, int((diff != 0).sum())
    iid_t, iid_j = _cfgs()
    assert float(population.availability_rate(iid_t, 5, "cpu")) == float(
        jp.availability_rate(iid_j, 5))
    ids = np.array([0, 1, 7, 999, 65535, 65536, 123456789, 2**31 - 1,
                    2**32 - 1], np.int64)
    np.testing.assert_array_equal(
        to_np(population.client_jitter(torch.tensor(ids))),
        np.asarray(jp.client_jitter(jnp.asarray(ids.astype(np.uint32)))))


@pytest.mark.parametrize("mode", list(MODES))
def test_population_rounds_exact(mode):
    t_cfg, j_cfg = _cfgs(**MODES[mode])
    key = jax.random.PRNGKey(5)
    j_state = jp.init_population_state(key, j_cfg)
    t_state = population.init_population_state(
        to_torch(jax.random.uniform(key, (j_cfg.n_clients,), jnp.float32)),
        t_cfg)
    rnd = jax.jit(lambda s, k: jp.population_round(s, k, j_cfg))
    for r in range(12):
        k = jax.random.fold_in(key, r)
        j_state, j_ps = rnd(j_state, k)
        key_t, key_p = jax.random.split(k)
        u = jax.random.uniform(key_t, (j_cfg.n_clients,), jnp.float32)
        ids = jax.random.randint(key_p, (j_cfg.participants,), 0,
                                 j_cfg.n_clients)
        t_state, t_ps = population.population_round(
            t_state, to_torch(u), to_torch(ids), t_cfg)
        np.testing.assert_array_equal(to_np(t_state["avail"]),
                                      np.asarray(j_state["avail"]))
        assert to_np(t_state["avail"]).dtype == np.int8
        assert int(t_state["t"]) == int(j_state["t"])
        for name in ("part", "n_t", "churn", "slow", "slow_share",
                     "n_avail"):
            np.testing.assert_array_equal(to_np(t_ps[name]),
                                          np.asarray(j_ps[name]),
                                          err_msg=name)
    # the pads stay PAD
    assert (to_np(t_state["avail"]).reshape(-1)[j_cfg.n_clients:]
            == population.PAD).all()


def test_churn_erase_mask_exact():
    t_cfg, j_cfg = _cfgs(erase_block=16, exposure=0.7)
    d, key = 3000, jax.random.PRNGKey(2)
    for churn in (0.0, 0.3, 1.0):
        want = jp.churn_erase_mask(key, d, jnp.float32(churn), j_cfg)
        u = jax.random.uniform(key, (-(-d // 16),))
        got = population.churn_erase_mask(to_torch(u), d,
                                          torch.tensor(churn), t_cfg)
        np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_stateless_round_is_a_chain():
    """Round t's ``next`` grid is round t+1's ``now`` grid: a participant
    counted in round t+1 is exactly one that is up in round t's next
    grid, so a sample of the same ids agrees; draws are deterministic in
    (seed, t) and the availability is near ``avail``."""
    cfg = population.PopulationConfig(n_clients=5000, participants=64,
                                      mode="diurnal", avail=0.8, depth=0.2)
    a = population.stateless_round(3, 7, cfg, "cpu")
    b = population.stateless_round(3, 7, cfg, "cpu")
    for key in a:
        assert torch.equal(a[key], b[key])
    for t in range(4):
        st = population.stateless_round(3, t, cfg, "cpu")
        ids = torch.randint(0, cfg.n_clients, (cfg.participants,),
                            generator=population.round_generator(
                                3, 0xB, t, "cpu"))
        up_now = population.stateless_avail(3, t, cfg, "cpu")[ids] == 1
        down_next = population.stateless_avail(3, t + 1, cfg, "cpu")[ids] == 0
        assert float(st["n_t"]) == float(up_now.sum())
        assert float(st["churn"]) == pytest.approx(
            float((up_now & down_next).sum()) / max(float(up_now.sum()), 1))
        frac = float(st["n_avail"]) / cfg.n_clients
        assert abs(frac - float(st["rate"])) < 0.03
    with pytest.raises(ValueError, match="memoryless"):
        population.stateless_round(0, 0, population.PopulationConfig(
            mode="ge"), "cpu")


def test_population_scan_1e5():
    """10^5 Gilbert–Elliott clients, 16 rounds in the device loop: the
    availability holds its stationary rate; the scan equals the rounds
    run one by one on the same generator stream."""
    cfg = population.PopulationConfig(n_clients=100_000, participants=16,
                                      mode="ge", avail=0.9, burst=8.0)
    gen = torch.Generator().manual_seed(0)
    state, tr = population.population_scan(cfg, 16, gen, "cpu")
    assert tr["n_avail"].shape == (16,)
    assert abs(float(tr["n_avail"].mean()) / cfg.n_clients - 0.9) < 0.01
    gen = torch.Generator().manual_seed(0)
    s = population.init_population_state(torch.rand(cfg.n_clients,
                                                    generator=gen), cfg)
    for r in range(16):
        u, ids = population.draw_round(gen, cfg, "cpu")
        s, ps = population.population_round(s, u, ids, cfg)
        assert float(ps["n_t"]) == float(tr["n_t"][r])
    assert torch.equal(s["avail"], state["avail"])


@pytest.mark.parametrize("backend,mode", [("exact", "diurnal"),
                                          ("threshold", "iid"),
                                          ("packed", "ge")])
def test_population_rounds_track_jax(task, backend, mode):
    params, batches = task
    kw = dict(n_clients=512, cohort_size=128, participants=4, **MODES[mode])
    jfl, tfl = scenario_fl_pair(
        backend, dict(population=jp.PopulationConfig(**kw)),
        dict(population=population.PopulationConfig(**kw)))
    _, _, _, pairs = scenario_step_parity(jfl, tfl, params, batches)
    assert_step_parity(pairs)


def test_train_with_a_million_virtual_clients(task):
    params, batches = task
    pc = population.PopulationConfig(n_clients=1_000_000, participants=4,
                                     mode="ge", avail=0.8, burst=4.0)
    _, tfl = scenario_fl_pair("packed", {}, dict(population=pc))
    hist = trainer.train(tfl, torch_params(params), torch_loss,
                         lambda t: batches[t % 3], device="cpu")
    grid = hist["fstate"]["pop"]["avail"]
    assert grid.shape == (pc.n_cohorts, pc.cohort_size)
    assert grid.dtype == torch.int8 and int(hist["fstate"]["pop"]["t"]) == 3
    assert np.isfinite(to_np(hist["state"].w)).all()


def test_sweep_population_lanes_match_jax():
    kw = dict(d=128, n_clients=4, rounds=6)
    pkw = dict(n_clients=256, cohort_size=64, participants=4, mode="ge",
               avail=0.7, burst=3.0, erase_block=8)
    jcfg = jax_sweep.SweepConfig(population=jp.PopulationConfig(**pkw),
                                 **kw)
    tcfg = sweep.SweepConfig(population=population.PopulationConfig(**pkw),
                             **kw)
    pols, fracs = ("fairk", "fairk_auto"), (0.5,)
    j = jax_sweep.run_sweep(jcfg, pols, fracs, 2)
    seeds = sweep.sweep_grid(pols, fracs, 2, tcfg)[0]
    t = sweep.run_sweep(tcfg, pols, fracs, 2,
                        draws=jax_sweep_lane_draws(jcfg, seeds),
                        device="cpu")
    for key in ("mean_age", "max_age", "frac_fresh", "n_t", "churn"):
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=2e-6)
    assert (t["frac_fresh"] < tcfg.k / tcfg.d).any()


@pytest.mark.parametrize("backend", ["exact", "packed"])
def test_stationary_aou_under_population_churn(backend):
    """Block erasures at ``exposure · churn`` from a port population scan
    and a full erase on an empty cohort: the stationary AoU follows the
    participation-thinned Lemma-1 law."""
    d, k, k_m = 512, 64, 32
    cfg = population.PopulationConfig(n_clients=2048, cohort_size=512,
                                      participants=32, avail=0.75,
                                      exposure=0.5, erase_block=8)
    gen = torch.Generator().manual_seed(11)
    _, tr = population.population_scan(cfg, 600, gen, "cpu")
    churn, n_t = to_np(tr["churn"]), to_np(tr["n_t"])
    nb = -(-d // cfg.erase_block)

    def erase_fn(r):
        if n_t[r] == 0:
            return np.ones(d, np.float32)
        return to_np(population.churn_erase_mask(
            torch.rand(nb, generator=gen), d, torch.tensor(churn[r]), cfg))

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
    acc = port_age_hist(eng, d, erase_fn, tstate=ts)
    k0 = int(round(k_m * (1 - k_m / d)))
    support, pred = markov.population_aou_distribution(
        markov.FairKChain(d=d, k=k, k_m=k_m, k0=k0),
        cfg.avail, cfg.vanish_rate, cfg.participants, cfg.exposure)
    statutil.assert_pmf_close(acc, support, pred)
