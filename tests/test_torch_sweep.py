"""The port's batched sweep (``repro_torch.fl.sweep``) against
``repro.fl.sweep`` (compiled, as ``run_sweep`` runs it), at d = 128,
N = 4, 10 rounds (the controller acts every 3 rounds), with the JAX lanes'
draws — ``w_stars`` from ``split(PRNGKey(seed), 3)`` and each round's
``pol`` / ``h`` / ``z`` keys from ``keys.split_named`` — handed to the
port.

Tolerances: the lane labels and grid arrays equal; per lane and round the
ages (``mean_age``, ``max_age``), ``frac_fresh`` and ``km_frac`` equal
exactly; ``loss`` and ``res_norm`` within rtol 2e-6 (the clients'
superposition sums in another order, and XLA folds the noise scale into
its in-graph draw).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import controller as jax_controller
from repro.core import keys as keys_mod
from repro.fl import sweep as jax_sweep
from repro_torch.core import controller
from repro_torch.fl import sweep

POLICIES = ("fairk", "topk", "roundrobin", "randk", "fairk_auto")
FRACS = (0.25, 0.75)


def jax_lane_draws(cfg, seeds):
    """Each lane's draws as the JAX grid takes them from its seed."""
    out = {"w_stars": [], "h": [], "z": [], "u": []}
    for s in seeds:
        key_shared, key_init, key_run = jax.random.split(
            jax.random.PRNGKey(int(s)), 3)
        out["w_stars"].append(np.asarray(
            cfg.shared * jax.random.normal(key_shared, (cfg.d,),
                                           jnp.float32)[None, :]
            + cfg.hetero * jax.random.normal(key_init, (cfg.n_clients, cfg.d),
                                             jnp.float32)))
        hs, zs, us = [], [], []
        for key in jax.random.split(key_run, cfg.rounds):
            ks = keys_mod.split_named(key, keys_mod.round_key_names(
                base=("pol", "h", "z")))
            us.append(np.asarray(jax.random.uniform(ks["pol"], (cfg.d,))))
            hs.append(np.asarray(jax.random.rayleigh(
                ks["h"], cfg.fading_mean / np.sqrt(np.pi / 2.0),
                shape=(cfg.n_clients,), dtype=jnp.float32)))
            zs.append(np.asarray(jax.random.normal(ks["z"], (cfg.d,),
                                                   jnp.float32)))
        out["h"].append(np.stack(hs))
        out["z"].append(np.stack(zs))
        out["u"].append(np.stack(us))
    return {k: np.stack(v) for k, v in out.items()}


@pytest.mark.parametrize("policies,fracs,n_seeds", [
    (POLICIES, FRACS, 2), (("fairk", "fairk_auto"), (0.0, 0.5, 1.0), 3),
    (("topk", "topk", "randk"), (0.3,), 1)])
def test_sweep_grid_matches_jax(policies, fracs, n_seeds):
    t = sweep.sweep_grid(policies, fracs, n_seeds, sweep.SweepConfig())
    j = jax_sweep.sweep_grid(policies, fracs, n_seeds,
                             jax_sweep.SweepConfig())
    for a, b in zip(t[:4], j[:4]):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.int32
    assert t[4] == j[4]


@pytest.mark.parametrize("ef", [False, True])
def test_run_sweep_matches_jax(ef):
    kw = dict(d=128, n_clients=4, rounds=10, error_feedback=ef)
    # a controller that acts every 3 rounds with no deadband, so the
    # adaptive lanes move within 10 rounds
    law = dict(period=3, deadband=0.0)
    jcfg = jax_sweep.SweepConfig(
        controller=jax_controller.ControllerConfig(**law), **kw)
    tcfg = sweep.SweepConfig(controller=controller.ControllerConfig(**law),
                             **kw)
    j = jax_sweep.run_sweep(jcfg, POLICIES, FRACS, 2)
    seeds = sweep.sweep_grid(POLICIES, FRACS, 2, tcfg)[0]
    t = sweep.run_sweep(tcfg, POLICIES, FRACS, 2,
                        draws=jax_lane_draws(jcfg, seeds), device="cpu")
    assert t["labels"] == j["labels"]
    for key in ("mean_age", "max_age", "frac_fresh", "km_frac"):
        assert t[key].shape == (len(j["labels"]), 10)
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    for key in ("loss", "res_norm"):
        np.testing.assert_allclose(t[key], j[key], rtol=2e-6, err_msg=key)
    # every lane refreshes exactly k coordinates every round
    np.testing.assert_array_equal(t["frac_fresh"], tcfg.k / tcfg.d)
    auto = [i for i, lab in enumerate(t["labels"]) if lab[0] == "fairk_auto"]
    static = [i for i in range(len(t["labels"])) if i not in auto]
    # static lanes keep their split; the controller moved an adaptive one
    assert (t["km_frac"][static] == t["km_frac"][static][:, :1]).all()
    assert (t["km_frac"][auto] != t["km_frac"][auto][:, :1]).any()


def test_run_sweep_draws_per_seed():
    """Without given draws every seed has its generator: a static lane and
    an adaptive lane of one seed and split coincide until the controller's
    first step (round 5)."""
    cfg = sweep.SweepConfig(d=96, n_clients=4, rounds=8)
    out = sweep.run_sweep(cfg, ("fairk", "fairk_auto"), (0.5,), 2,
                          device="cpu")
    lab = out["labels"]
    a, b = lab.index(("fairk", 0.5, 1)), lab.index(("fairk_auto", 0.5, 1))
    np.testing.assert_array_equal(out["loss"][a, :5], out["loss"][b, :5])
    assert not np.array_equal(out["loss"][0], out["loss"][1])
    assert np.isfinite(out["loss"]).all()


def test_unknown_policy_and_scenarios_raise():
    """The scenario lanes are ported (ROADMAP Queue 1 item 8): they run,
    and the reference's configuration errors are raised."""
    from repro_torch.core import channel, faults, population
    with pytest.raises(ValueError, match="sweep supports"):
        sweep.sweep_grid(("agetopk",), (0.5,), 1, sweep.SweepConfig())
    pc = population.PopulationConfig(n_clients=64, cohort_size=16,
                                      participants=16)
    for field, value in (("faults", faults.FaultConfig(dropout=0.2,
                                                       fade=0.1)),
                         ("population", pc),
                         ("wireless", channel.ChannelConfig(n_clients=16))):
        cfg = sweep.SweepConfig(d=32, rounds=2, **{field: value})
        out = sweep.run_sweep(cfg, ("fairk", "fairk_auto"), (0.5,), 1,
                              device="cpu")
        assert np.isfinite(out["loss"]).all()
    with pytest.raises(ValueError, match="wireless.n_clients"):
        sweep.SweepConfig(wireless=channel.ChannelConfig(n_clients=4))
    with pytest.raises(ValueError, match="participants"):
        sweep.SweepConfig(population=dataclasses.replace(pc, participants=4))
    with pytest.raises(ValueError, match="dropout"):
        sweep.SweepConfig(population=pc,
                          faults=faults.FaultConfig(dropout=0.1))
    # async lanes are ported (ROADMAP Queue 1 item 7)
    out = sweep.run_sweep(sweep.SweepConfig(d=32, rounds=2, async_lag=1),
                          device="cpu")
    assert np.isfinite(out["loss"]).all()
    with pytest.raises(ValueError, match="client_chunk"):
        sweep.SweepConfig(n_clients=16, client_chunk=3)


def test_client_chunks_give_the_same_lanes():
    kw = dict(d=64, n_clients=8, rounds=6)
    full = sweep.run_sweep(sweep.SweepConfig(**kw), ("fairk",), (0.5,), 2,
                           device="cpu")
    chunked = sweep.run_sweep(sweep.SweepConfig(client_chunk=4, **kw),
                              ("fairk",), (0.5,), 2, device="cpu")
    np.testing.assert_array_equal(full["mean_age"], chunked["mean_age"])
    np.testing.assert_allclose(full["loss"], chunked["loss"], rtol=1e-5)
