"""The port's wireless channel (``repro_torch.core.channel``), the weighted
one-bit fold and their trainer and sweep wiring against
``repro.core.channel``, ``repro.kernels`` and the JAX trainer and sweep, on
JAX's own draws.

Tolerances, per test:

* configs, path gains, outage and thin: exactly;
* the fading step: within one float32 ulp (2.4e-7 on |f| < 2) — the
  compiled reference forms ``fma(ρ, f, round(K·e))`` with its constants
  folded into the normal draw's ``erfinv`` value ``e``, which the port,
  given the normal itself, cannot reproduce on every coordinate; the CSI
  factor ``fma(σ_e, e, 1)`` within one ulp for the same reason;
* given the same chain, the power ``fma(f_im, f_im, round(f_re²))``, the
  gain, the ``sent`` gate, the block outage erasure: bit for bit / exact;
* the weighted vote fold (``ops.vote_fold(..., row=)``, the plain version
  on the CPU) against the reference trainer's ``sign_mv(one_bit(x)·row)``:
  bit for bit, rows with 0.0, −0.0, negative and NaN weights, NaN votes,
  with and without a gather;
* trainer rounds from JAX's state, fault state and draws (d = 1,400,
  N = 4): ages on at least 0.9999 of the coordinates, ``w`` within 1e-6,
  the fading chain within one ulp;
* a total-outage round (``gmin = 1e9``): ``g_t`` equals ``g_prev`` bit for
  bit, every age advances by one, nothing is selected, on every backend;
* sweep wireless lanes (d = 128, N = 4): ages, ``frac_fresh`` and
  ``n_sent`` exactly, ``loss`` within rtol 2e-6;
* the stationary AoU under the port chain's total outages (port
  generator): TV < 0.1 against ``markov.channel_aou_distribution``.
"""

import math

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

from repro.core import channel as jc
from repro.core import faults as jf
from repro.core import population as jp
from repro.core import quantize as jax_quantize
from repro.fl import sweep as jax_sweep
from repro.kernels import ops as jax_ops
from repro_torch.core import channel, faults, markov, packing, population
from repro_torch.core.engine import make_engine
from repro_torch.fl import sweep, trainer
from repro_torch.kernels import ops

pytestmark = pytest.mark.channel

WL = dict(n_clients=4, rho_f=0.9, csi_err=0.05, shadow_db=4.0, gmin=0.3)
ULP1 = 2.4e-7                  # one float32 ulp on magnitudes below 2


@pytest.fixture(scope="module")
def task():
    return small_fl_task(3)


def test_config_gains_outage_thin():
    for kw in (dict(), WL, dict(n_clients=7, near=1.0, pl_exp=0.0,
                                gmin=0.9)):
        t, j = channel.ChannelConfig(**kw), jc.ChannelConfig(**kw)
        np.testing.assert_array_equal(t.gains, j.gains)
        np.testing.assert_array_equal(t.outage, j.outage)
        assert (t.g_eff, t.thin) == (j.g_eff, j.thin)
    for bad in (dict(n_clients=0), dict(pmax=0.0), dict(gmin=-1.0),
                dict(rho_f=1.0), dict(csi_err=-0.1), dict(near=0.0),
                dict(block=0)):
        with pytest.raises(ValueError):
            channel.ChannelConfig(**bad)


def test_fading_power_gate_and_csi():
    n, key = 20000, jax.random.PRNGKey(4)
    tcfg = channel.ChannelConfig(**dict(WL, n_clients=n))
    jcfg = jc.ChannelConfig(**dict(WL, n_clients=n))
    j_state = jc.init_channel_state(jax.random.PRNGKey(3), jcfg)
    j_next, j_ps = jax.jit(lambda s, k: jc.channel_round(s, k, jcfg))(
        j_state, key)
    w = to_torch(jax.random.normal(key, (n, 2), jnp.float32))
    t_next, t_ps = channel.channel_round(
        {"fad": to_torch(j_state["fad"])}, w, tcfg)
    np.testing.assert_allclose(to_np(t_next["fad"]),
                               np.asarray(j_next["fad"]), rtol=0, atol=ULP1)
    # given the reference's chain, the power, gain and gate are exact
    gain = (torch.as_tensor(tcfg.gains.astype(np.float32))
            * channel.power(to_torch(j_next["fad"])))
    np.testing.assert_array_equal(to_np(gain), np.asarray(j_ps["gain"]))
    sent = (gain >= float(np.float32(tcfg.g_eff))).float()
    np.testing.assert_array_equal(to_np(sent), np.asarray(j_ps["sent"]))
    frac = float((to_np(t_ps["sent"]) != np.asarray(j_ps["sent"])).mean())
    assert frac < 1e-3
    e = to_torch(jax.random.normal(key, (n,), jnp.float32))
    np.testing.assert_allclose(
        to_np(channel.csi_weights(e, tcfg)),
        np.asarray(jax.jit(lambda k: jc.csi_weights(k, n, jcfg))(key)),
        rtol=0, atol=ULP1)
    off = channel.ChannelConfig(n_clients=n)
    assert torch.equal(channel.csi_weights(e, off), torch.ones(n))
    # the stationary start: √½ · normal, |f|² ~ Exp(1)
    st = channel.init_channel_state(torch.randn(n, 2), tcfg)
    assert abs(float(channel.power(st["fad"]).mean()) - 1.0) < 0.03


def test_block_chain_and_masks():
    cfg = channel.ChannelConfig(n_clients=2, near=1.0, pl_exp=0.0, gmin=1.0,
                                pmax=10.0, block=4)
    jcfg = jc.ChannelConfig(n_clients=2, near=1.0, pl_exp=0.0, gmin=1.0,
                            pmax=10.0, block=4)
    d = 4096
    nb = channel.n_blocks(d, cfg)
    assert nb == jc.n_blocks(d, jcfg) == 1024
    fad = channel.init_block_fading(nb, "cpu")
    assert fad.shape == (2 * nb,)
    assert torch.equal(fad, channel.init_block_fading(nb, "cpu"))
    # given the reference's chain and draw, the erasure is exact
    key = jax.random.PRNGKey(5)
    j_fad, j_er = jc.block_outage(jnp.asarray(to_np(fad)), key, d, jcfg)
    _, t_er = channel.block_outage(
        fad, to_torch(jax.random.normal(key, (nb, 2), jnp.float32)), d, cfg)
    thr = float(np.float32(-math.log1p(-cfg.thin)))
    want = channel.expand_block_mask(
        channel.power(to_torch(j_fad).reshape(nb, 2)) < thr, d, cfg.block)
    np.testing.assert_array_equal(to_np(want), np.asarray(j_er))
    assert float((to_np(t_er) != np.asarray(j_er)).mean()) < 1e-3
    # long-run marginal erasure rate -> thin (rho_f = 0)
    gen = torch.Generator().manual_seed(6)
    hits = []
    for _ in range(300):
        fad, er = channel.block_outage(
            fad, torch.randn(nb, 2, generator=gen), d, cfg)
        hits.append(float(er.mean()))
    assert abs(np.mean(hits) - cfg.thin) < 0.03
    # block erasure and the CSI factor are constant within a block
    u = to_torch(jax.random.uniform(key, (nb,)))
    np.testing.assert_array_equal(
        to_np(channel.block_erase_mask(u, d, 0.3, 4)),
        np.asarray(jax.jit(lambda k: jc.block_erase_mask(k, d, 0.3, 4))(
            key)))
    f = to_np(channel.csi_block_factor(
        torch.randn(5), 40, channel.ChannelConfig(n_clients=16, csi_err=0.2,
                                                  block=8))).reshape(5, 8)
    assert (f == f[:, :1]).all() and len(np.unique(f[:, 0])) == 5


@pytest.mark.parametrize("gather", [False, True])
def test_weighted_vote_fold_matches_the_reference_fold(gather):
    """``ops.vote_fold(acc, x, idx, row=row)`` against the JAX trainer's
    wireless fold ``acc + sign_mv(one_bit(x) · row[:, None])[1]``."""
    rng = np.random.default_rng(0)
    c, d = 10, 3000
    x = rng.normal(size=(c, d)).astype(np.float32)
    x[:, :40] = 0.0
    x[:, 40:80] = -0.0
    x[rng.random((c, d)) < 0.01] = np.nan
    row = np.array([1.0, 0.0, -0.0, -0.7, np.nan, 1.3, 0.0, 2.0, -1.0,
                    0.9], np.float32)
    idx = (rng.permutation(d)[:700] if gather else None)
    acc0 = rng.integers(-20, 20, size=700 if gather else d).astype(
        np.float32)
    xs = x[:, idx] if gather else x
    want = jnp.asarray(acc0) + jax_ops.sign_mv(
        jax_quantize.one_bit(jnp.asarray(xs)) * jnp.asarray(row)[:, None])[1]
    got = ops.vote_fold(to_torch(acc0), to_torch(x),
                        None if idx is None else torch.as_tensor(idx),
                        row=to_torch(row))
    np.testing.assert_array_equal(to_np(got).view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    # a zero weight of either sign votes +1, a negative one flips
    plain = ops.vote_fold(torch.zeros(d), to_torch(x))
    ones = ops.vote_fold(torch.zeros(d), to_torch(x),
                         row=torch.ones(c))
    assert torch.equal(plain, ones)


@pytest.mark.parametrize("backend,one_bit", [("exact", False),
                                             ("threshold", False),
                                             ("packed", False),
                                             ("exact", True),
                                             ("packed", True)])
def test_wireless_rounds_track_jax(task, backend, one_bit):
    params, batches = task
    jfl, tfl = scenario_fl_pair(
        backend, dict(wireless=jc.ChannelConfig(**WL)),
        dict(wireless=channel.ChannelConfig(**WL)), one_bit=one_bit)
    _, _, _, pairs = scenario_step_parity(jfl, tfl, params, batches)
    assert_step_parity(pairs, fad_atol=ULP1)


@pytest.mark.parametrize("backend", ["exact", "packed"])
def test_composed_rounds_track_jax(task, backend):
    """Faults, a population and the wireless channel together (packed),
    dropout and fades with the channel (exact)."""
    params, batches = task
    if backend == "packed":
        pkw = dict(n_clients=512, cohort_size=64, participants=4)
        fkw = dict(fade=0.05, nan_rate=1e-3, fade_block=64)
        jkw = dict(population=jp.PopulationConfig(**pkw),
                   faults=jf.FaultConfig(**fkw))
        tkw = dict(population=population.PopulationConfig(**pkw),
                   faults=faults.FaultConfig(**fkw))
    else:
        fkw = dict(dropout=0.2, fade=0.05, fade_block=64)
        jkw = dict(faults=jf.FaultConfig(**fkw))
        tkw = dict(faults=faults.FaultConfig(**fkw))
    jfl, tfl = scenario_fl_pair(
        backend, dict(wireless=jc.ChannelConfig(**WL), **jkw),
        dict(wireless=channel.ChannelConfig(**WL), **tkw))
    _, _, _, pairs = scenario_step_parity(jfl, tfl, params, batches)
    assert_step_parity(pairs, fad_atol=ULP1)


@pytest.mark.parametrize("backend,one_bit", [("exact", False),
                                             ("threshold", False),
                                             ("packed", False),
                                             ("packed", True)])
def test_total_outage_round_is_a_no_op(task, backend, one_bit):
    """An unreachable truncation threshold: no client ever transmits, so
    every round merges nothing — ``g_t`` stays ``g_prev``, every age
    advances by one and nothing is selected."""
    params, batches = task
    wl = channel.ChannelConfig(n_clients=4, near=1.0, pl_exp=0.0,
                               gmin=1e9, pmax=1e12)
    _, tfl = scenario_fl_pair(backend, {}, dict(wireless=wl),
                              one_bit=one_bit, rounds=2)
    state, unravel = trainer.init_server(torch_params(params), tfl,
                                         device="cpu")
    d = state.w.shape[0]
    step = trainer.make_fl_step(tfl, unravel, torch_loss, d, device="cpu")
    fstate = trainer.init_fault_state(tfl, state)
    gen = torch.Generator().manual_seed(0)
    g_prev = torch.randn(d, generator=gen)
    age = torch.randint(0, 50, (d,), generator=gen).to(torch.float32)
    w, sc = state.w, state.sel_count
    for t in range(2):
        xs, ys = batches[t]
        out = step(w, g_prev, age, sc, to_torch(xs), to_torch(ys),
                   state.residual, state.theta,
                   trainer.draw_round(gen, tfl, d, torch.device("cpu")),
                   state.ctrl, fstate)
        assert float(out[9]["chan"]["fad"].abs().sum()) > 0.0
        np.testing.assert_array_equal(to_np(out[1]).view(np.uint32),
                                      to_np(g_prev).view(np.uint32))
        np.testing.assert_array_equal(to_np(out[2]), to_np(age) + 1.0)
        assert float(out[5].sum()) == 0.0 and torch.equal(out[3], sc)
        np.testing.assert_array_equal(
            to_np(out[0]), to_np(w - tfl.global_lr * g_prev))
        w, g_prev, age, fstate = out[0], out[1], out[2], out[9]


def test_sweep_wireless_lanes_match_jax():
    kw = dict(d=128, n_clients=4, rounds=6)
    wkw = dict(n_clients=4, rho_f=0.5, csi_err=0.05, gmin=0.2)
    fkw = dict(dropout=0.2, fade=0.1, nan_rate=0.01, fade_block=16)
    jcfg = jax_sweep.SweepConfig(wireless=jc.ChannelConfig(**wkw),
                                 faults=jf.FaultConfig(**fkw), **kw)
    tcfg = sweep.SweepConfig(wireless=channel.ChannelConfig(**wkw),
                             faults=faults.FaultConfig(**fkw), **kw)
    pols, fracs = ("fairk", "fairk_auto"), (0.5,)
    j = jax_sweep.run_sweep(jcfg, pols, fracs, 2)
    seeds = sweep.sweep_grid(pols, fracs, 2, tcfg)[0]
    t = sweep.run_sweep(tcfg, pols, fracs, 2,
                        draws=jax_sweep_lane_draws(jcfg, seeds),
                        device="cpu")
    for key in ("mean_age", "max_age", "frac_fresh", "n_sent"):
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=2e-6)


@pytest.mark.parametrize("backend", ["exact", "packed"])
def test_stationary_aou_under_truncation_outage(backend):
    """Total truncation outages of the port's memoryless chain erase whole
    rounds; the stationary AoU follows the channel's thinned Lemma-1
    law."""
    d, k, k_m, rounds = 512, 64, 32, 600
    cfg = channel.ChannelConfig(n_clients=4, near=1.0, pl_exp=0.0,
                                gmin=0.9, pmax=10.0)       # thin ~ 0.124
    gen = torch.Generator().manual_seed(0)
    st = channel.init_channel_state(torch.randn(4, 2, generator=gen), cfg)
    masks = []
    for _ in range(rounds):
        st, ps = channel.channel_round(st, torch.randn(4, 2, generator=gen),
                                       cfg)
        masks.append(np.ones(d, np.float32) if float(ps["n_sent"]) == 0.0
                     else None)
    assert abs(sum(m is not None for m in masks) / rounds - cfg.thin) < 0.05
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
    acc = port_age_hist(eng, d, lambda r: masks[r], rounds=rounds,
                        tstate=ts, count_erased=True)
    k0 = int(round(k_m * (1 - k_m / d)))
    support, pred = markov.channel_aou_distribution(
        markov.FairKChain(d=d, k=k, k_m=k_m, k0=k0), cfg.pmax, cfg.gmin,
        cfg.gains)
    statutil.assert_pmf_close(acc, support, pred)
