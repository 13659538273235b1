"""The port's FL round (the slice as a whole) against the JAX trainer on a
narrow prototype CNN (16x16x1 input, widths (4, 6, 8), fc 16, 10 classes),
N = 4 clients in chunks of 2, H = 2, B = 3, three rounds each of packed
coherent, packed one-bit and packed + error feedback.

Both sides take the same draws: the JAX trainer's fading and noise from
its named key ladder, handed to the port as tensors.

* The server phase, fed JAX's own aggregate (recorded inside the compiled
  JAX round), gives exactly JAX's ages; without receiver noise, at N = 5
  and N = 50 as well, its ``g_t`` bit for bit, and on the one-bit uplink
  with error feedback its residual ``(ef_sum / N)·(1 − mask)`` bit for bit
  against the compiled JAX expression (XLA multiplies by the float32
  ``1/N``; so does the port, ``oac.reciprocal``).
* Whole rounds (each side's own clients): ``w`` within atol 1e-5, ages
  equal on at least 99.9% of the coordinates (a float32 gradient summed in
  another order can move a coordinate across a threshold).
* The one-bit uplink's two call sites on the same inputs: the chunk fold
  (``ops.vote_fold``) against the JAX trainer's ``fold_votes`` on both
  backends, and the detection fed the draw ``z`` (with the packed path's
  score) against the JAX receiver: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torchutil import (round_draws, run_jax_rounds, small_fl_task, to_np,
                       to_torch, torch_loss, torch_params)

from repro.core import engine as jax_engine_mod
from repro.core import oac as jax_oac
from repro.core import quantize as jax_quantize
from repro.fl import trainer as jax_trainer
from repro.kernels import ops as jax_ops
from repro_torch.core import oac, quantize
from repro_torch.fl import trainer
from repro_torch.kernels import ops
from repro_torch.models import cnn

ROUNDS = 3


def _configs():
    base = dict(n_clients=4, local_steps=2, batch_size=3, local_lr=0.05,
                global_lr=0.05, rounds=ROUNDS, backend="packed",
                client_chunk=2, compression_ratio=0.2, seed=0)
    coh = dict(fading="rayleigh", mean=1.0, noise_std=0.1)
    quiet = dict(coh, noise_std=0.0)
    ob = dict(fading="none", mean=1.0, noise_std=2.0)
    one_bit = dict(base, channel=ob, local_lr=0.003, global_lr=0.003)
    return {
        "coherent": (dict(base, channel=coh), {}),
        "one_bit": (one_bit, dict(one_bit=True)),
        "ef": (dict(base, channel=coh), dict(error_feedback=True)),
        "quiet_n5": (dict(base, channel=quiet, n_clients=5,
                          client_chunk=5), {}),
        "quiet_n50": (dict(base, channel=quiet, n_clients=50,
                           client_chunk=10), {}),
        "one_bit_ef_n50": (dict(one_bit, n_clients=50, client_chunk=10),
                           dict(one_bit=True, error_feedback=True)),
    }


def _pair(name):
    kw, extra = _configs()[name]
    jfl = jax_trainer.FLConfig(
        **{**kw, "channel": jax_oac.ChannelConfig(**kw["channel"])}, **extra)
    tfl = trainer.FLConfig(
        **{**kw, "channel": oac.ChannelConfig(**kw["channel"])}, **extra)
    return jfl, tfl


@pytest.fixture(scope="module")
def task():
    return small_fl_task(ROUNDS)


@pytest.fixture(scope="module")
def tasks(task):
    """The task for N clients, built once per N."""
    cache = {4: task}

    def get(n):
        if n not in cache:
            cache[n] = small_fl_task(ROUNDS, n)
        return cache[n]
    return get


def _run_jax(jfl, params, batches, capture=False):
    """The JAX trainer's loop; with ``capture`` the server-phase inputs
    (the engine's score, the one-bit vote energy) recorded from inside the
    compiled round."""
    spies = ([(jax_engine_mod.SelectionEngine, "select_and_merge", "score",
               1), (jax_ops, "sign_from_energy", "energy", 0)]
             if capture else [])
    return run_jax_rounds(
        jfl, params, batches,
        lambda key, d: round_draws(key, jfl.n_clients, d, jfl.channel),
        spies)


def _torch_tstate(ts):
    return {k: to_torch(v) for k, v in ts.items()}


@pytest.mark.parametrize("name", ["coherent", "one_bit", "ef", "quiet_n5",
                                  "quiet_n50", "one_bit_ef_n50"])
def test_server_phase_on_jax_aggregate_gives_exact_ages(tasks, name):
    jfl, tfl = _pair(name)
    params, batches = tasks(tfl.n_clients)
    jax_rounds, d = _run_jax(jfl, params, batches, capture=True)
    _, unravel = cnn.ravel_params(torch_params(params))
    step = trainer.make_fl_step(tfl, unravel, torch_loss, d, device="cpu")
    n = tfl.n_clients
    ob_ef = tfl.one_bit and tfl.error_feedback
    for t, rnd in enumerate(jax_rounds):
        w, g, age, sc, res, ts, _ = rnd["before"]
        agg = (rnd["captured"]["energy"] if tfl.one_bit
               else rnd["captured"]["score"])
        draws = {k: to_torch(v) for k, v in rnd["draws"].items()}
        # the one-bit EF residual's input: a seeded Σ_n eff_n
        ef_sum = (np.random.default_rng(t).normal(size=d) * 3.0).astype(
            np.float32) if ob_ef else None
        out = step.server_phase(to_torch(w), to_torch(agg),
                                None if ef_sum is None else to_torch(ef_sum),
                                to_torch(g), to_torch(age), to_torch(sc),
                                to_torch(res), _torch_tstate(ts), draws)
        w2, g2, age2, sc2, res2, ts2 = rnd["after"]
        np.testing.assert_array_equal(to_np(out[2]), np.asarray(age2),
                                      err_msg=f"round {t} ages")
        np.testing.assert_array_equal(to_np(out[3]), np.asarray(sc2))
        if tfl.channel.noise_std == 0.0 or tfl.one_bit:
            np.testing.assert_array_equal(_bits(out[1]), _bits(g2),
                                          err_msg=f"round {t} g_t")
        else:
            np.testing.assert_allclose(to_np(out[1]), np.asarray(g2),
                                       rtol=1e-6, atol=1e-7)
        if ob_ef:
            sel = (np.asarray(age2) == 0.0).astype(np.float32)
            want = jax.jit(lambda e, m: (e / n) * (1.0 - m))(
                jnp.asarray(ef_sum), jnp.asarray(sel))
            np.testing.assert_array_equal(_bits(out[4]), _bits(want))
        np.testing.assert_allclose(to_np(out[0]), np.asarray(w2), rtol=1e-6,
                                   atol=1e-7)
        if tfl.error_feedback and not ob_ef:
            np.testing.assert_allclose(to_np(out[4]), np.asarray(res2),
                                       rtol=1e-6, atol=1e-7)
        for key in ("theta_m", "theta_a", "n_sel", "n_sel_m", "streak"):
            np.testing.assert_allclose(to_np(out[6][key]),
                                       np.asarray(ts2[key]), rtol=1e-6)
        for key in ("mag_hist", "age_hist"):
            np.testing.assert_array_equal(to_np(out[6][key]),
                                          np.asarray(ts2[key]))
        if t == 0:
            assert float(out[8]["n_selected"]) == d       # full refresh


@pytest.mark.parametrize("name", ["coherent", "one_bit", "ef"])
def test_whole_rounds_track_the_jax_trainer(task, name):
    params, batches = task
    jfl, tfl = _pair(name)
    jax_rounds, d = _run_jax(jfl, params, batches)
    state, unravel = trainer.init_server(torch_params(params), tfl,
                                         device="cpu")
    np.testing.assert_array_equal(to_np(state.w),
                                  np.asarray(ravel_pytree(params)[0]))
    step = trainer.make_fl_step(tfl, unravel, torch_loss, d, device="cpu")
    w, g, age, sc = state.w, state.g, state.age, state.sel_count
    res, ts = state.residual, state.theta
    for t, rnd in enumerate(jax_rounds):
        xs, ys = batches[t]
        draws = {k: to_torch(v) for k, v in rnd["draws"].items()}
        w, g, age, sc, res, _, ts, _, _ = step(
            w, g, age, sc, to_torch(xs), to_torch(ys), res, ts, draws)
        jw, _, jage, _, _, _ = rnd["after"]
        np.testing.assert_allclose(to_np(w), np.asarray(jw), rtol=0,
                                   atol=1e-5, err_msg=f"round {t} w")
        agree = float((to_np(age) == np.asarray(jage)).mean())
        assert agree >= 0.999, f"round {t}: ages agree on {agree:.5f}"


def test_train_runs_and_reports(task):
    params, batches = task
    _, tfl = _pair("one_bit")
    tfl = dataclasses.replace(tfl, error_feedback=True)
    hist = trainer.train(tfl, torch_params(params), torch_loss,
                         lambda t: batches[t % ROUNDS], device="cpu")
    assert hist["n_selected"][0] == hist["d"]
    assert len(hist["round_ms"]) == ROUNDS
    assert all(np.isfinite(hist["mean_aou"]))
    assert hist["state"].w.device.type == "cpu"


def test_unsupported_settings_raise():
    """The scenario layers are ported (ROADMAP Queue 1 item 8): they build
    on every backend, and the reference's validation errors are raised
    for the combinations it rejects, with its messages."""
    from repro_torch.core import channel, faults, population
    _, tfl = _pair("coherent")
    fc = faults.FaultConfig(dropout=0.2, fade=0.05)
    pc = population.PopulationConfig(n_clients=64, cohort_size=16,
                                      participants=4)
    wc = channel.ChannelConfig(n_clients=4)
    wd = faults.WatchdogConfig()
    for backend in ("packed", "threshold", "exact"):
        for change in (dict(faults=fc), dict(watchdog=wd),
                       dict(population=pc),
                       dict(population=pc, faults=faults.FaultConfig(
                           fade=0.05, nan_rate=0.01)),
                       dict(wireless=wc), dict(wireless=wc, one_bit=True),
                       dict(wireless=wc, population=pc, watchdog=wd)):
            trainer.make_fl_step(
                dataclasses.replace(tfl, backend=backend, **change),
                lambda w: w, torch_loss, 8, device="cpu")
        for change, match in (
                (dict(faults=fc, one_bit=True), "one-bit"),
                (dict(faults=fc, policy="randk"), "index arithmetic"),
                (dict(wireless=wc, policy="agetopk"), "index arithmetic"),
                (dict(watchdog=wd, policy="topk"), "watchdog"),
                (dict(wireless=channel.ChannelConfig(n_clients=5)),
                 "wireless.n_clients"),
                (dict(population=dataclasses.replace(pc, participants=3)),
                 "participants"),
                (dict(population=pc, faults=faults.FaultConfig(
                    dropout=0.1)), "dropout"),
                (dict(population=pc, one_bit=True), "one-bit")):
            with pytest.raises(ValueError, match=match):
                trainer.make_fl_step(
                    dataclasses.replace(tfl, backend=backend, **change),
                    lambda w: w, torch_loss, 8, device="cpu")
    # the index-form policies run on the exact backend only, as in JAX
    for policy in ("randk", "toprand", "agetopk"):
        with pytest.raises(ValueError, match="index arithmetic"):
            trainer.make_fl_step(dataclasses.replace(tfl, policy=policy),
                                 lambda w: w, torch_loss, 8, device="cpu")
        trainer.make_fl_step(
            dataclasses.replace(tfl, policy=policy, backend="exact"),
            lambda w: w, torch_loss, 8, device="cpu")
    with pytest.raises(ValueError, match="client_chunk"):
        trainer.make_fl_step(dataclasses.replace(tfl, client_chunk=3),
                             lambda w: w, torch_loss, 8, device="cpu")
    with pytest.raises(ValueError, match="async_lag"):
        trainer.make_fl_step(dataclasses.replace(tfl, async_lag=-1),
                             lambda w: w, torch_loss, 8, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        trainer.make_fl_step(dataclasses.replace(tfl, backend="sharded"),
                             lambda w: w, torch_loss, 8, device="cpu")
    # the threshold backend (ROADMAP Queue 1 item 3), async lag and
    # scan_rounds (item 7) are ported: they build on every backend
    for backend in ("threshold", "packed", "exact"):
        for change in (dict(), dict(async_lag=1), dict(scan_rounds=4)):
            trainer.make_fl_step(
                dataclasses.replace(tfl, backend=backend, **change),
                lambda w: w, torch_loss, 8, device="cpu")
    # the adaptive split is ported: it builds on both backends, for FAIR-k
    for backend in ("packed", "exact"):
        for change in (dict(adaptive_km=True), dict(policy="fairk_auto")):
            trainer.make_fl_step(
                dataclasses.replace(tfl, backend=backend, **change),
                lambda w: w, torch_loss, 8, device="cpu")
        with pytest.raises(ValueError, match="adaptive_km"):
            trainer.make_fl_step(
                dataclasses.replace(tfl, backend=backend, adaptive_km=True,
                                    policy="roundrobin"),
                lambda w: w, torch_loss, 8, device="cpu")


def _bits(t):
    return to_np(t).view(np.uint32)


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_one_bit_fold_matches_jax_fold_votes(exact, ef):
    """The one-bit chunk fold as ``clients_fold`` runs it (one
    ``ops.vote_fold`` per chunk of effective gradients) against the JAX
    trainer's ``fold_votes`` on the same gradients: packed,
    ``acc + sign_mv(one_bit(eff))[1]``; exact, ``acc +
    one_bit(eff[:, idx]).sum(0)`` at an unsorted selection.  Bit for
    bit, signed zeros and NaN gradients included."""
    n, chunk, d = 8, 2, 1400
    rng = np.random.default_rng(int(exact) + 2 * int(ef))
    grads = (rng.normal(size=(n, d)) * 0.01).astype(np.float32)
    grads[rng.random((n, d)) < 0.03] = 0.0
    grads[rng.random((n, d)) < 0.03] = -0.0
    grads[1, :4] = np.nan
    residual = (rng.normal(size=d) * 0.01).astype(np.float32)
    residual[:50] = 0.0
    idx = rng.permutation(d)[:280] if exact else None
    k = d if idx is None else idx.shape[0]
    j_acc = jnp.zeros((k,), jnp.float32)
    t_acc = torch.zeros(k)
    for c0 in range(0, n, chunk):
        g = jnp.asarray(grads[c0:c0 + chunk])
        eff = g + jnp.asarray(residual)[None, :] if ef else g
        if exact:
            j_acc = j_acc + jax_quantize.one_bit(eff[:, idx]).sum(axis=0)
        else:
            j_acc = j_acc + jax_ops.sign_mv(jax_quantize.one_bit(eff))[1]
        g_t = to_torch(grads[c0:c0 + chunk])
        eff_t = g_t + to_torch(residual).unsqueeze(0) if ef else g_t
        ops.vote_fold(t_acc, eff_t, None if idx is None else to_torch(idx))
    np.testing.assert_array_equal(_bits(t_acc), _bits(j_acc))


@pytest.mark.parametrize("noise_std", [0.0, 2.0])
@pytest.mark.parametrize("exact", [False, True])
def test_one_bit_detection_matches_jax_receiver(exact, noise_std):
    """The detection fed the round's draw ``z``: on the exact path
    ``quantize.fsk_majority_from_energy`` against the JAX receiver drawing
    the same ``z`` from its key; on the packed path the one fused call
    ``(signs, energy, score)`` against ``ops.sign_from_energy`` on
    ``noise_std * z`` and ``|energy| + index_jitter(d)``."""
    d = 1400
    key = jax.random.PRNGKey(7)
    rng = np.random.default_rng(4)
    agg = (2.0 * rng.integers(-4, 5, size=d)).astype(np.float32)
    z = jax.random.normal(key, (d,), jnp.float32)
    if exact:
        j = jax_quantize.fsk_majority_from_energy(key, jnp.asarray(agg),
                                                  noise_std=noise_std)
        t = quantize.fsk_majority_from_energy(to_torch(agg), to_torch(z),
                                              noise_std)
        np.testing.assert_array_equal(to_np(t), np.asarray(j))
        return
    noise = noise_std * z if noise_std > 0.0 else None
    js, je = jax_ops.sign_from_energy(jnp.asarray(agg), noise=noise)
    j_score = jnp.abs(je) + jax_engine_mod.index_jitter(d)
    ts, te, t_score = ops.sign_from_energy(
        to_torch(agg), z=to_torch(z), noise_std=noise_std, score=True)
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    np.testing.assert_array_equal(_bits(te), _bits(je))
    np.testing.assert_array_equal(_bits(t_score), _bits(j_score))
