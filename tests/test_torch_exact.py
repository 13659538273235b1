"""The port's exact-backend FL round (the path every paper figure runs)
against the JAX trainer on the narrow prototype CNN of ``torchutil``
(d = 1400), N = 4 clients in chunks of 2, H = 2, B = 3, ρ = 0.2, three
rounds per configuration.

Both sides take the same draws: the JAX trainer's fading, noise (k,) and,
for toprand / randk, the uniform selection draw (d,), from its named key
ladder, handed to the port as tensors.

* The server step, fed JAX's own compacted (k,) aggregate (recorded
  inside the compiled JAX round), selects anew from ``(g_prev, age)`` and
  gives exactly JAX's ages and participation counts, and its ``g_t`` bit
  for bit — at N = 4 and, where 1/N is not a power of two and the
  compiled reference multiplies by the float32 ``1/N``, at N = 5 and
  N = 50 — except with receiver noise on the coherent uplink, where XLA
  folds the ``noise_std`` scale into the normal draw inside its
  compiled round (the eager draw handed to the port is the same ``z``,
  the in-round product differs in the last place): there ``g_t`` is held
  within rtol 1e-6 and atol 2e-8 (a few ulps of the noise term
  ``0.1·z/N``, which reaches 0.1).  ``w`` within rtol 1e-6 (XLA contracts
  the model step into a fused multiply-add).
* Whole rounds (each side's own clients): ``w`` within atol 1e-5, ages
  equal on at least 99.9% of the coordinates (a float32 gradient summed in
  another order can move a coordinate across the top-k boundary).
* ``train(..., device="cpu")`` runs all six policies on the coherent
  uplink and fairk / topk / toprand on the one-bit uplink.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torchutil import (exact_round_draws, run_jax_rounds, small_fl_task,
                       to_np, to_torch, torch_loss, torch_params)

from repro.core import oac as jax_oac
from repro.core import quantize as jax_quantize
from repro.fl import trainer as jax_trainer
from repro_torch.core import oac
from repro_torch.fl import trainer
from repro_torch.models import cnn

ROUNDS = 3
COHERENT = dict(fading="rayleigh", mean=1.0, noise_std=0.1)
ONE_BIT = dict(fading="none", mean=1.0, noise_std=2.0)


def _pair(policy="fairk", one_bit=False, ef=False, noise=True, n=4):
    kw = dict(n_clients=n, local_steps=2, batch_size=3, local_lr=0.05,
              global_lr=0.05, rounds=ROUNDS, backend="exact",
              client_chunk={4: 2, 5: 5, 50: 10}[n], compression_ratio=0.2,
              seed=0, policy=policy, one_bit=one_bit, error_feedback=ef)
    if one_bit:
        kw.update(local_lr=0.003, global_lr=0.003)
    ch = dict(ONE_BIT if one_bit else COHERENT)
    if not noise:
        ch["noise_std"] = 0.0
    return (jax_trainer.FLConfig(channel=jax_oac.ChannelConfig(**ch), **kw),
            trainer.FLConfig(channel=oac.ChannelConfig(**ch), **kw))


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


def _run_jax(jfl, params, batches):
    """The JAX rounds, with the compacted aggregate recorded where the
    receiver tail receives it."""
    spies = [(jax_quantize, "fsk_majority_from_energy", "agg", 1)
             if jfl.one_bit else (jax_oac, "finish_aggregate", "agg", 1)]
    return run_jax_rounds(jfl, params, batches,
                          lambda key, d: exact_round_draws(key, jfl, d),
                          spies)


def _draws(rnd):
    return {k: to_torch(v) for k, v in rnd["draws"].items()}


@pytest.mark.parametrize("policy,one_bit,noise,n", [
    ("fairk", False, False, 4), ("fairk", False, True, 4),
    ("fairk", True, True, 4), ("toprand", False, False, 4),
    ("roundrobin", True, True, 4), ("fairk", False, False, 5),
    ("fairk", False, False, 50), ("toprand", False, False, 5)])
def test_server_step_on_jax_aggregate_is_exact(tasks, policy, one_bit,
                                               noise, n):
    params, batches = tasks(n)
    jfl, tfl = _pair(policy, one_bit, noise=noise, n=n)
    jax_rounds, d = _run_jax(jfl, params, batches)
    _, unravel = cnn.ravel_params(torch_params(params))
    step = trainer.make_fl_step(tfl, unravel, torch_loss, d, device="cpu")
    for t, rnd in enumerate(jax_rounds):
        w, g, age, sc, res, ts, _ = rnd["before"]
        agg = rnd["captured"]["agg"]
        assert agg.shape == (tfl.budgets(d)[0],)
        out = step.server_phase(to_torch(w), to_torch(agg), None,
                                to_torch(g), to_torch(age), to_torch(sc),
                                to_torch(res), None, _draws(rnd))
        w2, g2, age2, sc2, _, _ = rnd["after"]
        np.testing.assert_array_equal(to_np(out[2]), np.asarray(age2),
                                      err_msg=f"round {t} ages")
        np.testing.assert_array_equal(to_np(out[3]), np.asarray(sc2))
        if one_bit or not noise:
            np.testing.assert_array_equal(to_np(out[1]).view(np.uint32),
                                          np.asarray(g2).view(np.uint32),
                                          err_msg=f"round {t} g_t")
        else:
            np.testing.assert_allclose(to_np(out[1]), np.asarray(g2),
                                       rtol=1e-6, atol=2e-8)
        np.testing.assert_allclose(to_np(out[0]), np.asarray(w2),
                                   rtol=1e-6, atol=1e-7)
        assert float(out[5].sum()) == tfl.budgets(d)[0]


WHOLE = [("fairk", False, False), ("fairk", True, False),
         ("fairk", False, True), ("fairk", True, True),
         ("topk", False, False), ("roundrobin", False, False),
         ("toprand", False, False), ("agetopk", False, False),
         ("randk", False, False)]


@pytest.mark.parametrize("policy,one_bit,ef", WHOLE)
def test_whole_exact_rounds_track_the_jax_trainer(task, policy, one_bit,
                                                  ef):
    params, batches = task
    jfl, tfl = _pair(policy, one_bit, ef)
    jax_rounds, d = _run_jax(jfl, params, batches)
    state, unravel = trainer.init_server(torch_params(params), tfl,
                                         device="cpu")
    step = trainer.make_fl_step(tfl, unravel, torch_loss, d, device="cpu")
    w, g, age, sc = state.w, state.g, state.age, state.sel_count
    res, ts = state.residual, state.theta
    for t, rnd in enumerate(jax_rounds):
        xs, ys = batches[t]
        w, g, age, sc, res, _, ts, _, _ = step(
            w, g, age, sc, to_torch(xs), to_torch(ys), res, ts, _draws(rnd))
        jw, _, jage, jsc, jres, _ = rnd["after"]
        np.testing.assert_allclose(to_np(w), np.asarray(jw), rtol=0,
                                   atol=1e-5, err_msg=f"round {t} w")
        agree = float((to_np(age) == np.asarray(jage)).mean())
        assert agree >= 0.999, f"round {t}: ages agree on {agree:.5f}"
        if ef:
            np.testing.assert_allclose(to_np(res), np.asarray(jres),
                                       rtol=0, atol=1e-5)
        assert float(sc.sum()) == float(np.asarray(jsc).sum())


@pytest.mark.parametrize("policy,one_bit", [
    (p, False) for p in trainer.selection.POLICIES]
    + [(p, True) for p in ("fairk", "topk", "toprand")])
def test_train_runs_every_policy_on_the_exact_backend(task, policy,
                                                      one_bit):
    params, batches = task
    _, tfl = _pair(policy, one_bit, ef=one_bit)
    hist = trainer.train(tfl, torch_params(params), torch_loss,
                         lambda t: batches[t % ROUNDS], device="cpu")
    d, k = hist["d"], hist["k"]
    assert hist["n_selected"] == [float(k)] * ROUNDS
    assert float(hist["state"].sel_count.sum()) == ROUNDS * k
    assert torch.isfinite(hist["state"].w).all()
    age = hist["final_age"]
    assert (age == 0.0).sum() == k and age.max() <= ROUNDS
    if policy == "roundrobin":
        # equal ages on round 0: the lower-index tie-break cycles
        assert age[:k].max() == ROUNDS - 1 and (age[k:2 * k] == 1).all()


def test_draw_round_shapes():
    gen = torch.Generator().manual_seed(0)
    d = 1000
    for policy, one_bit in (("fairk", False), ("randk", False),
                            ("toprand", True)):
        _, tfl = _pair(policy, one_bit)
        draws = trainer.draw_round(gen, tfl, d, torch.device("cpu"))
        k = tfl.budgets(d)[0]
        assert draws["z"].shape == (k,)
        assert ("h" in draws) == (not one_bit)
        assert ("u" in draws) == (policy in ("randk", "toprand"))
        if "u" in draws:
            assert draws["u"].shape == (d,)
            assert 0.0 <= float(draws["u"].min()) < float(
                draws["u"].max()) < 1.0
    _, packed = _pair()
    packed = dataclasses.replace(packed, backend="packed")
    assert trainer.draw_round(gen, packed, d, torch.device("cpu"))[
        "z"].shape == (d,)
