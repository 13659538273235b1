"""The port's adaptive budget controller (``repro_torch.core.controller``)
against ``repro.core.controller``, the JAX functions compiled with
``jax.jit`` as the trainer's round compiles them.

* The Lemma-1 target table is numpy on both sides: identical.
* ``pmf_quantile``: the cut bin exactly, the value within rtol 1e-6 and
  atol 1e-6 (XLA's float32 cumsum may add in another order than
  ``torch.cumsum``, and the cdf's last bit is divided by the cut bin's
  mass);
  ``staleness_pmf`` and ``target_for`` (``jnp.interp`` written out) within
  rtol 1e-6.
* A 30-round ``update`` trajectory on seeded histograms, with and without
  ``mag_hist``, with ``age_offset`` / ``thin`` and with a fixed
  ``target_age``: ``init``, ``tick`` and the actuation rounds exactly,
  ``k_m_frac`` and ``prev_step`` within atol 1e-6, the EMAs within rtol
  1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import to_np, to_torch

from repro.core import controller as jax_controller
from repro_torch.core import controller


def _hists(seed, rounds=30):
    """Per round an age histogram (1,000 Poisson ages whose mean swings
    between 1 and 40, so the quantile leaves the deadband both ways) and a
    magnitude histogram."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        lam = 1.0 + 39.0 * (0.5 + 0.5 * np.sin(r / 4.0))
        ages = np.minimum(rng.poisson(lam, 1000), 127)
        age_hist = np.bincount(ages, minlength=128).astype(np.float32)
        mag_hist = rng.integers(0, 30, 128).astype(np.float32)
        out.append((age_hist, mag_hist))
    return out


@pytest.mark.parametrize("rho", [0.05, 0.1, 0.2, 0.5])
@pytest.mark.parametrize("cfg", [dict(), dict(target_quantile=0.5,
                                              table_points=5,
                                              min_frac=0.2)])
def test_lemma1_target_table_is_identical(rho, cfg):
    t = controller.lemma1_target_table(controller.ControllerConfig(**cfg),
                                       rho)
    j = jax_controller.lemma1_target_table(
        jax_controller.ControllerConfig(**cfg), rho)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_configs_and_state_match():
    t, j = controller.ControllerConfig(), jax_controller.ControllerConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert controller.CTRL_SCALAR_FIELDS == jax_controller.CTRL_SCALAR_FIELDS
    assert (controller.CONTROLLER_STATE_SIZE
            == jax_controller.CONTROLLER_STATE_SIZE)
    ts = controller.init_controller_state(0.6)
    js = jax_controller.init_controller_state(0.6)
    for key in js:
        np.testing.assert_array_equal(to_np(ts[key]), np.asarray(js[key]))
        assert ts[key].dtype == torch.float32


def test_state_vector_round_trip():
    ts = controller.init_controller_state(0.3)
    rng = np.random.default_rng(0)
    ts["age_ema"] = to_torch(rng.random(128).astype(np.float32))
    ts["mag_ema"] = to_torch(rng.random(128).astype(np.float32))
    ts["tick"] = torch.tensor(3.0)
    vec = controller.controller_state_to_vec(ts)
    assert vec.shape == (controller.CONTROLLER_STATE_SIZE,)
    back = controller.controller_state_from_vec(vec)
    for key in ts:
        np.testing.assert_array_equal(to_np(back[key]), to_np(ts[key]))
    jvec = jax_controller.controller_state_to_vec(
        {k: jnp.asarray(to_np(v)) for k, v in ts.items()})
    np.testing.assert_array_equal(to_np(vec), np.asarray(jvec))


@pytest.mark.parametrize("q", [0.1, 0.5, 0.9, 0.99])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_staleness_pmf_and_quantile_match_jax(seed, q):
    age_hist = _hists(seed, 3)[2][0]
    if seed == 2:
        age_hist[:] = 0.0
        age_hist[7] = 5.0                   # one atom
    j_pmf = jax.jit(jax_controller.staleness_pmf)(jnp.asarray(age_hist))
    t_pmf = controller.staleness_pmf(to_torch(age_hist))
    np.testing.assert_allclose(to_np(t_pmf), np.asarray(j_pmf), rtol=1e-6)
    jq = float(jax.jit(jax_controller.pmf_quantile, static_argnums=1)(
        j_pmf, q))
    tq = float(controller.pmf_quantile(t_pmf, q))
    assert int(tq) == int(jq)                # the cut bin
    np.testing.assert_allclose(tq, jq, rtol=1e-6, atol=1e-6)
    # a batch of lanes gives each lane its own quantile
    both = controller.pmf_quantile(torch.stack([t_pmf, t_pmf.flip(0)]), q)
    assert float(both[0]) == tq
    assert float(both[1]) == float(controller.pmf_quantile(t_pmf.flip(0), q))


@pytest.mark.parametrize("target_age,age_offset,thin", [
    (None, 0.0, 0.0), (None, 2.0, 0.1), (12.0, 0.0, 0.0)])
def test_target_for_matches_jax(target_age, age_offset, thin):
    cfg = dict(target_age=target_age)
    t = controller.BudgetController(controller.ControllerConfig(**cfg),
                                    rho=0.1, age_offset=age_offset,
                                    thin=thin)
    j = jax_controller.BudgetController(
        jax_controller.ControllerConfig(**cfg), rho=0.1,
        age_offset=age_offset, thin=thin)
    assert t.age_offset == j.age_offset
    fracs = np.array([0.0, 0.05, 0.1, 0.2, 0.35, 0.5, 0.65, 0.8, 0.95,
                      0.97, 1.0], np.float32)
    jt = jax.jit(jax.vmap(j.target_for))(jnp.asarray(fracs))
    tt = t.target_for(to_torch(fracs))
    np.testing.assert_allclose(to_np(tt), np.asarray(jt), rtol=1e-6)
    for f in fracs[:3]:
        np.testing.assert_allclose(
            float(t.target_for(torch.tensor(f))),
            float(jax.jit(j.target_for)(jnp.float32(f))), rtol=1e-6)


@pytest.mark.parametrize("mag,target_age,age_offset,thin", [
    (False, None, 0.0, 0.0), (True, None, 0.0, 0.0),
    (False, None, 3.0, 0.2), (True, 8.0, 0.0, 0.0)])
def test_update_trajectory_matches_jax(mag, target_age, age_offset, thin):
    kw = dict(target_age=target_age)
    t = controller.BudgetController(controller.ControllerConfig(**kw),
                                    rho=0.1, age_offset=age_offset,
                                    thin=thin)
    j = jax_controller.BudgetController(
        jax_controller.ControllerConfig(**kw), rho=0.1,
        age_offset=age_offset, thin=thin)
    ts = controller.init_controller_state(0.75)
    js = j.init_state(0.75)
    j_update = jax.jit(j.update)
    acted = 0
    for r, (age_hist, mag_hist) in enumerate(_hists(7)):
        m_t = to_torch(mag_hist) if mag else None
        m_j = jnp.asarray(mag_hist) if mag else None
        ts = t.update(ts, to_torch(age_hist), m_t)
        js = j_update(js, jnp.asarray(age_hist), m_j)
        for key in ("init", "tick"):
            assert float(ts[key]) == float(js[key]), f"round {r} {key}"
        for key in ("k_m_frac", "prev_step"):
            assert abs(float(ts[key]) - float(js[key])) <= 1e-6, (
                f"round {r} {key}: {float(ts[key])} vs {float(js[key])}")
        for key in ("age_ema", "mag_ema"):
            np.testing.assert_allclose(to_np(ts[key]), np.asarray(js[key]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"round {r} {key}")
        acted += float(ts["tick"]) == 0.0
    # the swing of the histograms makes the controller actuate
    assert acted >= 3
    assert float(ts["k_m_frac"]) != 0.75


def test_lanes_update_independently():
    """A (lanes,) state steps each lane as the single-lane update would."""
    ctrl = controller.BudgetController(rho=0.2)
    hists = [_hists(s, 12) for s in (1, 2, 3)]
    lanes = controller.init_controller_state(
        torch.tensor([0.2, 0.5, 0.9]))
    singles = [controller.init_controller_state(f)
               for f in (0.2, 0.5, 0.9)]
    for r in range(12):
        lanes = ctrl.update(lanes, torch.stack(
            [to_torch(h[r][0]) for h in hists]))
        singles = [ctrl.update(s, to_torch(h[r][0]))
                   for s, h in zip(singles, hists)]
    for i, s in enumerate(singles):
        for key in s:
            np.testing.assert_array_equal(to_np(lanes[key][i]),
                                          to_np(s[key]))


def test_thin_is_checked():
    with pytest.raises(ValueError, match="thin"):
        controller.BudgetController(rho=0.1, thin=1.0)
