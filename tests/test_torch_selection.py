"""The port's selection policies, rank-form FAIR-k and AoU bookkeeping
against the JAX package (``repro.core.selection`` / ``engine`` / ``aou``).

Index vectors must be equal value for value and in the same order (JAX
gives int32, the port int64: values are compared, not types).  The
random policies take the uniform draw JAX makes from the key,
``jax.random.uniform(key, (d,))``, as a tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import to_np, to_torch

from repro.core import aou as jax_aou
from repro.core import engine as jax_engine
from repro.core import selection as jax_sel
from repro_torch.core import aou, engine, selection

D = 600


def _state(case: str, seed: int):
    """(g, age) for a named case: random, all ages equal (round robin
    cycles), heavily tied |g| and ages, or with exact zeros."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=D).astype(np.float32)
    age = rng.integers(0, 40, size=D).astype(np.float32)
    if case == "equal_ages":
        age[:] = 3.0
    elif case == "ties":
        g = (rng.integers(-4, 5, size=D) * 0.25).astype(np.float32)
        age = rng.integers(0, 4, size=D).astype(np.float32)
    elif case == "zeros":
        g[rng.choice(D, D // 3, replace=False)] = 0.0
        age[:] = 0.0
    return g, age


def _uniform(seed: int):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (D,),
                                         jnp.float32))


BUDGETS = [(60, 45, 90), (60, 0, 90), (60, 60, 60), (7, 3, 250)]


@pytest.mark.parametrize("policy", selection.POLICIES)
@pytest.mark.parametrize("case", ["random", "equal_ages", "ties", "zeros"])
@pytest.mark.parametrize("k,k_m,r", BUDGETS)
def test_select_indices_match_jax(policy, case, k, k_m, r):
    g, age = _state(case, seed=k + k_m)
    key = jax.random.PRNGKey(k)
    j = jax_sel.select_indices(policy, key, jnp.asarray(g), jnp.asarray(age),
                               k=k, k_m=k_m, r=r)
    u = _uniform(k)
    t = selection.select_indices(policy, to_torch(u), to_torch(g),
                                 to_torch(age), k=k, k_m=k_m, r=r)
    assert t.shape == (k,)
    np.testing.assert_array_equal(to_np(t), np.asarray(j).astype(np.int64))


def test_round_robin_cycles_through_the_coordinates():
    age_j = jnp.zeros(D)
    age_t = torch.zeros(D)
    seen = []
    for _ in range(D // 60):
        j = jax_sel.round_robin_indices(age_j, k=60)
        t = selection.round_robin_indices(age_t, k=60)
        np.testing.assert_array_equal(to_np(t), np.asarray(j))
        seen.append(to_np(t))
        age_j = jax_aou.update_age_by_indices(age_j, j)
        age_t = aou.update_age_by_indices(age_t, t)
        np.testing.assert_array_equal(to_np(age_t), np.asarray(age_j))
    assert np.array_equal(np.sort(np.concatenate(seen)), np.arange(D))


@pytest.mark.parametrize("k,k_m", [(60, 45), (60, 0), (60, 60)])
@pytest.mark.parametrize("case", ["random", "equal_ages", "ties"])
def test_mask_forms_match_jax(k, k_m, case):
    g, age = _state(case, seed=3)
    u = _uniform(5)
    key = jax.random.PRNGKey(5)
    jg, ja = jnp.asarray(g), jnp.asarray(age)
    tg, ta = to_torch(g), to_torch(age)
    pairs = [
        (jax_sel.fair_k_mask(jg, ja, k=k, k_m=k_m),
         selection.fair_k_mask(tg, ta, k=k, k_m=k_m)),
        (jax_sel.top_k_mask(jg, k=k), selection.top_k_mask(tg, k=k)),
        (jax_sel.round_robin_mask(ja, k=k),
         selection.round_robin_mask(ta, k=k)),
        (jax_sel.top_rand_mask(key, jg, k=k, k_m=k_m),
         selection.top_rand_mask(to_torch(u), tg, k=k, k_m=k_m)),
        (jax_sel.age_top_k_mask(jg, ja, k=k, r=90),
         selection.age_top_k_mask(tg, ta, k=k, r=90)),
        (jax_sel.rand_k_mask(key, D, k=k),
         selection.rand_k_mask(to_torch(u), k=k)),
    ]
    for j, t in pairs:
        np.testing.assert_array_equal(to_np(t), np.asarray(j))
        assert float(t.sum()) == k


@pytest.mark.parametrize("case", ["random", "equal_ages", "ties", "zeros"])
def test_rank_desc_and_dynamic_masks_match_jax(case):
    g, age = _state(case, seed=11)
    x = np.abs(g)
    np.testing.assert_array_equal(
        to_np(engine.rank_desc(to_torch(x))),
        np.asarray(jax_engine.rank_desc(jnp.asarray(x))))
    for k, k_m in ((60, 45), (60, 0), (60, 60), (0, 0)):
        jm, jmm = jax_engine.fair_k_masks_dynamic(
            jnp.abs(jnp.asarray(g)), jnp.asarray(age), k, k_m)
        tm, tmm = engine.fair_k_masks_dynamic(to_torch(g).abs(),
                                              to_torch(age), k, k_m)
        np.testing.assert_array_equal(to_np(tm), np.asarray(jm))
        np.testing.assert_array_equal(to_np(tmm), np.asarray(jmm))
        np.testing.assert_array_equal(
            to_np(engine.fair_k_mask_dynamic(to_torch(g).abs(),
                                             to_torch(age), k, k_m)),
            np.asarray(jm))
        if k:
            # the rank form selects the index form's coordinate set
            idx = selection.fair_k_indices(to_torch(g), to_torch(age), k=k,
                                           k_m=k_m)
            np.testing.assert_array_equal(
                to_np(selection.mask_from_indices(idx, D)), to_np(tm))


def test_rank_desc_puts_nan_last_as_jax():
    x = np.array([0.5, np.nan, 2.0, 0.5, np.nan, -1.0], np.float32)
    np.testing.assert_array_equal(
        to_np(engine.rank_desc(to_torch(x))),
        np.asarray(jax_engine.rank_desc(jnp.asarray(x))))


def test_aou_bookkeeping_matches_jax():
    rng = np.random.default_rng(2)
    age = rng.integers(0, 125, size=D).astype(np.float32)
    age[:3] = [np.nan, 119.0, 120.0]
    mask = (rng.random(D) < 0.2).astype(np.float32)
    idx = rng.choice(D, 50, replace=False)
    np.testing.assert_array_equal(
        to_np(aou.update_age(to_torch(age), to_torch(mask))),
        np.asarray(jax_aou.update_age(jnp.asarray(age), jnp.asarray(mask))))
    np.testing.assert_array_equal(
        to_np(aou.update_age_by_indices(to_torch(age), to_torch(idx))),
        np.asarray(jax_aou.update_age_by_indices(jnp.asarray(age),
                                                 jnp.asarray(idx))))
    np.testing.assert_array_equal(to_np(aou.init_age(D)),
                                  np.asarray(jax_aou.init_age(D)))
    for d, k, k_m in ((1000, 100, 75), (109_210, 10_921, 8_191),
                      (7, 3, 2)):
        assert aou.max_staleness(d, k, k_m) == jax_aou.max_staleness(
            d, k, k_m)
    with pytest.raises(ValueError):
        aou.max_staleness(10, 4, 4)
    finite = age[3:]
    j = jax_aou.age_stats(jnp.asarray(finite))
    t = aou.age_stats(to_torch(finite))
    for key in ("mean", "max", "p50", "p99"):
        np.testing.assert_allclose(to_np(t[key]), np.asarray(j[key]),
                                   rtol=1e-6, err_msg=key)


def test_policy_argument_checks():
    g, age = (to_torch(a) for a in _state("random", 0))
    with pytest.raises(ValueError, match="u"):
        selection.select_indices("randk", None, g, age, k=5, k_m=2, r=9)
    with pytest.raises(ValueError, match="r >= k"):
        selection.age_top_k_indices(g, age, k=9, r=5)
    with pytest.raises(ValueError, match="k_m"):
        selection.fair_k_indices(g, age, k=5, k_m=6)
    with pytest.raises(ValueError, match="policy"):
        selection.select_indices("nope", None, g, age, k=5, k_m=2, r=9)
