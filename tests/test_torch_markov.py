"""The port's copy of the Markov staleness analysis
(``repro_torch.core.markov``) against ``repro.core.markov``: both are numpy
float64, so every output is equal exactly — the Lemma-1 pmf, the expected
staleness, the simulated pmfs under the same numpy seed and the shifted,
thinned, population and channel pmfs — at fig3's chain and one more."""

import numpy as np
import pytest

from repro.core import markov as jax_markov
from repro_torch.core import markov

CHAINS = [dict(d=800, k=80, k_m=60, k0=15),      # fig3's chain
          dict(d=300, k=45, k_m=20, k0=6)]


@pytest.fixture(params=CHAINS, ids=["fig3", "other"])
def chains(request):
    return (markov.FairKChain(**request.param),
            jax_markov.FairKChain(**request.param))


def _same(a, b):
    for x, y in zip(a, b) if isinstance(a, tuple) else ((a, b),):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_lemma1_and_expected_staleness_are_identical(chains):
    t, j = chains
    assert t.max_staleness == j.max_staleness
    _same(markov.transition_matrix(t), jax_markov.transition_matrix(j))
    _same(markov.aou_distribution(t), jax_markov.aou_distribution(j))
    assert markov.expected_staleness(t) == jax_markov.expected_staleness(j)


@pytest.mark.parametrize("mode", ["exchange", "ar"])
def test_simulation_is_identical_under_one_seed(chains, mode):
    t, j = chains
    _same(markov.simulate_aou(t, rounds=300, seed=3, mode=mode),
          jax_markov.simulate_aou(j, rounds=300, seed=3, mode=mode))


def test_derived_pmfs_are_identical(chains):
    t, j = chains
    _same(markov.shifted_aou_distribution(t, 3),
          jax_markov.shifted_aou_distribution(j, 3))
    _same(markov.thinned_aou_distribution(t, 0.2),
          jax_markov.thinned_aou_distribution(j, 0.2))
    _same(markov.population_aou_distribution(t, 0.8, 0.05, 16),
          jax_markov.population_aou_distribution(j, 0.8, 0.05, 16))
    gains = np.linspace(0.5, 2.0, 12)
    _same(markov.channel_aou_distribution(t, 2.0, 0.3, gains,
                                          extra_thin=0.1),
          jax_markov.channel_aou_distribution(j, 2.0, 0.3, gains,
                                              extra_thin=0.1))
    assert (markov.population_thin(0.8, 0.05, 16)
            == jax_markov.population_thin(0.8, 0.05, 16))
    assert (markov.truncation_thin(2.0, 0.3, gains)
            == jax_markov.truncation_thin(2.0, 0.3, gains))


def test_invalid_chains_are_rejected_alike():
    for bad in (dict(d=100, k=60, k_m=30, k0=5),
                dict(d=100, k=10, k_m=10, k0=5),
                dict(d=100, k=10, k_m=5, k0=7)):
        with pytest.raises(ValueError):
            markov.FairKChain(**bad)
        with pytest.raises(ValueError):
            jax_markov.FairKChain(**bad)
