"""Markov-chain staleness analysis of FAIR-k (paper Sec. IV-B, Lemma 1).

States are the positions of a coordinate in the ascending-AoU order,
0-indexed here (paper uses 1-indexed): state 0..k_a-1 = the AoU-refreshed
set I_A, state k_a..k-1 = the magnitude-refreshed set I_M, state k..d-1 =
unselected coordinates ordered by age.  Per the paper, the two "fresh"
blocks are collapsed onto their first positions (state 0 and state k_a).

The exchange model: each round, k_0 coordinates swap between I_M and its
complement; p1 = k0/k_M is the leave-probability, p2 = k0/(d − k_M) the
join-probability (Eq. 15).  Transitions of a generic coordinate follow the
three cases of Sec. IV-B; step lengths are capped at ell <= min(k0, n_older)
(footnote 2) and rows are re-normalized.

Everything here is plain numpy float64 — it is analysis code, not a
training-path component.  This is a copy of ``repro.core.markov`` (which
imports no JAX either, but its package does): the port imports nothing of
the JAX package, and the tests hold the copy to the original exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# the binomial pmf is computed directly (log-space, numerically stable),
# so the module needs numpy alone.


def _binom_pmf(n: int, p: float, ells: np.ndarray) -> np.ndarray:
    """Binomial(n, p) pmf evaluated at integer array ``ells`` (log-space)."""
    ells = np.asarray(ells, dtype=np.int64)
    if n == 0:
        return (ells == 0).astype(np.float64)
    from math import lgamma, log
    logc = (lgamma(n + 1)
            - np.array([lgamma(e + 1) for e in ells])
            - np.array([lgamma(n - e + 1) for e in ells]))
    if p <= 0.0:
        return (ells == 0).astype(np.float64)
    if p >= 1.0:
        return (ells == n).astype(np.float64)
    logp = logc + ells * log(p) + (n - ells) * log(1.0 - p)
    return np.exp(logp)


@dataclasses.dataclass(frozen=True)
class FairKChain:
    d: int
    k: int
    k_m: int
    k0: int

    @property
    def k_a(self) -> int:
        return self.k - self.k_m

    @property
    def p1(self) -> float:
        return self.k0 / self.k_m

    @property
    def p2(self) -> float:
        return self.k0 / (self.d - self.k_m)

    @property
    def max_staleness(self) -> int:
        return -(-(self.d - self.k_m) // self.k_a)

    def __post_init__(self):
        if not (0 < self.k_m < self.k <= self.d // 2):
            raise ValueError(
                "need 0 < k_m < k <= d/2 (paper restricts rho <= 50% and the "
                f"chain needs both stages), got d={self.d} k={self.k} k_m={self.k_m}")
        if not 0 < self.k0 < self.k_m:
            raise ValueError(f"need 0 < k0 < k_m, got k0={self.k0} k_m={self.k_m}")


def transition_matrix(chain: FairKChain) -> np.ndarray:
    """The d x d position-transition matrix P of Sec. IV-B (0-indexed)."""
    d, k, k_m, k_a = chain.d, chain.k, chain.k_m, chain.k_a
    p1, p2, k0 = chain.p1, chain.p2, chain.k0
    P = np.zeros((d, d), np.float64)

    # case 1: freshly AoU-selected block (paper i <= k_a)
    for i in range(k_a):
        P[i, k_a] = p2          # pulled into Top-k_M next round
        P[i, k] = 1.0 - p2      # otherwise starts ageing at the bottom

    # case 2: freshly magnitude-selected block (paper k_a+1 <= i <= k)
    for i in range(k_a, k):
        P[i, k_a] = 1.0 - p1    # sticky: stays in I_M
        P[i, k] = p1            # leaves I_M, starts ageing

    # case 3: ageing coordinates (paper i >= k+1)
    for i in range(k, d):
        n_older = d - 1 - i                      # coordinates older than i
        P[i, k_a] = p2                           # magnitude-selected
        ell_cap = min(k0, n_older)               # footnote 2
        ells = np.arange(0, ell_cap + 1)
        pmf = _binom_pmf(n_older, p2, ells)
        # ell of the older coordinates get magnitude-selected
        for ell, q in zip(ells, pmf):
            stays_prob = (1.0 - p2) * q
            remaining_older = n_older - ell
            if remaining_older < k_a:
                # fewer than k_a coordinates remain older -> i is among the
                # k_a oldest -> AoU stage resets it (paper transition i -> 1)
                P[i, 0] += stays_prob
            else:
                j = i + k_a + ell                # paper: i -> i + k_a + ell
                j = min(j, d - 1)                # clamp (paper normalizes)
                P[i, j] += stays_prob

    # footnote 2: normalize each row over its (truncated) support
    P /= P.sum(axis=1, keepdims=True)
    return P


def steady_state(P: np.ndarray, tol: float = 1e-12, iters: int = 200000
                 ) -> np.ndarray:
    """Solve pi = pi P (Eq. 16) by power iteration."""
    d = P.shape[0]
    pi = np.full(d, 1.0 / d)
    for _ in range(iters):
        nxt = pi @ P
        if np.abs(nxt - pi).sum() < tol:
            pi = nxt
            break
        pi = nxt
    return pi / pi.sum()


def aou_distribution(chain: FairKChain) -> Tuple[np.ndarray, np.ndarray]:
    """Lemma 1: the pmf of the staleness tau.

    Returns (support, pmf) where support = [0, 1, ..., T].  tau = l means the
    coordinate waits l rounds between consecutive refreshes, i.e. from state
    i it first re-enters state 0 or state k_a after l+1 transitions.
    """
    P = transition_matrix(chain)
    pi = steady_state(P)
    d, k_a = chain.d, chain.k_a
    T = chain.max_staleness

    # P with the two absorbing columns zeroed (paper: P_(1, k_a+1))
    P0 = P.copy()
    P0[:, 0] = 0.0
    P0[:, k_a] = 0.0

    pmf = np.zeros(T + 1)
    M = np.eye(d)                  # P0^l, starting at l = 0
    for l in range(T + 1):
        hit = M @ P                # reach a fresh state on the (l+1)-th step
        pmf[l] = float(pi @ (hit[:, 0] + hit[:, k_a]))
        M = M @ P0
    # numerical truncation: renormalize over the finite support
    pmf = np.clip(pmf, 0.0, None)
    pmf /= pmf.sum()
    return np.arange(T + 1), pmf


def expected_staleness(chain: FairKChain) -> float:
    support, pmf = aou_distribution(chain)
    return float((support * pmf).sum())


def shift_pmf(support: np.ndarray, pmf: np.ndarray, lag: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Translate a pmf by a deterministic nonnegative integer delay:
    ``P[A = a] -> P[A = a - lag]`` on support ``support + lag``.  The
    distribution-level primitive behind ``shifted_aou_distribution``;
    commutes exactly with ``thin_pmf`` (a constant offset passes through
    a convolution)."""
    if lag < 0:
        raise ValueError(f"lag must be >= 0, got {lag}")
    return np.asarray(support) + lag, np.asarray(pmf, np.float64)


def thin_pmf(support: np.ndarray, pmf: np.ndarray, thin: float,
             tail_mass: float = 1e-9) -> Tuple[np.ndarray, np.ndarray]:
    """Convolve a pmf with an independent ``Geom(thin)`` delay
    (``P[D = j] = (1 - thin) thin^j``, mean ``thin / (1 - thin)``) — the
    distribution-level primitive behind ``thinned_aou_distribution``.

    Requires a contiguous integer support starting at ``support[0]`` (the
    convolution is index-based); the geometric tail is truncated once its
    remaining mass drops below ``tail_mass`` and the result renormalized.
    ``thin = 0`` returns the inputs unchanged.
    """
    if not 0.0 <= thin < 1.0:
        raise ValueError(f"thin must be in [0, 1), got {thin}")
    support = np.asarray(support)
    pmf = np.asarray(pmf, np.float64)
    if thin == 0.0:
        return support, pmf
    # geometric tail length: (1-p) p^j summed beyond J is p^(J+1)
    J = max(1, int(np.ceil(np.log(tail_mass) / np.log(thin))))
    delays = (1.0 - thin) * thin ** np.arange(J + 1)
    out = np.convolve(pmf, delays)
    out = np.clip(out, 0.0, None)
    out /= out.sum()
    return int(support[0]) + np.arange(len(out)), out


def shifted_aou_distribution(chain: FairKChain, lag: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Lemma 1 under async aggregation with a constant delivery lag.

    When every selected coordinate's contribution lands ``lag`` rounds
    late, its post-update age restarts at ``lag`` instead of 0 while the
    inter-refresh dynamics (the position chain of Sec. IV-B) are
    unchanged — the selection itself still scores the carried buffer the
    same way.  The stationary post-update AoU pmf is therefore exactly
    the synchronous Lemma-1 pmf translated by ``lag``:
    ``P[A = a] = pmf_sync[a - lag]`` on support ``[lag, T + lag]``.
    """
    return shift_pmf(*aou_distribution(chain), lag)


def thinned_aou_distribution(chain: FairKChain, thin: float,
                             tail_mass: float = 1e-9
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Lemma 1 under participation thinning (fault channels).

    When each round's refresh of a selected coordinate is independently
    *blocked* with probability ``thin`` — a deep-fade erasure or a
    corrupted (non-finite) uplink that the sanitize stage masks out — the
    coordinate stays semantically "unsent": its age keeps climbing and its
    mass stays in the EF residual, exactly as if the refresh were delayed.
    Because FAIR-k re-selects the now-even-staler coordinate with at least
    the age-stage priority it already had, the delay until the refresh
    actually lands is (approximately, in the well-mixed exchange regime)
    geometric: ``D ~ Geom(thin)``, ``P[D = j] = (1 - thin) thin^j``.

    The post-update stationary AoU is then the synchronous Lemma-1 age
    plus an independent geometric delay — a convolution rather than the
    deterministic translation of ``shifted_aou_distribution``:

        P[A = a] = sum_j (1 - thin) thin^j * pmf_sync[a - j]

    with mean shift ``thin / (1 - thin)`` (the constant offset
    ``BudgetController(..., thin=...)`` absorbs).  ``thin = 0`` returns
    the synchronous pmf unchanged.  The geometric tail is truncated once
    its remaining mass drops below ``tail_mass`` and renormalized.
    """
    return thin_pmf(*aou_distribution(chain), thin, tail_mass=tail_mass)


def population_thin(avail: float, vanish_rate: float, participants: int,
                    exposure: float = 0.5) -> float:
    """Effective per-round refresh-blocking probability of a churning
    population (DESIGN.md §15): mid-round churn erases each symbol block
    of the aggregate with probability ``exposure * vanish_rate`` (a
    participant whose chain transitions down mid-round loses a random
    ~``exposure`` share of its interleaved uplink blocks), and a TOTAL
    outage of the sampled cohort — all ``participants`` clients down at
    once — erases the round outright with probability
    ``(1 - avail)^participants``.  Both channels block a selected
    coordinate's refresh independently per round, which is exactly the
    thinning model of ``thinned_aou_distribution``.

    Mirrors ``population.PopulationConfig.thin`` (kept numerically
    identical so the analysis side needs no jax import).
    """
    if not 0.0 < avail <= 1.0:
        raise ValueError(f"avail must be in (0, 1], got {avail}")
    if not 0.0 <= vanish_rate <= 1.0:
        raise ValueError(
            f"vanish_rate must be in [0, 1], got {vanish_rate}")
    if participants < 1:
        raise ValueError(f"participants must be >= 1, got {participants}")
    if not 0.0 < exposure <= 1.0:
        raise ValueError(f"exposure must be in (0, 1], got {exposure}")
    outage = (1.0 - avail) ** participants
    return min(0.99, exposure * vanish_rate + outage)


def population_aou_distribution(chain: FairKChain, avail: float,
                                vanish_rate: float, participants: int,
                                exposure: float = 0.5,
                                tail_mass: float = 1e-9
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Lemma 1 under population churn: the participation-thinned
    stationary post-update AoU pmf, with the thinning probability derived
    from the population's stationary availability (``population_thin``).
    This is the Sec. IV prediction the population validation suite
    (``tests/test_population.py``) checks the empirical histogram against
    on the exact and packed backends.
    """
    thin = population_thin(avail, vanish_rate, participants,
                           exposure=exposure)
    return thinned_aou_distribution(chain, thin, tail_mass=tail_mass)


def truncation_thin(pmax: float, gmin: float, gains) -> float:
    """Per-round refresh-blocking probability under truncated channel
    inversion (DESIGN.md §16): client ``n``'s instantaneous gain is
    ``G_n = L_n X_n`` with ``X_n ~ Exp(1)`` (Rayleigh power fading) and
    ``L_n`` its static path gain; the client is truncated out of the
    superposition when ``G_n`` falls below the effective threshold
    ``g_eff = max(gmin, 1/pmax)`` (inverting a weaker gain would exceed
    the power budget), so its stationary outage probability is
    ``q_n = 1 - exp(-g_eff / L_n)``.  Partial outages renormalize over
    the survivors (like dropout, they barely thin); only a TOTAL outage
    — every client truncated at once — blocks a selected coordinate's
    refresh, so the thinning rate of ``thinned_aou_distribution`` is
    ``prod_n q_n``.

    Mirrors ``channel.ChannelConfig.thin`` (kept numerically identical
    so the analysis side needs no jax import).
    """
    if not (pmax > 0.0 and np.isfinite(pmax)):
        raise ValueError(f"pmax must be a finite positive power budget, "
                         f"got {pmax}")
    if gmin < 0.0:
        raise ValueError(f"gmin must be >= 0, got {gmin}")
    gains = np.asarray(gains, np.float64)
    if gains.ndim != 1 or gains.size < 1:
        raise ValueError(f"gains must be a non-empty 1-D path-gain "
                         f"vector, got shape {gains.shape}")
    if not np.all(gains > 0.0):
        raise ValueError("path gains must be strictly positive")
    g_eff = max(gmin, 1.0 / pmax)
    outage = -np.expm1(-g_eff / gains)
    return min(0.99, float(np.prod(outage)))


def channel_aou_distribution(chain: FairKChain, pmax: float, gmin: float,
                             gains, extra_thin: float = 0.0,
                             tail_mass: float = 1e-9
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Lemma 1 under truncated channel inversion: the stationary
    post-update AoU pmf thinned at ``truncation_thin(pmax, gmin, gains)``.

    ``extra_thin`` composes an independent second blocking channel —
    population churn (``population_thin``), deep fades — with the
    truncation outage: the per-round blocking probability of two
    independent blockers is ``1 - (1 - t_trunc)(1 - extra_thin)``.  This
    is the Sec. IV prediction the channel validation suite
    (``tests/test_channel.py``) checks the empirical histogram against
    on the exact and packed backends.
    """
    if not 0.0 <= extra_thin < 1.0:
        raise ValueError(
            f"extra_thin must be in [0, 1), got {extra_thin}")
    t = truncation_thin(pmax, gmin, gains)
    thin = min(0.99, 1.0 - (1.0 - t) * (1.0 - extra_thin))
    return thinned_aou_distribution(chain, thin, tail_mass=tail_mass)


def simulate_aou(chain: FairKChain, rounds: int, seed: int = 0,
                 mode: str = "exchange", momentum: float = 0.9,
                 burn_in: int = 200) -> np.ndarray:
    """Empirical AoU distribution under FAIR-k selection (Fig. 3 check).

    Lemma 1 characterizes the *time-averaged* distribution of A_{t,i} over a
    typical coordinate at a typical (stationary) round, so we histogram the
    full post-update age vector every round after a burn-in.

    Modes for the magnitude dynamics:
      * ``"exchange"`` — the Sec. IV-B exchange model itself: each round k0
        uniformly chosen members of the Top-k_M set swap with k0 uniformly
        chosen outsiders.  Matches the analytic assumptions exactly.
      * ``"ar"`` — AR(1) gradient magnitudes (persistence ~= ``momentum``);
        the actual Top-k_M of |g| is used.  Shows robustness of the analysis
        to the simplifying exchange assumption.
    """
    rng = np.random.default_rng(seed)
    d, k, k_m, k_a, k0 = chain.d, chain.k, chain.k_m, chain.k_a, chain.k0
    age = np.zeros(d, dtype=np.int64)
    counts = np.zeros(chain.max_staleness + 2)
    if mode == "exchange":
        in_m = np.zeros(d, dtype=bool)
        in_m[rng.choice(d, k_m, replace=False)] = True
    else:
        mag = np.abs(rng.normal(size=d))
    for t in range(rounds + burn_in):
        if mode == "exchange":
            leave = rng.choice(np.flatnonzero(in_m), k0, replace=False)
            join = rng.choice(np.flatnonzero(~in_m), k0, replace=False)
            in_m[leave] = False
            in_m[join] = True
            idx_m = np.flatnonzero(in_m)
        elif mode == "ar":
            mag = momentum * mag + (1 - momentum) * np.abs(rng.normal(size=d))
            idx_m = np.argpartition(-mag, k_m)[:k_m]
        else:
            raise ValueError(f"unknown mode {mode!r}")
        masked_age = age.astype(np.float64)
        masked_age[idx_m] = -1.0
        idx_a = np.argpartition(-masked_age, k_a)[:k_a]
        sel = np.concatenate([idx_m, idx_a])
        age += 1
        age[sel] = 0
        if t >= burn_in:
            clipped = np.clip(age, 0, len(counts) - 1)
            counts += np.bincount(clipped, minlength=len(counts))
    pmf = counts[: chain.max_staleness + 1]
    s = pmf.sum()
    return pmf / s if s > 0 else pmf
