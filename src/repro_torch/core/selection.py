"""Parameter-selection policies for OAC-FL (paper Sec. III-B), the port
of ``repro.core.selection``.

Every policy reads the server-side state — the last reconstructed global
gradient ``g`` and the Age-of-Update vector ``age`` — and returns an index
vector of exactly ``k`` coordinates (int64), or its dense 0/1 mask.

* ``fair_k``      — Eq. (11): Top(|g|, k_M) ∪ Top(age ∘ ¬Top(|g|, k_M), k_A).
* ``top_k``       — magnitude only (``fair_k`` with ``k_m = k``).
* ``round_robin`` — age only (``fair_k`` with ``k_m = 0``).
* ``top_rand``    — Top-``k_M`` + uniform random among the rest.
* ``age_top_k``   — the ``k`` oldest among the top-``r`` magnitudes.
* ``rand_k``      — uniform random ``k``.

Randomness: the two random policies take their uniform ``(d,)`` draw
``u`` as a tensor (the reference draws ``jax.random.uniform(key, (d,))``
inside); the port cannot reproduce JAX's streams, so callers pass it.

Tie order: ``lax.top_k`` breaks ties toward the lower index, and round
robin depends on it (on round 0 every age is equal).  ``torch.topk``
promises no tie order, so every top-k here is a stable descending sort
followed by a slice.  ``±0.0`` compare equal in it (``lax.top_k`` puts
``+0.0`` first); no caller passes a ``−0.0`` — scores are magnitudes,
ages or uniform draws.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

POLICIES = ("fairk", "topk", "roundrobin", "toprand", "agetopk", "randk")
RANDOM_POLICIES = ("toprand", "randk")

# ages are >= 0 and uniform draws lie in [0, 1); -1 never wins a top-k
_EXCLUDED = -1.0


def mask_from_indices(idx: Tensor, d: int) -> Tensor:
    """Dense float32 0/1 mask from an index vector."""
    return torch.zeros(d, dtype=torch.float32,
                       device=idx.device).index_fill(0, idx, 1.0)


def _top_indices(score: Tensor, k: int) -> Tensor:
    """Indices of the ``k`` largest entries of ``score``, ties toward the
    lower index (NaN ranks first, as in ``lax.top_k``)."""
    if not 0 <= k <= score.shape[0]:
        raise ValueError(f"top-k needs 0 <= k <= {score.shape[0]}, got {k}")
    return torch.sort(score, descending=True, stable=True).indices[:k]


def fair_k_indices(g: Tensor, age: Tensor, *, k: int, k_m: int) -> Tensor:
    """FAIR-k, Eq. (11): the first ``k_m`` entries are the magnitude
    picks, the remaining ``k − k_m`` the age picks."""
    d = g.shape[0]
    if not 0 <= k_m <= k <= d:
        raise ValueError(f"need 0 <= k_m <= k <= d, got k_m={k_m} k={k} "
                         f"d={d}")
    age_f = age.to(torch.float32)
    if k_m == 0:
        return _top_indices(age_f, k)
    idx_m = _top_indices(g.abs(), k_m)
    if k == k_m:
        return idx_m
    # the magnitude picks leave the age stage
    idx_a = _top_indices(age_f.index_fill(0, idx_m, _EXCLUDED), k - k_m)
    return torch.cat([idx_m, idx_a])


def top_k_indices(g: Tensor, *, k: int) -> Tensor:
    return _top_indices(g.abs(), k)


def round_robin_indices(age: Tensor, *, k: int) -> Tensor:
    """Age-only selection: with all-equal ages the lower-index tie-break
    makes the schedule cycle through the coordinates."""
    return _top_indices(age.to(torch.float32), k)


def top_rand_indices(u: Tensor, g: Tensor, *, k: int, k_m: int) -> Tensor:
    """TopRand: Top-``k_M`` by magnitude + the ``k − k_M`` largest of the
    uniform draw ``u`` among the rest."""
    k_a = k - k_m
    idx_m = (_top_indices(g.abs(), k_m) if k_m > 0
             else torch.zeros(0, dtype=torch.int64, device=g.device))
    if k_a == 0:
        return idx_m
    score = u.to(torch.float32)
    if k_m > 0:
        score = score.index_fill(0, idx_m, _EXCLUDED)
    return torch.cat([idx_m, _top_indices(score, k_a)])


def age_top_k_indices(g: Tensor, age: Tensor, *, k: int, r: int) -> Tensor:
    """AgeTop-k: the top-``r`` magnitudes (r >= k), then the ``k`` oldest
    among them, ties broken by position in that candidate list."""
    if r < k:
        raise ValueError(f"AgeTop-k needs r >= k, got r={r} k={k}")
    idx_r = _top_indices(g.abs(), r)
    pos = _top_indices(age.to(torch.float32)[idx_r], k)
    return idx_r[pos]


def rand_k_indices(u: Tensor, *, k: int) -> Tensor:
    """The ``k`` largest entries of the uniform draw ``u``."""
    return _top_indices(u.to(torch.float32), k)


def fair_k_mask(g: Tensor, age: Tensor, *, k: int, k_m: int) -> Tensor:
    return mask_from_indices(fair_k_indices(g, age, k=k, k_m=k_m),
                             g.shape[0])


def top_k_mask(g: Tensor, *, k: int) -> Tensor:
    return mask_from_indices(top_k_indices(g, k=k), g.shape[0])


def round_robin_mask(age: Tensor, *, k: int) -> Tensor:
    return mask_from_indices(round_robin_indices(age, k=k), age.shape[0])


def top_rand_mask(u: Tensor, g: Tensor, *, k: int, k_m: int) -> Tensor:
    return mask_from_indices(top_rand_indices(u, g, k=k, k_m=k_m),
                             g.shape[0])


def age_top_k_mask(g: Tensor, age: Tensor, *, k: int, r: int) -> Tensor:
    return mask_from_indices(age_top_k_indices(g, age, k=k, r=r),
                             g.shape[0])


def rand_k_mask(u: Tensor, *, k: int) -> Tensor:
    return mask_from_indices(rand_k_indices(u, k=k), u.shape[0])


def select_indices(policy: str, u, g: Tensor, age: Tensor, *, k: int,
                   k_m: int, r: int) -> Tensor:
    """Uniform entry point: exactly ``k`` selected indices.  ``u`` is the
    uniform ``(d,)`` draw of the random policies (ignored by the others,
    which accept None)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; choose from "
                         f"{POLICIES}")
    if policy in RANDOM_POLICIES and u is None:
        raise ValueError(f"policy {policy!r} needs a uniform draw u")
    if policy == "fairk":
        return fair_k_indices(g, age, k=k, k_m=k_m)
    if policy == "topk":
        return top_k_indices(g, k=k)
    if policy == "roundrobin":
        return round_robin_indices(age, k=k)
    if policy == "toprand":
        return top_rand_indices(u, g, k=k, k_m=k_m)
    if policy == "agetopk":
        return age_top_k_indices(g, age, k=k, r=r)
    return rand_k_indices(u, k=k)
