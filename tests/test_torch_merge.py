"""The index form of the port's ``aou_merge`` kernel, the exact call sites'
whole server-state update for a selection ``idx``, against the JAX
package, through the plain versions the kernel is held to on the card.

* ``ops.aou_merge_by_indices`` (the exact trainer): JAX's receiver tail
  ``repro.core.oac.finish_aggregate`` compiled with ``jax.jit``, as the
  trainer's round compiles it (XLA multiplies by the float32 ``1/N``),
  ``oac.reconstruct`` (``.at[idx].set``), ``aou.update_age_by_indices``,
  the mask ``.at[idx].set(1.0)``, the count ``.at[idx].add(1.0)`` and the
  EF residual ``(ef_sum / N)·(1 − mask)``, also compiled; at N = 5 and
  N = 50, where 1/N is not a power of two.  With receiver noise the
  compiled tail's normal draw is the draw handed to the port, a constant
  of the compiled function (drawn in the graph, XLA would fold the
  ``noise_std`` scale into the draw and round differently in the last
  place, a known trait of the reference).
* ``ops.masked_merge_by_indices`` (the exact engine):
  ``repro.core.engine.masked_merge`` of ``sent + (noise_std / N)·noise``
  over the JAX mask of ``idx``, and the residual ``score − mask·sent``.

Every output bit for bit (any NaN matches any NaN), on −0.0, NaN and ±inf
in the fresh row, in ``g_prev``, in ``sent`` and in ``ef_sum``; NaN ages,
ages at and past ``AGE_CAP`` and below −1; k = 1, a few, and k = d;
unsorted selections; ragged d.  The two call sites' arithmetic differs on
purpose (a scatter against ``m·fresh + (1 − m)·g_old``), and the tests
check that it stays apart.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import to_np, to_torch

from repro.core import aou as jax_aou
from repro.core import engine as jax_engine
from repro.core import oac as jax_oac
from repro.core import selection as jax_selection
from repro_torch.core import packing
from repro_torch.kernels import aou_merge, ops

N_CLIENTS = 50
N_TRAINER = (5, 50)


def _same_floats(a, b, what=""):
    """Equal bit for bit, except that any NaN matches any NaN."""
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    np.testing.assert_array_equal(nan_a, nan_b, err_msg=what)
    np.testing.assert_array_equal(a[~nan_a].view(np.uint32),
                                  b[~nan_b].view(np.uint32), err_msg=what)


def _traps(x, rng, n):
    """A copy of ``x`` with −0.0, NaN, +inf and −inf at ``n`` positions
    each."""
    out = x.copy()
    pos = rng.choice(x.shape[0], min(x.shape[0], 4 * n), replace=False)
    for part, value in zip(np.array_split(pos, 4),
                           (-0.0, np.nan, np.inf, -np.inf)):
        out[part] = value
    return out


def _state(d, k, seed):
    """A selection ``idx`` of k distinct unsorted coordinates, with the
    first trap coordinates forced into it, and (d,) state rows with every
    trap, some on selected and some on unselected coordinates."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(d)[:k].astype(np.int64)
    n = max(1, d // 100)
    age = rng.integers(0, 131, size=d).astype(np.float32)
    special = np.array([np.nan, 118.0, 119.0, 120.0, 121.0, 130.0, -1.0,
                        -2.5, 0.0], np.float32)
    age[:len(special)] = special[:d]
    age[rng.choice(d, n, replace=False)] = np.nan
    age[idx[:len(special)]] = special[:min(k, len(special))]
    x = {"idx": idx, "age": age,
         "g_prev": _traps(rng.normal(size=d).astype(np.float32), rng, n),
         "sel_count": rng.integers(0, 9, size=d).astype(np.float32),
         "ef_sum": _traps((rng.normal(size=d) * 3).astype(np.float32), rng,
                          n),
         "sent": _traps(rng.normal(size=d).astype(np.float32), rng, n),
         "noise": rng.normal(size=d).astype(np.float32),
         "fresh": _traps(rng.normal(size=k).astype(np.float32), rng,
                         max(1, k // 100))}
    x["score"] = _traps(rng.normal(size=d).astype(np.float32), rng, n)
    # the traps of g_prev and sent on selected coordinates as well
    sel = idx[:4]
    x["g_prev"][sel] = np.array([-0.0, np.nan, np.inf, -np.inf],
                                np.float32)[:len(sel)]
    x["sent"][idx[-4:]] = np.array([-0.0, np.nan, -np.inf, np.inf],
                                   np.float32)[-min(k, 4):]
    return x


def _compiled_tail(row, n, noise_std, z):
    """``jax.jit(finish_aggregate)`` on ``row`` at N = ``n`` (a fresh
    function each call, so no compiled trace is reused across draws); with
    noise its normal draw is ``z``."""
    cfg = jax_oac.ChannelConfig(fading="none", noise_std=noise_std)
    fn = jax.jit(lambda key, r: jax_oac.finish_aggregate(key, r, n, cfg))
    if z is None:
        return fn(jax.random.PRNGKey(0), row)
    with mock.patch.object(jax_oac.jax.random, "normal",
                           lambda *a, **kw: jnp.asarray(z)):
        return fn(jax.random.PRNGKey(0), row)


def _jax_trainer_update(x, superposed, noise_std, ef, n):
    """The JAX trainer's server step on the same inputs, its arithmetic
    compiled -> (g_t, age', mask, sel_count', residual | None, the draw z
    handed to the port)."""
    d, k = x["g_prev"].shape[0], x["idx"].shape[0]
    idx = jnp.asarray(x["idx"])
    row = jnp.asarray(x["fresh"])
    z = None
    if superposed:
        if noise_std > 0.0:
            z = np.asarray(jax.random.normal(jax.random.PRNGKey(k), (k,),
                                             jnp.float32))
        row = _compiled_tail(row, n, noise_std, z)
    g_t = jax_oac.reconstruct(jnp.asarray(x["g_prev"]), idx, row)
    age = jax_aou.update_age_by_indices(jnp.asarray(x["age"]), idx)
    mask = jnp.zeros((d,), jnp.float32).at[idx].set(1.0)
    count = jnp.asarray(x["sel_count"]).at[idx].add(1.0)
    res = (jax.jit(lambda e, m: (e / n) * (1.0 - m))(
        jnp.asarray(x["ef_sum"]), mask) if ef else None)
    return g_t, age, mask, count, res, z


CASES = [(1, 1), (7, 1), (7, 7), (1001, 1), (1001, 3), (1001, 100),
         (1001, 1001), (5000, 500)]


@pytest.mark.parametrize("n", N_TRAINER)
@pytest.mark.parametrize("superposed,noise_std,ef", [
    (False, 0.0, False), (False, 0.0, True), (True, 0.0, False),
    (True, 0.1, False), (True, 0.1, True), (True, 2.0, True)])
@pytest.mark.parametrize("d,k", CASES)
def test_trainer_update_matches_jax(d, k, superposed, noise_std, ef, n):
    x = _state(d, k, seed=d + 7 * k)
    j = _jax_trainer_update(x, superposed, noise_std, ef, n)
    t = ops.aou_merge_by_indices(
        to_torch(x["idx"]), to_torch(x["fresh"]), to_torch(x["g_prev"]),
        to_torch(x["age"]), to_torch(x["sel_count"]), n_clients=n,
        superposed=superposed,
        z=None if j[5] is None else to_torch(j[5]), noise_std=noise_std,
        ef_sum=to_torch(x["ef_sum"]) if ef else None)
    for what, a, b in zip(("g_t", "age'", "mask", "sel_count'"), t, j):
        _same_floats(a, b, what)
    if ef:
        _same_floats(t[4], j[4], "residual'")
    else:
        assert t[4] is None
    age = to_np(t[1])
    sel = x["idx"]
    assert (age[sel] == 0.0).all() and not np.signbit(age[sel]).any()
    assert np.nanmax(age) <= packing.AGE_CAP


def _jax_engine_update(x, noise_scale, res):
    """``repro.core.engine.masked_merge`` of the noisy sent row over the
    JAX mask of ``idx``, and the residual -> (g_t, age', residual)."""
    d = x["g_prev"].shape[0]
    mask = jax_selection.mask_from_indices(jnp.asarray(x["idx"]), d)
    sent = jnp.asarray(x["sent"])
    noisy = sent
    if noise_scale:
        noisy = sent + noise_scale * jnp.asarray(x["noise"])
    g_t, age = jax_engine.masked_merge(noisy, jnp.asarray(x["g_prev"]),
                                       jnp.asarray(x["age"]), mask)
    residual = jnp.asarray(x["score"]) - mask * sent if res else None
    return g_t, age, residual


@pytest.mark.parametrize("noise_scale,res", [(0.0, False), (0.0, True),
                                             (0.1 / N_CLIENTS, True),
                                             (2.0 / N_CLIENTS, False)])
@pytest.mark.parametrize("d,k", CASES)
def test_engine_update_matches_jax(d, k, noise_scale, res):
    x = _state(d, k, seed=3 * d + k)
    j = _jax_engine_update(x, noise_scale, res)
    t = ops.masked_merge_by_indices(
        to_torch(x["idx"]), to_torch(x["sent"]), to_torch(x["g_prev"]),
        to_torch(x["age"]),
        noise=to_torch(x["noise"]) if noise_scale else None,
        noise_scale=noise_scale,
        score=to_torch(x["score"]) if res else None)
    _same_floats(t[0], j[0], "g_t")
    _same_floats(t[1], j[1], "age'")
    if res:
        _same_floats(t[2], j[2], "residual'")
    else:
        assert t[2] is None


def test_the_two_forms_stay_apart():
    """At a selected coordinate the trainer copies and the engine
    multiplies: a −0.0 fresh value over a positive ``g_prev`` stays −0.0
    in the first and is +0.0 in the second; a NaN ``g_prev`` is replaced in
    the first and stays NaN in the second; a NaN age is +0.0 in the first
    and NaN in the second, an age below −1 −0.0 in the second."""
    idx = torch.tensor([2, 0, 3], dtype=torch.int64)
    fresh = torch.tensor([-0.0, -0.0, 5.0])
    g_prev = torch.tensor([1.0, 7.0, 2.0, float("nan")])
    age = torch.tensor([float("nan"), 3.0, -2.5, 4.0])
    t = ops.aou_merge_by_indices(idx, fresh, g_prev, age, torch.zeros(4),
                                 n_clients=1)
    sent = torch.zeros(4)
    sent[idx] = fresh
    e = ops.masked_merge_by_indices(idx, sent, g_prev, age)
    np.testing.assert_array_equal(np.signbit(to_np(t[0])),
                                  [True, False, True, False])
    assert float(t[0][3]) == 5.0 and np.isnan(float(e[0][3]))
    np.testing.assert_array_equal(np.signbit(to_np(e[0][:3])),
                                  [False, False, False])
    np.testing.assert_array_equal(to_np(t[1]), [0.0, 4.0, 0.0, 0.0])
    assert np.isnan(float(e[1][0])) and float(e[1][2]) == 0.0
    assert np.signbit(float(e[1][2])) and not np.signbit(float(t[1][2]))


def test_index_forms_check_their_mode_and_noise():
    x = torch.zeros(8)
    idx = torch.tensor([1, 4])
    with pytest.raises(ValueError, match="CUDA"):
        ops.aou_merge_by_indices(idx, x[:2], x, x, x, n_clients=2,
                                 mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.masked_merge_by_indices(idx, x, x, x, mode="kernel")
    with pytest.raises(ValueError, match="mode"):
        ops.masked_merge_by_indices(idx, x, x, x, mode="pallas")
    with pytest.raises(ValueError, match="needs a noise draw z"):
        ops.aou_merge_by_indices(idx, x[:2], x, x, x, n_clients=2,
                                 superposed=True, noise_std=0.1)
    # without the tail, or with noise_std 0, a draw is not read
    z = torch.full((2,), float("nan"))
    for kw in (dict(superposed=False, noise_std=0.1),
               dict(superposed=True, noise_std=0.0)):
        out = ops.aou_merge_by_indices(idx, x[:2] + 4.0, x, x, x,
                                       n_clients=2, z=z, **kw)
        assert not torch.isnan(out[0]).any()


def test_index_forms_count_no_launch_on_the_cpu():
    before = aou_merge.LAUNCHES
    x = torch.ones(16)
    idx = torch.tensor([3, 1, 9])
    ops.aou_merge_by_indices(idx, x[:3], x, x, x, n_clients=4,
                             superposed=True, z=x[:3], noise_std=0.5,
                             ef_sum=x)
    ops.masked_merge_by_indices(idx, x, x, x, noise=x, noise_scale=0.1,
                                score=x)
    assert aou_merge.LAUNCHES == before
