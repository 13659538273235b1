"""The port's FL-OAC step (``repro_torch.launch.steps.make_fl_oac_step``)
against the JAX package's on a (2, 4) ``("data", "model")`` mesh: the
reference on 8 placeholder host devices in one subprocess, the port as 8
gloo ranks on the CPU, on the reduced ``mamba2-370m`` (d = 949,920 float32
parameters, nb = 232 blocks of 4,096, kb = 23) at seq 64 in float32
compute, 3 rounds of each variant (FAIR-k, ``baseline``, ``one_bit``,
``adaptive_km``).  Each port round starts from the reference's state of
the round before (its weights, ``g_prev``, ages and controller vector)
and takes the reference's draws (``rayleigh(fold_in(PRNGKey(t), 0))``
and ``normal(fold_in(…, 1))``), so each round is held on its own.

Tolerances: ``meta`` equal; block ages equal exactly; the mean loss
within rtol 1e-5 (float32 forward passes in two libraries); ``g_prev``
within 1e-6 absolute (the fresh blocks, of magnitude up to ~1.6, are a
mean of 8 float32 gradients that the two libraries round differently; a
few ulps) and ``w`` within 2.5e-7 (2 ulps of weights below 2: ``w``
moves by 0.01 of ``g_prev``, so its own rounding dominates), at every
coordinate but the flipped votes.  With ``one_bit`` a vote can flip
where a client's gradient is zero up to rounding, which moves a
coordinate of ``g_prev`` by 2 and of ``w`` by 0.01·2 (ROADMAP, "Checked
and not faults"); so per round at most ``MAX_FLIPS`` coordinates (one
for ``one_bit``, none elsewhere; 0 were measured in every round on the
CPU) may break the bounds above, and at each of them the difference must
be 2 within 1e-6 for ``g_prev`` and 0.02 within 2.5e-7 for ``w``.  An
inverted or wrong vote in any more coordinates fails.  The controller
vector of ``adaptive_km`` within 1e-6.

The bytes handed to ``all_reduce`` are counted by a wrapper the test
puts on ``torch.distributed.all_reduce`` in each rank: FAIR-k's round
sends less than 0.2 of ``baseline``'s (the reference's
``test_fl_oac_collective_reduction`` reads the same from its HLO).  Every
rank ends every round with the same ``w``, ``g_prev`` and ages, bit for
bit.  ``abstract_params`` gives the reference's shapes and dtypes for all
ten configurations at full size.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from rankutil import run_jax, run_ranks

from repro.configs import ARCHS
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.launch import steps

pytestmark = pytest.mark.sharded

VARIANTS = {"fairk": {}, "baseline": {"baseline": True},
            "one_bit": {"one_bit": True},
            "adaptive_km": {"adaptive_km": True}}
ROUNDS = 3
SEQ = 64
W_TOL = 2.5e-7
G_TOL = 1e-6
MAX_FLIPS = {"fairk": 0, "baseline": 0, "one_bit": 1, "adaptive_km": 0}

_JAX = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.flatten_util import ravel_pytree
from repro.configs import get_config
from repro.core import controller as budget
from repro.data.tokens import lm_batch
from repro.launch.steps import make_fl_oac_step
from repro.models import transformer as tr

VARIANTS, ROUNDS, SEQ = json.loads(sys.argv[2]), int(sys.argv[3]), 64
mesh = jax.make_mesh((2, 4), ("data", "model"))
cfg = dataclasses.replace(get_config("mamba2-370m", reduced_variant=True),
                          compute_dtype="float32")
w0, _ = ravel_pytree(tr.init_lm(jax.random.PRNGKey(0), cfg))
out, metas = {"w0": np.asarray(w0)}, {}
for name, kw in VARIANTS.items():
    b = make_fl_oac_step(cfg, mesh, seq_len=SEQ, **kw)
    metas[name] = b.meta
    d, nb, kb = b.meta["d"], b.meta["blocks"], b.meta["kb"]
    fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                 out_shardings=b.out_shardings)
    w, gp, age = w0, jnp.zeros((d,), jnp.float32), jnp.zeros((nb,),
                                                             jnp.float32)
    ctrl = budget.controller_state_to_vec(budget.init_controller_state(0.75))
    out[f"{name}_ctrl0"] = np.asarray(ctrl)
    with mesh:
        for t in range(ROUNDS):
            toks, labels = lm_batch(t, 8, SEQ, cfg.vocab)
            batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
            seed = jnp.asarray(t, jnp.int32)
            if kw.get("adaptive_km"):
                w, gp, age, ctrl, loss = fn(w, gp, age, ctrl, batch, seed)
                out[f"{name}_{t}_ctrl"] = np.asarray(ctrl)
            else:
                w, gp, age, loss = fn(w, gp, age, batch, seed)
            key = jax.random.PRNGKey(t)
            out[f"{name}_{t}_h"] = np.asarray(jax.random.rayleigh(
                jax.random.fold_in(key, 0), 1.0 / 1.2533141373155003,
                shape=(8,), dtype=jnp.float32))
            out[f"{name}_{t}_z"] = np.asarray(jax.random.normal(
                jax.random.fold_in(key, 1), (kb, 4096), jnp.float32))
            for k, v in (("w", w), ("g", gp), ("age", age), ("loss", loss)):
                out[f"{name}_{t}_{k}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
print(json.dumps(metas))
"""

_PORT = r"""
import dataclasses, hashlib, json, sys
import numpy as np
from repro_torch.configs import get_config
from repro_torch.data.tokens import lm_batch
from repro_torch.core import collectives
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps

VARIANTS, ROUNDS, SEQ = json.loads(sys.argv[3]), int(sys.argv[4]), 64
ref = np.load(sys.argv[1])
sent = [0]
_all_reduce = dist.all_reduce

def counting_all_reduce(t, *args, **kwargs):
    sent[0] += t.numel() * t.element_size()
    return _all_reduce(t, *args, **kwargs)

dist.all_reduce = counting_all_reduce
mesh = mesh_lib.make_test_mesh(2, 4, device_type="cpu")
my = collectives.axis_index(mesh)
cfg = dataclasses.replace(get_config("mamba2-370m", reduced_variant=True),
                          compute_dtype="float32")
t_ = lambda a: torch.from_numpy(np.array(a))
out, report = {}, {"my": my, "meta": {}, "bytes": {}, "digest": {}}
for name, kw in VARIANTS.items():
    b = steps.make_fl_oac_step(cfg, mesh, seq_len=SEQ, **kw)
    report["meta"][name] = b.meta
    d, nb = b.meta["d"], b.meta["blocks"]
    for t in range(ROUNDS):
        if t == 0:
            w, gp, age = (t_(ref["w0"]), torch.zeros(d), torch.zeros(nb))
            ctrl = t_(ref[f"{name}_ctrl0"])
        else:
            w, gp, age = (t_(ref[f"{name}_{t - 1}_{k}"])
                          for k in ("w", "g", "age"))
            if kw.get("adaptive_km"):
                ctrl = t_(ref[f"{name}_{t - 1}_ctrl"])
        toks, labels = lm_batch(t, 8, SEQ, cfg.vocab)
        batch = {"tokens": t_(toks[my:my + 1]),
                 "labels": t_(labels[my:my + 1])}
        draws = {"h": t_(ref[f"{name}_{t}_h"]), "z": t_(ref[f"{name}_{t}_z"])}
        sent[0] = 0
        if kw.get("adaptive_km"):
            w, gp, age, ctrl, loss = b.fn(w, gp, age, ctrl, batch, t,
                                          draws=draws)
            out[f"{name}_{t}_ctrl"] = ctrl.numpy()
        else:
            w, gp, age, loss = b.fn(w, gp, age, batch, t, draws=draws)
        report["bytes"][f"{name}_{t}"] = sent[0]
        report["digest"][f"{name}_{t}"] = hashlib.sha256(
            w.numpy().tobytes() + gp.numpy().tobytes()
            + age.numpy().tobytes()).hexdigest()
        for k, v in (("w", w), ("g", gp), ("age", age), ("loss", loss)):
            out[f"{name}_{t}_{k}"] = v.numpy()
if my == 0:
    np.savez(sys.argv[2], **out)
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's rounds, run once for the module."""
    tmp = tmp_path_factory.mktemp("fl_oac")
    ref_path, port_path = str(tmp / "ref.npz"), str(tmp / "port.npz")
    variants = json.dumps(VARIANTS)
    ref_meta = json.loads(run_jax(_JAX, [ref_path, variants, str(ROUNDS)],
                                  timeout=400).strip().splitlines()[-1])
    outs = run_ranks(_PORT, 8, str(tmp),
                     [ref_path, port_path, variants, str(ROUNDS)],
                     timeout=400)
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    return {"ref": dict(np.load(ref_path)), "port": dict(np.load(port_path)),
            "ref_meta": ref_meta, "reports": reports}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_meta_matches_the_reference(runs, name):
    want = dict(runs["ref_meta"][name])
    got = runs["reports"][0]["meta"][name]
    assert got == want
    assert (got["d"], got["blocks"], got["kb"], got["n_clients"]) == (
        949_920, 232, 23, 8)


@pytest.mark.parametrize("t", range(ROUNDS))
@pytest.mark.parametrize("name", list(VARIANTS))
def test_block_ages_equal_exactly(runs, name, t):
    ref, port = runs["ref"], runs["port"]
    age = port[f"{name}_{t}_age"]
    np.testing.assert_array_equal(age, ref[f"{name}_{t}_age"])
    assert int((age == 0).sum()) == 23


@pytest.mark.parametrize("name", list(VARIANTS))
def test_losses_match(runs, name):
    ref, port = runs["ref"], runs["port"]
    got = [float(port[f"{name}_{t}_loss"]) for t in range(ROUNDS)]
    want = [float(ref[f"{name}_{t}_loss"]) for t in range(ROUNDS)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_weights_and_g_prev_within_bounds(runs, name):
    ref, port = runs["ref"], runs["port"]
    for t in range(ROUNDS):
        dw = np.abs(port[f"{name}_{t}_w"] - ref[f"{name}_{t}_w"])
        dg = np.abs(port[f"{name}_{t}_g"] - ref[f"{name}_{t}_g"])
        flips = dg > G_TOL
        assert int(flips.sum()) <= MAX_FLIPS[name], (t, int(flips.sum()))
        assert np.all(dg[~flips] <= G_TOL), t
        assert np.all(dw[~flips] <= W_TOL), t
        # a flipped vote moves g_prev by 2 and w by 0.01·2, up to rounding
        assert np.all(np.abs(dg[flips] - 2.0) <= G_TOL), t
        assert np.all(np.abs(dw[flips] - 0.02) <= W_TOL), t
        if name == "adaptive_km":
            np.testing.assert_allclose(port[f"{name}_{t}_ctrl"],
                                       ref[f"{name}_{t}_ctrl"], atol=1e-6)


def test_fairk_all_reduces_under_a_fifth_of_baseline(runs):
    sent = runs["reports"][0]["bytes"]
    kb, block, loss = 23, 4096, 4
    for t in range(ROUNDS):
        assert sent[f"fairk_{t}"] == kb * block * 4 + loss
        assert sent[f"baseline_{t}"] == 232 * block * 4 + loss
        assert sent[f"fairk_{t}"] / sent[f"baseline_{t}"] < 0.2
        # one_bit: int8 votes over "model", float16 counts over "data"
        assert sent[f"one_bit_{t}"] == kb * block * (1 + 2) + loss


@pytest.mark.parametrize("name", list(VARIANTS))
def test_every_rank_ends_with_the_same_state(runs, name):
    reports = runs["reports"]
    assert sorted(r["my"] for r in reports) == list(range(8))
    for t in range(ROUNDS):
        digests = {r["digest"][f"{name}_{t}"] for r in reports}
        assert len(digests) == 1, (name, t)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_params_match_the_reference(arch):
    want = jax.tree_util.tree_leaves_with_path(
        jsteps.abstract_params(jax_get_config(arch)))
    got = steps.abstract_params(get_config(arch))
    from repro_torch import tree as tree_util
    got = tree_util.leaves(got)
    assert len(got) == len(want)
    for (_, leaf), (_, sds) in zip(got, want):
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(sds.shape)
        assert str(leaf.dtype).split(".")[-1] == jnp.dtype(sds.dtype).name


def test_flat_weights_follow_the_reference_order():
    """``ravel_params`` lays the tree out as ``ravel_pytree`` does."""
    from jax.flatten_util import ravel_pytree
    from repro.models import transformer as jtr
    from repro_torch.launch.steps import state_from_numpy
    cfg = dataclasses.replace(
        jax_get_config("mamba2-370m", reduced_variant=True))
    params = jtr.init_lm(jax.random.PRNGKey(0), cfg)
    flat, _ = ravel_pytree(params)
    port = state_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    np.testing.assert_array_equal(steps.ravel_params(port).numpy(),
                                  np.asarray(flat))
