"""The launch path's train step (``repro_torch.launch``) against the JAX
package's (``repro.launch.steps.make_train_step(..., sequence_parallel=
False)`` on a 1×1 ``("data", "model")`` CPU mesh), on the reduced
``internvl2-1b`` (15 leaves, 1,378,560 packed coordinates).

* The update phase (server phase + AdamW), fed the same gradient tree,
  the same state and the reference's draws (noise, fades, the population
  round, the fading chain's normals), 4 steps per configuration: the
  reference's phase is the function its step hands to ``shard_map``,
  captured and jitted.  Parameters, optimizer state and every server
  buffer (``g``, ``age``, ``res``, ``ctrl``, ``shadow``, ``pending``,
  per-leaf trees) equal bit for bit (a NaN matches a NaN), with two
  exceptions named: the carried θ_M and θ_A (``theta[:2]``) within 2 ulps
  — θ_M is an ``exp2`` of the histogram estimate and XLA's float32
  ``exp2`` differs from the correctly rounded one on most inputs; the
  legacy route's sampled-quantile bootstrap contracts either product of
  ``jnp.quantile``'s last step into the FMA (``tests/test_torch_
  threshold.py``) —, and the wireless chain ``fad``
  within 3e-7 (a few ulps of its unit-scale components: XLA folds the
  AR(1) scale into the normal draw's ``erfinv`` value; the erasures it
  yields are equal here, since ``g`` and ``age`` are).
* The whole step, 2 steps from the reference's initial state: loss within
  rtol 1e-3 in bf16 compute and 1e-5 in float32; ages agree on ≥ 99% /
  ≥ 99.9% of coordinates; parameters within 2.2e-3 per step (an AdamW
  step moves a coordinate by up to lr = 1e-3, twice that apart if a small
  gradient's sign flips:
  the key bias's gradient is zero up to rounding, so its Adam steps are
  ±lr in both packages), and within 1e-4 (a tenth of lr: bf16 gradients
  differ by up to 2% and AdamW normalizes them) on ≥ 99% of them in bf16
  compute, within 1e-6 on ≥ 99.9% in float32.
* The launcher's ``--ckpt-every`` / ``--resume`` continues one trajectory
  bit for bit, walking back past a corrupt and a torn checkpoint.
* The other layer families (reduced ``granite-moe-3b-a800m``,
  ``mamba2-370m``, ``whisper-base`` and ``jamba-1.5-large-398b``) through
  the whole step in float32 compute, 2 steps, against the reference's
  step run inside ``with MESH:`` (the MoE expert pin needs the mesh
  context), and the launcher's ``--resume`` on the SSD and
  encoder-decoder stacks.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import to_np

from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape as JaxShape
from repro.core import channel as jchan
from repro.core import population as jpop
from repro.data.tokens import lm_batch
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch import checkpoint
from repro_torch import tree as tree_util
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import channel, packing, population
from repro_torch.kernels import ops
from repro_torch.launch import steps, train

ARCH = "internvl2-1b"
SEQ, BATCH, N_MICRO = 32, 2, 2
MESH = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))

POP = dict(n_clients=2000, participants=16, slow_frac=0.25, mode="diurnal",
           depth=0.1)
WIRELESS = dict(rho_f=0.5, gmin=0.3, pmax=10.0)
CONFIGS = {
    "default": {},
    "one_bit_ef": dict(one_bit=True, error_feedback=True, noise_std=0.5),
    "adaptive": dict(adaptive_km=True),
    "async": dict(async_agg=True),
    "legacy_stats_ef": dict(fused_stats=False, error_feedback=True),
    "per_leaf": dict(packed=False),
    "composed": dict(adaptive_km=True, async_agg=True, sanitize=True,
                     fade=0.05, wireless=WIRELESS),
    "population": dict(sanitize=True, fade=0.05, async_agg=True,
                       population=POP),
}


def _oac_pair(kw):
    jkw, tkw = dict(kw), dict(kw)
    if "population" in kw:
        jkw["population"] = jpop.PopulationConfig(**kw["population"])
        tkw["population"] = population.PopulationConfig(**kw["population"])
    if "wireless" in kw:
        jkw["wireless"] = jchan.ChannelConfig(**kw["wireless"])
        tkw["wireless"] = channel.ChannelConfig(**kw["wireless"])
    return jsteps.OacServerConfig(**jkw), steps.OacServerConfig(**tkw)


def _jax_cfg(compute="bfloat16"):
    return dataclasses.replace(jax_get_config(ARCH, reduced_variant=True),
                               compute_dtype=compute)


def _cfg(compute="bfloat16"):
    return dataclasses.replace(get_config(ARCH, reduced_variant=True),
                               compute_dtype=compute)


def _reference(oac, compute="bfloat16"):
    """(the reference's StepBundle, its jitted update phase)."""
    captured = {}
    orig = jsteps.compat.shard_map

    def spy(*args, **kw):
        fn = orig(*args, **kw)
        captured["update"] = fn
        return fn
    jsteps.compat.shard_map = spy
    try:
        bundle = jsteps.make_train_step(
            _jax_cfg(compute), JaxShape("custom", SEQ, BATCH, "train"), MESH,
            n_micro=N_MICRO, oac=oac, sequence_parallel=False)
    finally:
        jsteps.compat.shard_map = orig
    return bundle, jax.jit(captured.get("update"))


def _jax_state(oac, compute="bfloat16"):
    cfg = _jax_cfg(compute)
    params = jtr.init_lm(jax.random.PRNGKey(0), cfg)
    opt_state = jax_make_optimizer("adamw", 1e-3).init(params)
    server = jsteps.init_server_state(params, mesh=MESH, cfg=cfg, oac=oac)
    return params, opt_state, server


def _to_port(tree):
    return steps.state_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _ref_draws(joac, seed, d, leaves=None):
    """The reference's draws for step ``seed`` on the 1×1 mesh, by the
    port's names: its shard key is ``fold_in(PRNGKey(seed), 0)``."""
    base = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    f32 = jnp.float32
    out = {}
    if not joac.packed:
        if joac.noise_std > 0.0:
            out["leaf_noise"] = [
                jax.random.normal(jax.random.fold_in(base, i), (n,), f32)
                for i, n in enumerate(leaves)]
        return {k: [torch.from_numpy(np.array(x)) for x in v]
                for k, v in out.items()}
    if joac.noise_std > 0.0:
        out["noise"] = jax.random.normal(base, (d,), f32)
    if joac.wireless is not None:
        nb = jchan.n_blocks(d, joac.wireless)
        out["fad_w"] = jax.random.normal(jax.random.fold_in(base, 0xC4A),
                                         (nb, 2), f32)
        out["csi"] = jax.random.normal(jax.random.fold_in(base, 0xC51),
                                       (nb,), f32)
    if joac.fade > 0.0:
        out["fade_u"] = jax.random.uniform(
            jax.random.fold_in(base, 0xFADE), (-(-d // joac.fade_block),))
    if joac.population is not None:
        pc = joac.population
        out["churn_u"] = jax.random.uniform(
            jax.random.fold_in(base, 0x509), (-(-d // pc.erase_block),))
        stats = jpop.stateless_round(jax.random.PRNGKey(0x509),
                                     jnp.int32(seed), pc)
        out["pop"] = {k: torch.from_numpy(np.array(v))
                      for k, v in stats.items()}
    return {k: (v if isinstance(v, dict) else torch.from_numpy(np.array(v)))
            for k, v in out.items()}


def _bits(t):
    t = to_np(t.detach().to(torch.float32) if t.dtype == torch.bfloat16
              else t.detach())
    return t


def _jbits(j):
    j = np.asarray(j)
    return j.astype(np.float32) if j.dtype == jnp.bfloat16 else j


def _equal(t, j, what):
    """Bit for bit; a NaN matches a NaN (bf16 casts need not keep a NaN's
    sign and payload)."""
    t, j = _bits(t), _jbits(j)
    assert t.shape == j.shape and t.dtype == j.dtype, what
    if t.dtype == np.float32:
        nan = np.isnan(t)
        np.testing.assert_array_equal(nan, np.isnan(j), err_msg=what)
        np.testing.assert_array_equal(t[~nan].view(np.int32),
                                      j[~nan].view(np.int32), err_msg=what)
    else:
        np.testing.assert_array_equal(t, j, err_msg=what)


def _tree_equal(t_tree, j_tree, what):
    tl = tree_util.leaves(t_tree)
    jl = jax.tree_util.tree_leaves(j_tree)
    assert len(tl) == len(jl), what
    for (path, t), j in zip(tl, jl):
        _equal(t, j, f"{what} {path}")


def _server_equal(t_srv, j_srv, what):
    assert set(t_srv) == set(j_srv), what
    for key in j_srv:
        if key == "theta":
            t, j = _bits(t_srv[key]), _jbits(j_srv[key])
            np.testing.assert_array_max_ulp(t[:2], j[:2], maxulp=2)
            _equal(t_srv[key][2:], j_srv[key][2:], f"{what} theta[2:]")
        elif key == "fad":
            np.testing.assert_allclose(_bits(t_srv[key]), _jbits(j_srv[key]),
                                       rtol=0, atol=3e-7)
        else:
            _tree_equal(t_srv[key], j_srv[key], f"{what} {key}")


def _grads(params, rng, scale, nonfinite=False):
    def leaf(p):
        g = (rng.normal(size=p.shape) * scale).astype(np.float32)
        if nonfinite and g.size > 100:
            flat = g.reshape(-1)
            flat[rng.choice(flat.size, 6, replace=False)] = [
                np.nan, np.inf, -np.inf, np.nan, 0.0, -0.0]
        return g
    return jax.tree.map(leaf, params)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_update_phase_matches_the_reference(name):
    joac, toac = _oac_pair(CONFIGS[name])
    _, j_update = _reference(joac)
    params, opt_state, server = _jax_state(joac)
    tp, to, ts = _to_port(params), _to_port(opt_state), _to_port(server)
    bundle = steps.make_train_step(_cfg(), InputShape("custom", SEQ, BATCH,
                                                      "train"),
                                   n_micro=N_MICRO, oac=toac, device="cpu")
    assert bundle.meta["oac_packed"] == joac.packed
    d = bundle.layout.d_packed if bundle.layout is not None else None
    sizes = [int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params)]
    rng = np.random.default_rng(7)
    pads = (~to_np(bundle.layout.valid_mask("cpu"))
            if bundle.layout is not None else None)
    for seed in range(4):
        grads = _grads(params, rng, 0.01 * (1 + seed),
                       nonfinite=joac.sanitize and seed == 2)
        draws = _ref_draws(joac, seed, d, sizes)
        params, opt_state, server = j_update(
            params, opt_state, server, jax.tree.map(jnp.asarray, grads),
            jnp.int32(seed))
        c0 = (ops.FAIRK_UPDATE_CALLS, packing.PACK_CALLS,
              packing.UNPACK_CALLS)
        out = bundle.update(tp, to, ts, steps.state_from_numpy(grads, "cpu"),
                            seed, draws)
        assert out[0] is tp and out[1] is to and out[2] is ts
        if joac.packed:
            assert (ops.FAIRK_UPDATE_CALLS - c0[0], packing.PACK_CALLS - c0[1],
                    packing.UNPACK_CALLS - c0[2]) == (1, 1, 1)
            assert (to_np(ts["age"])[pads] == packing.PAD_AGE).all()
        what = f"{name} step {seed}"
        _tree_equal(tp, params, f"{what} params")
        _tree_equal(to, opt_state, f"{what} opt")
        _server_equal(ts, server, f"{what} server")
    if joac.packed:
        assert float(ts["theta"][4]) == 1.0          # init
        assert 0 < float(ts["theta"][3]) < bundle.layout.d_valid


def test_coherent_noise_within_ulps():
    """The channel noise on the selected coordinates: XLA folds the
    ``noise_std / N`` scale into the draw, so the bf16 ``g`` is held
    within one bf16 ulp (and the age exactly)."""
    joac, toac = _oac_pair(dict(noise_std=0.3))
    _, j_update = _reference(joac)
    params, opt_state, server = _jax_state(joac)
    tp, to, ts = _to_port(params), _to_port(opt_state), _to_port(server)
    bundle = steps.make_train_step(_cfg(), InputShape("custom", SEQ, BATCH,
                                                      "train"),
                                   n_micro=N_MICRO, oac=toac, device="cpu")
    rng = np.random.default_rng(3)
    for seed in range(2):
        grads = _grads(params, rng, 0.01)
        draws = _ref_draws(joac, seed, bundle.layout.d_packed)
        params, opt_state, server = j_update(
            params, opt_state, server, jax.tree.map(jnp.asarray, grads),
            jnp.int32(seed))
        bundle.update(tp, to, ts, steps.state_from_numpy(grads, "cpu"), seed,
                      draws)
        _equal(ts["age"], server["age"], "age")
        words = ts["g"].view(torch.int16).numpy().astype(np.int32)
        j_words = np.asarray(server["g"]).view(np.int16).astype(np.int32)
        assert np.abs(words - j_words).max() <= 1


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def whole_step(request):
    compute = request.param
    joac, toac = _oac_pair({})
    jbundle, _ = _reference(joac, compute)
    return compute, jax.jit(jbundle.fn), joac, toac


def test_whole_step_matches_the_reference(whole_step):
    compute, j_fn, joac, toac = whole_step
    cfg = _cfg(compute)
    params, opt_state, server = _jax_state(joac, compute)
    tp, to, ts = _to_port(params), _to_port(opt_state), _to_port(server)
    bundle = steps.make_train_step(cfg, InputShape("custom", SEQ, BATCH,
                                                   "train"),
                                   n_micro=N_MICRO, oac=toac, device="cpu")
    agree_min = 0.99 if compute == "bfloat16" else 0.999
    close_tol = 1e-4 if compute == "bfloat16" else 1e-6
    loss_rtol = 1e-3 if compute == "bfloat16" else 1e-5
    s_text = SEQ - cfg.n_patches
    for t in range(2):
        toks, labels = lm_batch(t, BATCH, s_text, cfg.vocab)
        emb = (np.random.default_rng(t).normal(
            size=(N_MICRO, BATCH // N_MICRO, cfg.n_patches, cfg.d_model))
            * 0.1).astype(np.float32)
        shape = (N_MICRO, BATCH // N_MICRO, s_text)
        jb = {"tokens": jnp.asarray(toks.reshape(shape)),
              "labels": jnp.asarray(labels.reshape(shape)),
              "embeds": jnp.asarray(emb).astype(jnp.dtype(compute))}
        with MESH:
            params, opt_state, server, j_loss = j_fn(params, opt_state,
                                                     server, jb,
                                                     jnp.int32(t))
        tb = {k: steps.state_from_numpy(np.asarray(v), "cpu")
              for k, v in jb.items()}
        tp, to, ts, loss = bundle.fn(tp, to, ts, tb, t)
        np.testing.assert_allclose(float(loss), float(j_loss),
                                   rtol=loss_rtol)
        agree = float((_bits(ts["age"]) == _jbits(server["age"])).mean())
        assert agree >= agree_min, (t, agree)
        close = total = 0
        for (path, x), j in zip(tree_util.leaves(tp),
                                jax.tree_util.tree_leaves(params)):
            diff = np.abs(_bits(x) - _jbits(j))
            assert diff.max() <= 2.2e-3 * (t + 1), (t, path, diff.max())
            close += int((diff <= close_tol).sum())
            total += diff.size
        assert close / total >= agree_min, (t, close / total)
        np.testing.assert_allclose(_bits(ts["theta"])[3],
                                   _jbits(server["theta"])[3], rtol=0.02)


FAMILIES = ("granite-moe-3b-a800m", "mamba2-370m", "whisper-base",
            "jamba-1.5-large-398b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_whole_step_of_every_family_matches_the_reference(arch):
    """The MoE, Mamba-2, encoder-decoder and hybrid stacks through the
    whole step (float32 compute, the default persisted server phase, the
    configuration's optimizer: jamba's ``sgdm`` on bf16 parameters), 2
    steps from the reference's initial state: the loss (with the MoE aux
    term) within rtol 1e-5, ages equal on ≥ 99.9% of coordinates,
    parameters within 2.2e-3 per step and within 1e-6 on ≥ 99.9% of them
    (a bf16 parameter: within one bf16 ulp on ≥ 99.9%)."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced_variant=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced_variant=True),
                              compute_dtype="float32")
    joac, toac = _oac_pair({})
    jshape = JaxShape("custom", SEQ, BATCH, "train")
    jbundle = jsteps.make_train_step(jcfg, jshape, MESH, n_micro=N_MICRO,
                                     oac=joac, sequence_parallel=False)
    bundle = steps.make_train_step(cfg, InputShape("custom", SEQ, BATCH,
                                                   "train"),
                                   n_micro=N_MICRO, oac=toac, device="cpu")
    assert bundle.meta == jbundle.meta
    specs = steps.train_input_specs(cfg, InputShape("custom", SEQ, BATCH,
                                                    "train"), N_MICRO,
                                    BATCH // N_MICRO)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in specs.items()} == {
        k: (v.shape, "torch." + str(v.dtype))
        for k, v in jbundle.input_specs[3].items()}
    params = jtr.init_lm(jax.random.PRNGKey(0), jcfg)
    opt_state = jax_make_optimizer(jbundle.meta["optimizer"],
                                   1e-3).init(params)
    server = jsteps.init_server_state(params, mesh=MESH, cfg=jcfg, oac=joac)
    tp, to, ts = _to_port(params), _to_port(opt_state), _to_port(server)
    j_fn = jax.jit(jbundle.fn)
    rng = np.random.default_rng(11)
    for t in range(2):
        jb = {}
        for key, spec in jbundle.input_specs[3].items():
            if key in ("tokens", "labels"):
                continue
            jb[key] = jnp.asarray((rng.normal(size=spec.shape) * 0.1)
                                  .astype(np.float32))
        toks, labels = lm_batch(t, BATCH, SEQ, cfg.vocab)
        shape = (N_MICRO, BATCH // N_MICRO, SEQ)
        jb["tokens"] = jnp.asarray(toks.reshape(shape))
        jb["labels"] = jnp.asarray(labels.reshape(shape))
        with MESH:
            params, opt_state, server, j_loss = j_fn(params, opt_state,
                                                     server, jb,
                                                     jnp.int32(t))
        tb = {k: steps.state_from_numpy(np.asarray(v), "cpu")
              for k, v in jb.items()}
        c0 = ops.FAIRK_UPDATE_CALLS
        tp, to, ts, loss = bundle.fn(tp, to, ts, tb, t)
        assert ops.FAIRK_UPDATE_CALLS - c0 == 1
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
        agree = float((_bits(ts["age"]) == _jbits(server["age"])).mean())
        assert agree >= 0.999, (t, agree)
        close = total = 0
        for (path, x), j in zip(tree_util.leaves(tp),
                                jax.tree_util.tree_leaves(params)):
            diff = np.abs(_bits(x) - _jbits(j))
            assert diff.max() <= 2.2e-3 * (t + 1), (t, path, diff.max())
            tol = (1e-6 if x.dtype == torch.float32
                   else 2.0 ** -8 * np.abs(_jbits(j)))
            close += int((diff <= tol).sum())
            total += diff.size
        assert close / total >= 0.999, (t, close / total)


def test_meta_and_argument_checks_match_the_reference():
    shape_t = InputShape("custom", SEQ, BATCH, "train")
    for kw in ({}, dict(one_bit=True, error_feedback=True),
               dict(packed=False)):
        joac, toac = _oac_pair(kw)
        jb = jsteps.make_train_step(_jax_cfg(), JaxShape("custom", SEQ, BATCH,
                                                         "train"), MESH,
                                    n_micro=N_MICRO, oac=joac,
                                    sequence_parallel=False)
        tb = steps.make_train_step(_cfg(), shape_t, n_micro=N_MICRO,
                                   oac=toac, device="cpu")
        assert tb.meta == jb.meta
    bad = [dict(error_feedback=True, packed=False),
           dict(one_bit=True, packed=False),
           dict(adaptive_km=True, fused_stats=False),
           dict(sanitize=True, packed=False), dict(fade=0.1),
           dict(async_agg=True, packed=False),
           dict(async_agg=True, straggler_frac=1.5),
           dict(async_agg=True, straggler_lag=0),
           dict(population=dict(n_clients=100)),
           dict(sanitize=True, one_bit=True, population=dict(n_clients=100)),
           dict(sanitize=True, population=dict(n_clients=100, mode="ge")),
           dict(sanitize=True, population=dict(n_clients=100,
                                               slow_frac=0.2)),
           dict(wireless={})]
    for kw in bad:
        joac, toac = _oac_pair(kw)
        with pytest.raises(ValueError) as j_err:
            jsteps.make_train_step(_jax_cfg(), JaxShape("custom", SEQ, BATCH,
                                                        "train"), MESH,
                                   n_micro=N_MICRO, oac=joac,
                                   sequence_parallel=False)
        with pytest.raises(ValueError) as t_err:
            steps.make_train_step(_cfg(), shape_t, n_micro=N_MICRO, oac=toac,
                                  device="cpu")
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="client_chunk"):
        steps.make_train_step(_cfg(), shape_t, n_micro=2, client_chunk=3,
                              device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        steps.make_train_step(_cfg(), InputShape("custom", SEQ, 3, "train"),
                              n_micro=2, device="cpu")


def test_init_server_state_matches_the_reference():
    for kw in ({}, dict(error_feedback=True, adaptive_km=True,
                        async_agg=True, sanitize=True, wireless=WIRELESS),
               dict(packed=False)):
        joac, toac = _oac_pair(kw)
        params, _, j_srv = _jax_state(joac)
        t_srv = steps.init_server_state(_to_port(params), oac=toac)
        assert set(t_srv) == set(j_srv)
        for key in j_srv:
            tl = tree_util.leaves(t_srv[key])
            jl = jax.tree_util.tree_leaves(j_srv[key])
            for (_, t), j in zip(tl, jl):
                assert tuple(t.shape) == j.shape
                assert str(t.dtype) == "torch." + str(j.dtype)
                if key != "fad":    # each package's own stationary draw
                    _equal(t, j, key)


def test_client_chunk_and_no_oac():
    """``client_chunk`` accumulates the same gradients (chunk sums in
    another order: float32 within 1e-6); ``gather_dtype`` takes them
    through bf16 matrices; ``oac=None`` applies them directly."""
    cfg = _cfg("float32")
    shape = InputShape("custom", SEQ, 4, "train")
    gen = torch.Generator().manual_seed(0)
    params = steps.tr.init_lm(gen, cfg)
    batch = train.make_batch(cfg, 0, 0, 4, SEQ - cfg.n_patches, 4, "cpu")
    loss_a, g_a = steps.make_train_step(cfg, shape, n_micro=4,
                                        device="cpu").grads_fn(params, batch)
    loss_b, g_b = steps.make_train_step(cfg, shape, n_micro=4,
                                        client_chunk=2,
                                        device="cpu").grads_fn(params, batch)
    assert abs(float(loss_a) - float(loss_b)) < 1e-6
    for (_, a), (_, b) in zip(tree_util.leaves(g_a), tree_util.leaves(g_b)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    # gather_dtype: the matrices enter the loss in bf16, the gradients
    # come back float32 (bf16 tolerance of each leaf's largest magnitude)
    _, g_c = steps.make_train_step(cfg, shape, n_micro=4,
                                   gather_dtype="bfloat16",
                                   device="cpu").grads_fn(params, batch)
    for (_, a), (_, c) in zip(tree_util.leaves(g_a), tree_util.leaves(g_c)):
        assert c.dtype == torch.float32
        torch.testing.assert_close(c, a, rtol=0,
                                   atol=0.05 * float(a.abs().max()))
    b_none = steps.make_train_step(cfg, shape, n_micro=4, oac=None,
                                   device="cpu")
    p0 = tree_util.tree_map(lambda x: x.clone(), params)
    from repro_torch.optim import make_optimizer
    opt = make_optimizer("adamw", 1e-3)
    st = opt.init(params)
    srv = steps.init_server_state(params, oac=None)
    b_none.fn(params, st, srv, batch, 0)
    moved = [float((a - b).abs().max()) for (_, a), (_, b) in
             zip(tree_util.leaves(params), tree_util.leaves(p0))]
    assert max(moved) > 0 and int(st["step"]) == 1


def test_server_draws_are_named_streams():
    oac = steps.OacServerConfig(noise_std=1.0, sanitize=True, fade=0.1,
                                wireless=channel.ChannelConfig(csi_err=0.1),
                                population=population.PopulationConfig(
                                    n_clients=500))
    lay = packing.PackedLayout.from_tree({"w": torch.zeros(1000)})
    a = steps.server_draws(oac, 3, lay, "cpu")
    b = steps.server_draws(oac, 3, lay, "cpu")
    c = steps.server_draws(oac, 4, lay, "cpu")
    assert set(a) == {"noise", "fad_w", "csi", "fade_u", "pop", "churn_u"}
    for key in ("noise", "fad_w", "csi", "fade_u", "churn_u"):
        assert torch.equal(a[key], b[key]) and not torch.equal(a[key],
                                                               c[key])
    assert not torch.equal(a["noise"][:16], a["fad_w"].reshape(-1)[:16])


def test_state_from_numpy_takes_bf16_as_words_or_extension():
    x = jnp.asarray([1.5, -2.0, 3.0e-3], jnp.bfloat16)
    words = np.asarray(x).view(np.uint16)
    for a in (np.asarray(x), words):
        t = steps.state_from_numpy({"g": a, "n": None,
                                    "age": np.int8([1, -1])}, "cpu")
        assert t["g"].dtype == torch.bfloat16 and t["n"] is None
        np.testing.assert_array_equal(t["g"].float().numpy(),
                                      np.asarray(x, np.float32))
        assert t["age"].dtype == torch.int8


def test_state_from_numpy_keeps_float32_leaves_of_bf16_trees():
    """jamba's bf16 tree holds float32 routers and Mamba scalars
    (``a_log``, ``d_skip``, ``dt_bias``): each leaf keeps its dtype and
    its bits."""
    params = jtr.init_lm(jax.random.PRNGKey(0), jax_get_config(
        "jamba-1.5-large-398b", reduced_variant=True))
    tp = _to_port(params)
    kinds = set()
    for (path, t), j in zip(tree_util.leaves(tp),
                            jax.tree_util.tree_leaves(params)):
        _equal(t, j, str(path))
        kinds.add((path[-2] if path[-1] == "w" else path[-1], str(t.dtype)))
    for name in ("router", "a_log", "d_skip", "dt_bias"):
        assert (name, "torch.float32") in kinds
    assert ("wu", "torch.bfloat16") in kinds


def _launch(argv, ckpt_dir):
    base = ["--arch", ARCH, "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(ckpt_dir), "--adaptive-km", "--ef"]
    return train.main(base + argv)


def test_cli_resume_continues_one_trajectory(tmp_path):
    whole = _launch(["--steps", "4"], tmp_path / "a")
    first = _launch(["--steps", "2", "--ckpt-every", "2"], tmp_path / "b")
    assert first["losses"] == whole["losses"][:2]
    rest = _launch(["--steps", "2", "--resume"], tmp_path / "b")
    assert rest["start"] == 2 and rest["losses"] == whole["losses"][2:]
    for key in ("params", "opt", "server"):
        for (path, a), (_, b) in zip(tree_util.leaves(rest[key]),
                                     tree_util.leaves(whole[key])):
            assert torch.equal(a, b), (key, path)


@pytest.mark.parametrize("arch", ["mamba2-370m", "whisper-base"])
def test_cli_resume_continues_one_trajectory_of_every_family(arch, tmp_path):
    """The launcher on the SSD and the encoder-decoder stacks (seeded
    normal frames feed whisper's encoder): 4 steps against 2 steps, a
    checkpoint and ``--resume`` for 2 more, bit for bit."""
    base = ["--arch", arch, "--batch", "2", "--seq", "16", "--device",
            "cpu", "--client-chunk", "2"]
    whole = train.main(base + ["--steps", "4", "--ckpt-dir",
                               str(tmp_path / "a")])
    train.main(base + ["--steps", "2", "--ckpt-every", "2", "--ckpt-dir",
                       str(tmp_path / "b")])
    rest = train.main(base + ["--steps", "2", "--resume", "--ckpt-dir",
                              str(tmp_path / "b")])
    assert rest["start"] == 2 and rest["losses"] == whole["losses"][2:]
    assert all(np.isfinite(whole["losses"]))
    for key in ("params", "opt", "server"):
        for (path, a), (_, b) in zip(tree_util.leaves(rest[key]),
                                     tree_util.leaves(whole[key])):
            assert torch.equal(a, b), (key, path)


def test_cli_resume_walks_back_past_bad_checkpoints(tmp_path, capsys):
    _launch(["--steps", "6", "--ckpt-every", "2"], tmp_path)
    # step 6: corrupt bytes; step 4: torn (no params/opt companion)
    with open(tmp_path / "server_00000006.npz", "r+b") as f:
        f.seek(os.path.getsize(tmp_path / "server_00000006.npz") // 2)
        f.write(b"\xff" * 64)
    os.remove(tmp_path / "step_00000004.npz")
    out = _launch(["--steps", "1", "--resume"], tmp_path)
    assert out["start"] == 2
    log = capsys.readouterr().out
    assert "checkpoint step 6 failed validation" in log
    assert "checkpoint step 4 failed validation" in log
    # a flag mismatch is not a corrupt checkpoint: it raises
    with pytest.raises(ValueError, match="do not match the configured"):
        train.main(["--arch", ARCH, "--batch", "2", "--seq", "16",
                    "--device", "cpu", "--ckpt-dir", str(tmp_path),
                    "--steps", "1", "--resume"])
    empty = train.main(["--arch", ARCH, "--batch", "2", "--seq", "16",
                        "--device", "cpu", "--steps", "1", "--resume",
                        "--ckpt-dir", str(tmp_path / "none")])
    assert empty["start"] == 0
    with pytest.raises(ValueError, match="PACKED"):
        train.main(["--arch", ARCH, "--device", "cpu", "--per-leaf-server",
                    "--ckpt-every", "1"])


def test_fairk_threshold_masks_match_the_reference():
    rng = np.random.default_rng(5)
    d = 20_000
    g = (rng.standard_t(3, size=d) * 0.1).astype(np.float32)
    age = rng.integers(0, 50, size=d).astype(np.float32)
    joac, toac = _oac_pair(dict(rho=0.05, k_m_frac=0.6))
    j_sel, j_m = jsteps.fairk_threshold_masks(jnp.asarray(g),
                                              jnp.asarray(age), joac, 4096)
    t_sel, t_m = steps.fairk_threshold_masks(torch.from_numpy(g),
                                             torch.from_numpy(age), toac,
                                             4096)
    _equal(t_sel, j_sel, "selected")
    _equal(t_m, j_m, "magnitude stage")
    assert 0.03 * d < float(t_sel.sum()) < 0.07 * d
