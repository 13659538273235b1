"""The port's partition specs (``repro_torch.launch.sharding``) and the
sharded server state (``launch.steps``) against the JAX package's.

* Every spec function equals the reference's — ``param_pspecs``,
  ``opt_pspecs``, ``server_pspecs`` (packed, EF, adaptive, async,
  wireless, per leaf), ``cache_pspecs`` (with and without
  ``shard_capacity``) and ``batch_pspec`` — for all ten configurations at
  full width (shapes only: the reference's ``abstract_params`` and the
  port's ``meta`` tensors) on the meshes (16, 16), (2, 16, 16), (2, 4),
  (4, 2) and (1, 1), the reference's given as
  ``jax.sharding.AbstractMesh`` and the port's as
  ``launch.mesh.AbstractMesh``: axis names and sizes only.
* ``server_layout``'s per-shard ``d_packed`` and ``abstract_server_state``
  equal the reference's on the same meshes; ``init_server_state`` on
  reduced configurations equals the reference's array for array, and its
  rank-local form is each rank's block of it.
* ``local_shard`` cuts the blocks ``NamedSharding.devices_indices_map``
  assigns (8 placeholder host devices, in a subprocess) for every
  parameter and server leaf of reduced ``qwen2.5-32b`` and
  ``granite-moe-3b-a800m`` on (2, 4) and (4, 2) meshes; and
  ``DTensor.from_local(local_shard(...), mesh, placements(...))``
  rebuilds the leaf on a gloo group of one, and has the leaf's global
  shape on the production mesh over a fake process group of 256 ranks.
* On that group of one, a (1, 1) mesh: the sharded train step equals the
  single-card step bit for bit (parameters, optimizer and server state,
  losses) over 2 steps of reduced ``internvl2-1b`` and
  ``granite-moe-3b-a800m`` (the expert pin on), one-bit + EF with noise.
  Sequence parallelism is asked for and stays off: one ``model`` rank
  has no slice of the sequence to keep.
"""

import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from rankutil import run_jax, run_python

from repro.configs import ARCHS
from repro.configs import get_config as jax_get_config
from repro.launch import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch import tree as tree_util
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import channel
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, steps
from repro_torch.models import transformer as tr
from repro_torch.optim import make_optimizer

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
ARCH_NAMES = sorted(ARCHS)

FLAVOURS = {
    "packed": dict(),
    "ef": dict(error_feedback=True),
    "adaptive": dict(adaptive_km=True),
    "async": dict(async_agg=True),
    "wireless": dict(sanitize=True, wireless=dict(rho_f=0.5, gmin=0.3)),
    "all": dict(error_feedback=True, adaptive_km=True, async_agg=True,
                sanitize=True, wireless=dict(rho_f=0.5, gmin=0.3)),
}


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), mesh_lib.AbstractMesh(shape, axes)


def _norm(spec):
    return tuple(sharding.entry_axes(e) for e in tuple(spec))


def _jspecs(tree):
    return [_norm(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _tspecs(tree):
    return [_norm(s) for s in sharding.spec_leaves(tree)]


def _oac_pair(kw):
    jkw, tkw = dict(kw), dict(kw)
    if "wireless" in kw:
        from repro.core import channel as jchan
        jkw["wireless"] = jchan.ChannelConfig(**kw["wireless"])
        tkw["wireless"] = channel.ChannelConfig(**kw["wireless"])
    return jsteps.OacServerConfig(**jkw), steps.OacServerConfig(**tkw)


@pytest.fixture(scope="module")
def abstract():
    """(reference abstract params, port meta params) per configuration."""
    return {a: (jsteps.abstract_params(jax_get_config(a)),
                steps.abstract_params(get_config(a))) for a in ARCH_NAMES}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_param_and_opt_specs_equal_the_reference(abstract, mesh_name):
    jm, tm = _meshes(mesh_name)
    for arch in ARCH_NAMES:
        jp, tp = abstract[arch]
        jspec = jsh.param_pspecs(jp, jax_get_config(arch), jm)
        tspec = sharding.param_pspecs(tp, get_config(arch), tm)
        assert _jspecs(jspec) == _tspecs(tspec), arch
        # leaf paths line up with the reference's
        assert len(tree_util.leaves(tp)) == len(jax.tree_util.tree_leaves(jp))
        name = get_config(arch).optimizer
        jo = jax.eval_shape(jax_make_optimizer(name, 1e-3).init, jp)
        to = make_optimizer(name, 1e-3).init(tp)
        assert (_jspecs(jsh.opt_pspecs(jo, jspec))
                == _tspecs(sharding.opt_pspecs(to, tspec))), arch
        for gb in (1, 8, 256, 512):
            for extra, micro in ((1, True), (2, False)):
                assert (_norm(jsh.batch_pspec(gb, jm, extra, micro))
                        == _norm(sharding.batch_pspec(gb, tm, extra,
                                                      micro))), (arch, gb)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_server_specs_layout_and_abstract_state_equal_the_reference(
        abstract, mesh_name):
    jm, tm = _meshes(mesh_name)
    for arch in ARCH_NAMES:
        jp, tp = abstract[arch]
        jspec = jsh.param_pspecs(jp, jax_get_config(arch), jm)
        tspec = sharding.param_pspecs(tp, get_config(arch), tm)
        j_lay = jsteps.server_layout(jp, jspec, jm)
        t_lay = steps.server_layout(tp, tspec, tm)
        assert t_lay.d_packed == j_lay.d_packed, arch
        assert t_lay.d_valid == j_lay.d_valid, arch
        for flavour, kw in FLAVOURS.items():
            joac, toac = _oac_pair(kw)
            flags = dict(packed=True, error_feedback=joac.error_feedback,
                         adaptive_km=joac.adaptive_km,
                         async_agg=joac.async_agg,
                         wireless=joac.wireless is not None)
            assert (_jspecs(jsh.server_pspecs(jspec, jm, **flags))
                    == _tspecs(sharding.server_pspecs(tspec, tm, **flags))
                    ), (arch, flavour)
            j_abs = jsteps.abstract_server_state(jp, jm, jspec, joac)
            t_abs = steps.abstract_server_state(tp, tm, tspec, toac)
            assert sorted(j_abs) == sorted(t_abs), (arch, flavour)
            for key in j_abs:
                assert tuple(t_abs[key].shape) == j_abs[key].shape, key
                assert str(t_abs[key].dtype).split(".")[-1] == \
                    str(j_abs[key].dtype), key
        # the per-leaf flavour mirrors the parameters
        assert (_jspecs(jsh.server_pspecs(jspec, jm))
                == _tspecs(sharding.server_pspecs(tspec, tm)))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("capacity,batch,shard_capacity", [
    (256, 8, False), (256, 1, True), (4096, 32, False), (100, 3, True)])
def test_cache_specs_equal_the_reference(mesh_name, capacity, batch,
                                         shard_capacity):
    jm, tm = _meshes(mesh_name)
    for arch in ARCH_NAMES:
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        jc = jtr.cache_specs(jcfg, batch, capacity)
        tc = tr.cache_specs(tcfg, batch, capacity)
        assert (_jspecs(jsh.cache_pspecs(jc, jcfg, jm, shard_capacity))
                == _tspecs(sharding.cache_pspecs(tc, tcfg, tm,
                                                 shard_capacity))), arch


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "granite-moe-3b-a800m",
                                  "mamba2-370m", "whisper-base"])
@pytest.mark.parametrize("mesh_name", ["2x4", "4x2", "1x1"])
def test_init_server_state_equals_the_reference(arch, mesh_name):
    jm, tm = _meshes(mesh_name)
    jcfg = jax_get_config(arch, reduced_variant=True)
    tcfg = get_config(arch, reduced_variant=True)
    jparams = jtr.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = steps.abstract_params(tcfg)
    for flavour in ("packed", "all"):
        joac, toac = _oac_pair(FLAVOURS[flavour])
        want = jsteps.init_server_state(jparams, mesh=jm, cfg=jcfg, oac=joac)
        got = steps.init_server_state(tparams, tm, tcfg, toac, device="cpu")
        assert sorted(got) == sorted(want)
        for key in want:
            w = np.asarray(want[key])
            g = got[key]
            if key == "fad":
                # the cold start is a fixed draw of each package's own
                # generator, of the global block count
                assert tuple(g.shape) == w.shape
                assert torch.equal(g, channel.init_block_fading(
                    g.shape[0] // 2, "cpu"))
                continue
            if g.dtype == torch.bfloat16:
                g = g.to(torch.float32)
                w = w.astype(np.float32)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=key)
        # the rank-local form is each rank's block of the global buffers
        specs = sharding.server_pspecs(
            sharding.param_pspecs(tparams, tcfg, tm), tm, packed=True,
            error_feedback=toac.error_feedback,
            adaptive_km=toac.adaptive_km, async_agg=toac.async_agg,
            wireless=toac.wireless is not None)
        for coord in ((0, 0), (tm.shape[0] - 1, tm.shape[1] - 1)):
            class At(mesh_lib.AbstractMesh):
                def get_coordinate(self, _c=coord):
                    return _c
            at = At(tm.shape, tm.mesh_dim_names)
            mine = steps.init_server_state(tparams, at, tcfg, toac,
                                           local=True, device="cpu")
            for key in got:
                block = sharding.local_shard(got[key], specs[key], at)
                assert torch.equal(mine[key], block), (key, coord)


def test_local_shard_cuts_the_reference_blocks():
    """``local_shard`` against ``NamedSharding.devices_indices_map`` on 8
    placeholder host devices, for every leaf's spec."""
    out = run_jax(r"""
import dataclasses, json
import jax
from jax.sharding import AxisType, NamedSharding
from repro.configs import get_config
from repro.launch import sharding as jsh, steps as jsteps
res = {}
for arch in ("qwen2.5-32b", "granite-moe-3b-a800m"):
    cfg = get_config(arch, reduced_variant=True)
    pa = jsteps.abstract_params(cfg)
    for shape in ((2, 4), (4, 2)):
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        specs = jsh.param_pspecs(pa, cfg, mesh)
        srv = jsh.server_pspecs(specs, mesh, packed=True)
        leaves = jax.tree_util.tree_leaves(pa) + [
            jax.ShapeDtypeStruct((8 * 1024,), "float32")]
        sl = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        ) + [srv["g"]]
        blocks = []
        for leaf, spec in zip(leaves, sl):
            idx = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
            per = []
            for r in range(8):
                dev = mesh.devices[r // shape[1], r % shape[1]]
                per.append([[s.start or 0, s.stop if s.stop is not None
                             else n] for s, n in zip(idx[dev], leaf.shape)])
            blocks.append({"shape": list(leaf.shape), "blocks": per})
        res[f"{arch}/{shape[0]}x{shape[1]}"] = blocks
print(json.dumps(res))
""")
    res = json.loads(out.strip().splitlines()[-1])
    for key, blocks in res.items():
        arch, mesh_name = key.split("/")
        cfg = get_config(arch, reduced_variant=True)
        shape = tuple(int(x) for x in mesh_name.split("x"))
        tm = mesh_lib.AbstractMesh(shape, ("data", "model"))
        pa = steps.abstract_params(cfg)
        specs = sharding.spec_leaves(sharding.param_pspecs(pa, cfg, tm)) + [
            sharding.server_pspecs(None, tm, packed=True)["g"]]
        assert len(specs) == len(blocks)
        for spec, blk in zip(specs, blocks):
            for r, want in enumerate(blk["blocks"]):
                coord = (r // shape[1], r % shape[1])
                got = sharding.local_slices(blk["shape"], spec, tm, coord)
                got = [[s.start or 0, s.stop if s.stop is not None else n]
                       for s, n in zip(got, blk["shape"])]
                assert got == want, (key, spec, r)


@pytest.fixture(scope="module")
def group_of_one(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield mesh_lib.make_mesh((1, 1), ("data", "model"),
                                 device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_dtensor_round_trip_on_a_group_of_one(group_of_one):
    from torch.distributed.tensor import DTensor
    mesh = group_of_one
    cfg = get_config("granite-moe-3b-a800m", reduced_variant=True)
    params = tr.init_lm_seeded(cfg, 3, "cpu")
    specs = sharding.param_pspecs(params, cfg, mesh)
    for (path, leaf), spec in zip(tree_util.leaves(params),
                                  sharding.spec_leaves(specs)):
        local = sharding.local_shard(leaf, spec, mesh)
        full = DTensor.from_local(local, mesh, sharding.placements(spec,
                                                                   mesh),
                                  run_check=False).full_tensor()
        assert torch.equal(full, leaf), path
    # a world of one holds every leaf whole
    local = sharding.local_tree(params, specs, mesh)
    for (_, a), (_, b) in zip(tree_util.leaves(local),
                              tree_util.leaves(params)):
        assert torch.equal(a, b)


def test_dtensor_shapes_on_the_fake_production_mesh():
    """On 256 fake ranks a rank's block under ``placements`` has the
    leaf's global shape as a DTensor (no data moves on a fake group)."""
    out = run_python(r"""
import json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import DTensor
from repro_torch import tree as tree_util
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_lib, sharding, steps
dist.init_process_group("fake", store=FakeStore(), rank=37, world_size=256)
mesh = mesh_lib.make_production_mesh(device_type="cpu")
res = []
for arch in ("granite-moe-3b-a800m", "mamba2-370m", "qwen2.5-32b"):
    cfg = get_config(arch, reduced_variant=True)
    pa = steps.abstract_params(cfg)
    specs = sharding.param_pspecs(pa, cfg, mesh)
    for (path, leaf), spec in zip(tree_util.leaves(pa),
                                  sharding.spec_leaves(specs)):
        local = torch.zeros(sharding.local_shape(leaf.shape, spec, mesh))
        dt = DTensor.from_local(local, mesh, sharding.placements(spec, mesh),
                                run_check=False)
        res.append([list(dt.shape), list(leaf.shape),
                    list(sharding.local_slices(leaf.shape, spec, mesh)[0]
                         .indices(leaf.shape[0]))])
print(json.dumps(res))
""")
    res = json.loads(out.strip().splitlines()[-1])
    assert res
    for got, want, _ in res:
        assert got == want


@pytest.mark.parametrize("arch", ["internvl2-1b", "granite-moe-3b-a800m"])
def test_one_by_one_mesh_equals_the_single_card_step(group_of_one, arch):
    mesh = group_of_one
    cfg = get_config(arch, reduced_variant=True)
    shape = InputShape("t", 48, 4, "train")
    oac = steps.OacServerConfig(one_bit=True, error_feedback=True,
                                noise_std=0.5)
    single = steps.make_train_step(cfg, shape, n_micro=2, oac=oac,
                                   device="cpu")
    sharded = steps.make_train_step(cfg, shape, mesh, n_micro=2, oac=oac,
                                    device="cpu")
    # one model rank: the residual has no slice of the sequence to keep
    assert not sharded.meta["sequence_parallel"]
    assert sharded.meta["expert_shard_axis"] == (
        "model" if cfg.n_experts else "")
    states = []
    for bundle in (single, sharded):
        params = tr.init_lm_seeded(cfg, 0, "cpu")
        opt_state = make_optimizer(cfg.optimizer, 1e-3).init(params)
        if bundle is single:
            server = steps.init_server_state(params, oac=oac)
        else:
            server = steps.init_server_state(
                steps.abstract_params(cfg), mesh, cfg, oac, local=True,
                device="cpu")
        states.append((params, opt_state, server, []))
    s_text = 48 - cfg.n_patches
    gen = torch.Generator().manual_seed(0)
    for t in range(2):
        batch = {k: torch.randint(0, cfg.vocab, (2, 2, s_text), generator=gen,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        if cfg.family == "vlm":
            batch["embeds"] = 0.02 * torch.randn(2, 2, cfg.n_patches,
                                                 cfg.d_model, generator=gen)
        for bundle, (params, opt_state, server, losses) in zip(
                (single, sharded), states):
            *_, loss = bundle.fn(params, opt_state, server, batch, t)
            losses.append(loss)
    (p1, o1, s1, l1), (p2, o2, s2, l2) = states
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    for tree_a, tree_b in ((p1, p2), (o1, o2), (s1, s2)):
        for (path, a), (_, b) in zip(tree_util.leaves(tree_a),
                                     tree_util.leaves(tree_b)):
            assert torch.equal(a, b), path
