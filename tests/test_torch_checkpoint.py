"""Checkpoints across the two packages: files written by
``repro.checkpoint`` restored by ``repro_torch.checkpoint`` and the
reverse, bit for bit — trees with bf16, lists, tuples, ``None`` and
scalars, and the launch path's packed server state with its layout
record; CRC corruption raises ``CorruptCheckpointError`` on both sides;
``migrate_server_state``; the layout codec (``layout_to_meta`` /
``layout_matches``) and the threshold-state codec of
``core.packing``."""

import dataclasses
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import to_np

from repro import checkpoint as jck
from repro.configs import get_config as jax_get_config
from repro.core import packing as jpacking
from repro.models import transformer as jtr
from repro_torch import checkpoint as ck
from repro_torch import tree as tree_util
from repro_torch.configs import get_config
from repro_torch.core import packing
from repro_torch.launch import steps
from repro_torch.models import transformer

ARCH = "internvl2-1b"


def _words(x):
    """A bf16 array's (or tensor's) raw 16-bit words."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _jax_tree():
    rng = np.random.default_rng(0)
    return {"w": jnp.asarray(rng.normal(size=(3, 5)).astype(np.float32)),
            "g": jnp.asarray(rng.normal(size=7), jnp.bfloat16),
            "blocks": [{"a": jnp.arange(4, dtype=jnp.int8)},
                       {"a": jnp.int32(-3)}],
            "pair": (jnp.ones(2), None), "none": None, "step": jnp.int32(9),
            "lr": 1.5e-3}


def _check_against(t_tree, j_tree):
    """The port's restored tree against the reference's values."""
    assert t_tree["none"] is None and t_tree["pair"][1] is None
    assert isinstance(t_tree["pair"], tuple)
    assert isinstance(t_tree["blocks"], list)
    assert t_tree["g"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_words(t_tree["g"]), _words(j_tree["g"]))
    np.testing.assert_array_equal(
        to_np(t_tree["w"]).view(np.int32),
        np.asarray(j_tree["w"]).view(np.int32))
    assert t_tree["blocks"][0]["a"].dtype == torch.int8
    assert int(t_tree["blocks"][1]["a"]) == -3
    assert t_tree["step"].dtype == torch.int32 and int(t_tree["step"]) == 9
    assert float(t_tree["lr"]) == 1.5e-3


def test_trees_cross_both_ways(tmp_path):
    j_tree = _jax_tree()
    path = jck.save(str(tmp_path / "j"), j_tree, step=3)
    assert path.endswith("step_00000003.npz")
    _check_against(ck.restore(path, like=j_tree, device="cpu"), j_tree)

    t_tree = ck.restore(path, like=j_tree, device="cpu")
    t_path = ck.save(str(tmp_path / "t"), t_tree, step=3)
    back = jck.restore(t_path, like=j_tree)
    want = jck.restore(path, like=j_tree)
    assert back["none"] is None and isinstance(back["pair"], tuple)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # the same keys in both files
    assert sorted(np.load(t_path).files) == sorted(np.load(path).files)
    assert ck.latest_step(str(tmp_path / "t")) == 3 == jck.latest_step(
        str(tmp_path / "j"))
    assert ck.latest_step(str(tmp_path / "missing")) is None


def _layouts():
    jcfg = jax_get_config(ARCH, reduced_variant=True)
    jabs = jax.eval_shape(lambda k: jtr.init_lm(k, jcfg),
                          jax.random.PRNGKey(0))
    tl = packing.PackedLayout.from_tree(
        transformer.init_lm(None, get_config(ARCH, reduced_variant=True)))
    return jpacking.PackedLayout.from_tree(jabs), tl


def test_layout_codec_matches_the_reference():
    jl, tl = _layouts()
    assert packing.layout_to_meta(tl) == jpacking.layout_to_meta(jl)
    meta = json.loads(json.dumps(jpacking.layout_to_meta(jl)))
    assert packing.layout_matches(tl, meta)
    for bad in ({"lane": 128}, {"d_packed": meta["d_packed"] + 256}):
        assert not packing.layout_matches(tl, dict(meta, **bad))
    wrong = json.loads(json.dumps(meta))
    wrong["entries"][3][3] = [1, 2]
    assert not packing.layout_matches(tl, wrong)
    assert not packing.layout_matches(
        packing.PackedLayout.from_tree({"w": torch.zeros(5)}), meta)


def test_threshold_state_codec():
    rng = np.random.default_rng(1)
    vec = rng.random(packing.THRESHOLD_STATE_SIZE).astype(np.float32)
    assert packing.THRESHOLD_STATE_SIZE == jpacking.THRESHOLD_STATE_SIZE
    assert packing.THRESHOLD_STATE_FIELDS == jpacking.THRESHOLD_STATE_FIELDS
    ts = packing.threshold_state_from_vec(torch.from_numpy(vec))
    js = jpacking.threshold_state_from_vec(jnp.asarray(vec))
    for key in js:
        np.testing.assert_array_equal(to_np(ts[key]), np.asarray(js[key]))
    np.testing.assert_array_equal(to_np(packing.threshold_state_to_vec(ts)),
                                  vec)
    legacy = packing.threshold_state_from_vec(torch.from_numpy(vec[:6]))
    assert not bool(legacy["mag_hist"].any())
    assert legacy["age_hist"].shape == (packing.STATS_AGE_BINS,)


def _server(seed, d):
    rng = np.random.default_rng(seed)
    return {"g": jnp.asarray(rng.normal(size=d), jnp.bfloat16),
            "age": jnp.asarray(rng.integers(-1, 120, d), jnp.int8),
            "res": jnp.asarray(rng.normal(size=d).astype(np.float32)),
            "theta": jnp.asarray(rng.random(262).astype(np.float32)),
            "pending": jnp.asarray(rng.normal(size=d), jnp.bfloat16),
            "fad": jnp.asarray(rng.normal(size=40).astype(np.float32))}


def _server_equal(t_srv, j_srv):
    assert set(t_srv) == set(j_srv)
    for key, j in j_srv.items():
        t = t_srv[key]
        if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_words(t), _words(j))
        else:
            t = to_np(t) if isinstance(t, torch.Tensor) else np.asarray(t)
            j = np.asarray(j)
            assert t.dtype == j.dtype and t.tobytes() == j.tobytes(), key


def test_server_state_crosses_both_ways(tmp_path):
    jl, tl = _layouts()
    j_srv = _server(2, jl.d_packed)
    j_path = jck.save_server_state(str(tmp_path / "j"), j_srv, layout=jl,
                                   step=5)
    t_srv, meta = ck.restore_server_state(j_path, layout=tl, device="cpu")
    _server_equal(t_srv, j_srv)
    assert meta == jpacking.layout_to_meta(jl)
    t_path = ck.save_server_state(str(tmp_path / "t"), t_srv, layout=tl,
                                  step=5)
    back, meta2 = jck.restore_server_state(t_path, layout=jl)
    _server_equal(t_srv, back)
    assert meta2 == meta
    assert ck.server_steps(str(tmp_path / "t")) == [5]
    assert ck.latest_server_step(str(tmp_path / "t")) == 5
    # another model's layout is refused on both sides
    other = packing.PackedLayout.from_tree({"w": torch.zeros(9)})
    with pytest.raises(ValueError, match="different"):
        ck.restore_server_state(j_path, layout=other, device="cpu")
    no_meta = ck.save_server_state(str(tmp_path / "n.npz"), t_srv)
    with pytest.raises(ValueError, match="without layout"):
        ck.restore_server_state(no_meta, layout=tl, device="cpu")


def test_corruption_raises_on_both_sides(tmp_path):
    """Bytes that change under their recorded CRC32 raise
    ``CorruptCheckpointError`` in both packages (a file rewritten with its
    old checksums); bytes flipped inside the zip are caught by the zip's
    own CRC first (``BadZipFile``, which the launcher's walk-back also
    takes as corruption)."""
    jl, tl = _layouts()
    t_srv = steps.state_from_numpy(
        jax.tree.map(np.asarray, _server(3, tl.d_packed)), "cpu")
    path = ck.save_server_state(str(tmp_path), t_srv, layout=tl, step=1)
    data = dict(np.load(path))
    data["res"] = data["res"].copy()
    data["res"][17] += 1.0
    rotted = str(tmp_path / "rotted.npz")
    np.savez(rotted, **data)
    with pytest.raises(ck.CorruptCheckpointError, match="checksum"):
        ck.restore_server_state(rotted, device="cpu")
    with pytest.raises(jck.CorruptCheckpointError):
        jck.restore_server_state(rotted)
    del data["res"]
    np.savez(rotted, **dict(data, extra=np.zeros(3)))
    with pytest.raises(ck.CorruptCheckpointError, match="no recorded"):
        ck.restore_server_state(rotted, device="cpu")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 4)
        f.write(b"\x5a" * 32)
    with pytest.raises(zipfile.BadZipFile):
        ck.restore_server_state(path, device="cpu")
    assert issubclass(ck.CorruptCheckpointError, ValueError)


def test_migrate_server_state():
    lay = packing.PackedLayout.from_tree({"w": torch.zeros(3, 100)})
    from repro_torch.core import channel
    oac = steps.OacServerConfig(async_agg=True, sanitize=True,
                                wireless=channel.ChannelConfig())
    like = steps.init_server_state({"w": torch.zeros(3, 100)}, oac=oac)
    sync = {k: v for k, v in like.items()
            if k not in ("shadow", "pending", "fad")}
    out = ck.migrate_server_state(sync, like)
    assert set(out) == set(like)
    for key in ("shadow", "pending"):
        assert out[key].dtype == torch.bfloat16 and not bool(out[key].any())
    assert torch.equal(out["fad"], like["fad"])
    assert out["fad"].shape == (2 * channel.n_blocks(lay.d_packed,
                                                     oac.wireless),)
    with pytest.raises(ValueError) as t_err:
        ck.migrate_server_state(like, sync)
    with pytest.raises(ValueError) as j_err:
        jck.migrate_server_state({k: to_np(v.float()) for k, v in
                                  like.items()},
                                 {k: to_np(v.float()) for k, v in
                                  sync.items()})
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="missing: \\['res'\\]"):
        ck.migrate_server_state(sync, dict(sync, res=torch.zeros(3)))


def test_launch_state_round_trips(tmp_path):
    """A port step's params/opt tree and its packed server state come back
    bit for bit (the launcher's checkpoint pair)."""
    cfg = get_config(ARCH, reduced_variant=True)
    params = transformer.init_lm_seeded(cfg, 0, "cpu")
    from repro_torch.optim import make_optimizer
    opt = make_optimizer("sgd", 1e-3)
    state = {"params": params, "opt": opt.init(params)}
    path = ck.save(str(tmp_path), state, step=1)
    back = ck.restore(path, like=state, device="cpu")
    assert back["opt"]["mu"] is None
    for (pa, a), (pb, b) in zip(tree_util.leaves(state),
                                tree_util.leaves(back)):
        assert pa == pb and torch.equal(a, b)
    srv = steps.init_server_state(params)
    lay = steps.server_layout(params)
    srv_back, _ = ck.restore_server_state(
        ck.save_server_state(str(tmp_path), srv, layout=lay, step=1),
        layout=lay, device="cpu")
    for key in srv:
        assert srv_back[key].dtype == srv[key].dtype
        assert torch.equal(srv_back[key], srv[key])


ALL_ARCHS = ("internvl2-1b", "qwen2.5-32b", "granite-34b", "deepseek-67b",
             "mistral-large-123b", "granite-moe-3b-a800m", "arctic-480b",
             "mamba2-370m", "jamba-1.5-large-398b", "whisper-base")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_layout_of_every_configuration_matches_the_reference(arch):
    """The packed layout of each reduced configuration's tree (MoE
    stacks, float32 Mamba leaves inside bf16 trees, the encoder) has the
    reference's block table."""
    jabs = jax.eval_shape(
        lambda k: jtr.init_lm(k, jax_get_config(arch, reduced_variant=True)),
        jax.random.PRNGKey(0))
    tl = packing.PackedLayout.from_tree(
        transformer.init_lm(None, get_config(arch, reduced_variant=True)))
    assert packing.layout_to_meta(tl) == jpacking.layout_to_meta(
        jpacking.PackedLayout.from_tree(jabs))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-370m",
                                  "whisper-base", "jamba-1.5-large-398b"])
def test_reference_checkpoint_of_every_family_restores(arch, tmp_path):
    """Parameters, optimizer state and the packed server state saved by
    the reference for a reduced MoE, Mamba, encoder-decoder and hybrid
    model restore in the port bit for bit (bf16 trees with float32
    routers and Mamba leaves included), and the port's restored
    parameters carry the reference's loss."""
    from repro.launch import steps as jsteps
    from repro.optim import make_optimizer as jax_make_optimizer
    jcfg = jax_get_config(arch, reduced_variant=True)
    cfg = get_config(arch, reduced_variant=True)
    params = jtr.init_lm(jax.random.PRNGKey(3), jcfg)
    opt = jax_make_optimizer(jcfg.optimizer, 1e-3).init(params)
    jl = jpacking.PackedLayout.from_tree(params)
    rng = np.random.default_rng(4)
    server = {"g": jnp.asarray(rng.normal(size=jl.d_packed), jnp.bfloat16),
              "age": jnp.asarray(rng.integers(-1, 100, jl.d_packed),
                                 jnp.int8),
              "theta": jnp.asarray(rng.random(262).astype(np.float32))}
    state = {"params": params, "opt": opt}
    path = jck.save(str(tmp_path), state, step=7)
    srv_path = jck.save_server_state(str(tmp_path), server, layout=jl,
                                     step=7)
    like = {"params": transformer.init_lm(None, cfg),
            "opt": jax.tree.map(np.asarray, opt)}
    back = ck.restore(path, like=like, device="cpu")
    for (tpath, t), (jpath, j) in zip(
            tree_util.leaves(back), jax.tree_util.tree_leaves_with_path(
                state)):
        assert str(t.dtype) == "torch." + str(np.asarray(j).dtype), tpath
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_words(t), _words(j))
        else:
            assert to_np(t).tobytes() == np.asarray(j).tobytes(), tpath
    tl = steps.server_layout(back["params"])
    srv, _ = ck.restore_server_state(srv_path, layout=tl, device="cpu")
    _server_equal(srv, server)
    toks, labels = (np.arange(16, dtype=np.int32).reshape(2, 8) % cfg.vocab,
                    np.ones((2, 8), np.int32))
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "audio":
        batch["frames"] = (rng.normal(size=(2, cfg.encoder_seq, cfg.d_model))
                           * 0.1).astype(np.float32)
    f32 = dict(compute_dtype="float32")
    want, _ = jtr.loss_fn(params, dataclasses.replace(jcfg, **f32),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = transformer.loss_fn(back["params"],
                                 dataclasses.replace(cfg, **f32),
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
