"""The port's multi-leaf packed layout against the JAX package's: the block
table of nested trees (float32 and bfloat16 leaves, a leaf that ends on a
lane boundary, scalars), and ``pack``, ``pack_age``, ``unpack``,
``valid_mask``, ``init_age`` and ``sample_ids`` bit for bit.  The
structural counters ``PACK_CALLS`` / ``UNPACK_CALLS`` count one per call.

Tolerances: none — every output is compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import to_np

from repro.core import packing as jax_packing
from repro_torch.core import packing
from repro_torch.models.cnn import params_from_numpy

CPU = "cpu"


def _np_tree(seed: int):
    """Nested float32 numpy tree: unsorted keys, a lane-aligned leaf (256),
    a multi-lane one (2 x 256), ragged ones and a scalar."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"zeta": arr(3, 5), "alpha": {"w": arr(16, 16), "b": arr(7)},
            "mid": {"k": arr(2, 256), "s": np.float32(rng.standard_normal()),
                    "n": arr(300)},
            "emb": arr(40, 8)}


BF16 = ("alpha", "b"), ("mid", "n")


def _trees(seed):
    """The same tree as JAX and torch, the leaves of ``BF16`` in bfloat16
    (converted from the same float32 values on both sides)."""
    np_tree = _np_tree(seed)
    jtree = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else jnp.asarray(v))
             for k, v in np_tree.items()}
    ttree = params_from_numpy(np_tree)
    for a, b in BF16:
        jtree[a][b] = jtree[a][b].astype(jnp.bfloat16)
        ttree[a][b] = ttree[a][b].to(torch.bfloat16)
    return jtree, ttree


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("lane", [256, 128, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_block_table_matches_jax(lane, seed):
    jtree, ttree = _trees(seed)
    jl = jax_packing.PackedLayout.from_tree(jtree, lane=lane)
    tl = packing.PackedLayout.from_tree(ttree, lane=lane)
    assert (tl.d_packed, tl.d_valid, tl.n_leaves, tl.lane) == (
        jl.d_packed, jl.d_valid, jl.n_leaves, jl.lane)
    for je, te in zip(jl.table, tl.table):
        assert (te.index, te.offset, te.size, te.pad, te.shape) == (
            je.index, je.offset, je.size, je.pad, je.shape)
        assert _dtype_name(te.dtype) == str(je.dtype)
    # the meta form of the same tree gives the same table
    meta = packing.PackedLayout.from_tree(
        {k: ({kk: torch.empty(tuple(np.shape(vv)), device="meta")
              for kk, vv in v.items()} if isinstance(v, dict)
             else torch.empty(v.shape, device="meta"))
         for k, v in ttree.items()}, lane=lane)
    assert [(e.offset, e.size, e.pad) for e in meta.table] == [
        (e.offset, e.size, e.pad) for e in tl.table]


def test_lane_boundary_leaf_has_no_pad():
    """As ``tests/test_packing.py``: a leaf of exactly lane·k coordinates
    gets pad 0 (the off-by-one guard of the block table)."""
    tree = {"a": torch.zeros(256), "b": torch.zeros(512),
            "c": torch.zeros(100)}
    lay = packing.PackedLayout.from_tree(tree)
    assert [e.pad for e in lay.table] == [0, 0, 156]
    assert lay.d_packed == 256 + 512 + 256
    jl = jax_packing.PackedLayout.from_tree(
        [jnp.zeros((256,)), jnp.zeros((512,)), jnp.zeros((100,))])
    assert [e.pad for e in jl.table] == [e.pad for e in lay.table]


@pytest.mark.parametrize("seed", [0, 3])
def test_pack_unpack_and_pad_bookkeeping_match_jax(seed):
    jtree, ttree = _trees(seed)
    jl = jax_packing.PackedLayout.from_tree(jtree)
    tl = packing.PackedLayout.from_tree(ttree)
    rng = np.random.default_rng(seed + 10)
    age_np = {k: ({kk: rng.integers(0, 40, np.shape(vv)).astype(np.float32)
                   for kk, vv in v.items()} if isinstance(v, dict)
                  else rng.integers(0, 40, np.shape(v)).astype(np.float32))
              for k, v in _np_tree(seed).items()}
    j_age = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else jnp.asarray(v))
             for k, v in age_np.items()}
    t_age = params_from_numpy(age_np)
    p0, u0 = packing.PACK_CALLS, packing.UNPACK_CALLS
    t_g = tl.pack(ttree)
    t_a = tl.pack_age(t_age)
    assert (packing.PACK_CALLS - p0, packing.UNPACK_CALLS - u0) == (2, 0)
    j_g = np.asarray(jl.pack(jtree))
    j_a = np.asarray(jl.pack_age(j_age))
    assert t_g.dtype == torch.float32 and t_g.shape == (tl.d_packed,)
    np.testing.assert_array_equal(to_np(t_g).view(np.int32),
                                  j_g.view(np.int32))
    np.testing.assert_array_equal(to_np(t_a), j_a)
    np.testing.assert_array_equal(
        to_np(tl.pack(ttree, dtype=torch.bfloat16).to(torch.float32)),
        np.asarray(jl.pack(jtree, dtype=jnp.bfloat16).astype(jnp.float32)))
    # unpack: views in float32, or cast back to each leaf's dtype
    out = tl.unpack(t_g, cast=False)
    back = tl.unpack(t_g)
    assert packing.UNPACK_CALLS - u0 == 2
    j_back = jl.unpack(jnp.asarray(j_g))
    for path, leaf in (((k,), v) for k, v in ttree.items()
                       if not isinstance(v, dict)):
        assert out[path[0]].dtype == torch.float32
        np.testing.assert_array_equal(to_np(back[path[0]]),
                                      np.asarray(j_back[path[0]]))
    for a, b in BF16:
        assert back[a][b].dtype == torch.bfloat16
        assert out[a][b].dtype == torch.float32
        assert torch.equal(back[a][b], ttree[a][b])
        np.testing.assert_array_equal(
            to_np(back[a][b].to(torch.float32)),
            np.asarray(j_back[a][b].astype(jnp.float32)))
    assert out["mid"]["s"].shape == () and float(out["mid"]["s"]) == float(
        ttree["mid"]["s"])
    assert out["alpha"]["w"].data_ptr() == t_g[
        tl.table[1].offset:].data_ptr()          # a view, not a copy
    np.testing.assert_array_equal(to_np(tl.valid_mask(CPU)),
                                  np.asarray(jl.valid_mask()))
    np.testing.assert_array_equal(to_np(tl.init_age(device=CPU)),
                                  np.asarray(jl.init_age()))
    assert tl.init_age(device=CPU).dtype == torch.int8
    np.testing.assert_array_equal(
        to_np(tl.init_age(torch.float32, CPU)),
        np.asarray(jl.init_age(jnp.float32)))
    for cap in (1, 7, 64, 500, 10_000):
        ids = tl.sample_ids(cap, CPU)
        assert ids.dtype == torch.int64
        np.testing.assert_array_equal(to_np(ids), jl.sample_ids(cap))
        assert to_np(tl.valid_mask(CPU))[to_np(ids)].all()


def test_one_leaf_layout_is_the_flat_vector():
    """The trainer's layout: one leaf, lane 1 — no pads, ``pack`` is the
    vector itself and the sample is the plain strided sample."""
    x = torch.arange(1000, dtype=torch.float32)
    lay = packing.PackedLayout.from_tree(torch.empty(1000, device="meta"),
                                         lane=1)
    assert (lay.d_packed, lay.d_valid, lay.n_leaves) == (1000, 1000, 1)
    assert torch.equal(lay.pack(x), x)
    assert torch.equal(lay.unpack(x), x)
    assert torch.equal(lay.sample_ids(64, CPU), torch.arange(0, 1000, 15))


def test_pack_rejects_another_tree():
    lay = packing.PackedLayout.from_tree({"a": torch.zeros(3),
                                          "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaves"):
        lay.pack({"a": torch.zeros(3)})


# --- trees with lists, tuples and None (the transformer and optimizer) -----

def test_tree_flattens_lists_tuples_and_none_as_jax():
    """``repro_torch.tree`` flattens sequences by position and skips
    ``None`` as ``jax.tree_util`` does; ``unflatten`` rebuilds lists and
    tuples (a list position without a leaf comes back as ``None``) and
    ``tree_map`` keeps every ``None``."""
    import jax
    from repro_torch import tree as tree_util
    tree = {"b": [{"y": 1, "x": 2}, (3, None, 4)], "a": None, "c": 5,
            "d": [None, 6]}
    got = tree_util.leaves(tree)
    assert [v for _, v in got] == jax.tree_util.tree_leaves(tree)
    assert [p for p, _ in got] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jax.tree_util.tree_leaves_with_path(tree)]
    back = tree_util.unflatten([p for p, _ in got], [v for _, v in got])
    assert back == {"b": [{"x": 2, "y": 1}, (3, None, 4)], "c": 5,
                    "d": [None, 6]}
    assert isinstance(back["b"][1], tuple)
    mapped = tree_util.tree_map(lambda v: v * 10, tree)
    assert mapped["a"] is None and mapped["b"][1] == (30, None, 40)
    assert tree_util.leaves(torch.zeros(2))[0][0] == ()
    assert tree_util.leaves(None) == []


@pytest.mark.parametrize("arch", ["internvl2-1b", "granite-34b"])
def test_transformer_layout_matches_jax(arch):
    """``PackedLayout.from_tree`` on the reference's transformer tree
    (``jax.eval_shape`` of ``init_lm``) and on the port's (its ``meta``
    tree): the same offsets, sizes, pads, shapes and dtypes; pack and
    unpack on it, with the ``blocks`` list rebuilt."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as jtr
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    jabs = jax.eval_shape(
        lambda k: jtr.init_lm(k, jax_get_config(arch, reduced_variant=True)),
        jax.random.PRNGKey(0))
    jl = jax_packing.PackedLayout.from_tree(jabs)
    cfg = get_config(arch, reduced_variant=True)
    tl = packing.PackedLayout.from_tree(transformer.init_lm(None, cfg))
    assert (tl.d_packed, tl.d_valid, tl.n_leaves) == (
        jl.d_packed, jl.d_valid, jl.n_leaves)
    for te, je in zip(tl.table, jl.table):
        assert (te.index, te.offset, te.size, te.pad, te.shape) == (
            je.index, je.offset, je.size, je.pad, tuple(je.shape))
        assert str(te.dtype) == "torch." + str(np.dtype(je.dtype))
    params = transformer.init_lm_seeded(cfg, 0, CPU)
    flat = tl.pack(params)
    back = tl.unpack(flat)
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == 1
    for (pa, a), (pb, b) in zip(tree_util.leaves(params),
                                tree_util.leaves(back)):
        assert pa == pb and torch.equal(a, b)
    pads = ~to_np(tl.valid_mask(CPU))
    assert (to_np(flat)[pads] == 0.0).all()
    assert (to_np(tl.init_age(device=CPU))[pads] == packing.PAD_AGE).all()
