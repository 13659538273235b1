"""Partition specs for parameters, optimizer state, server state, caches
and batches (``repro.launch.sharding``), and the blocks they describe.

Scheme: 2-D "FSDP x TP" —
  * the TP dimension of every matmul weight lives on the ``model`` axis
    (attention heads / FFN hidden / experts / SSM heads / vocab),
  * the complementary major dimension is sharded across the data-parallel
    axes (``data``, plus ``pod`` when multi-pod),
  * dims that do not divide the axis size are replicated.

A spec (``P``) is a tuple with one entry per dimension: ``None``
(replicated), an axis name, or a tuple of axis names (the dimension split
over those axes in row-major order).  A spec shorter than the tensor
replicates the trailing dimensions; ``P()`` replicates everything.

Everything is derived from the parameter tree's paths
(``repro_torch.tree``: ``"blocks/0/mixer/wq/w"``), by the reference's
rules, and reads only the mesh's axis names and sizes — any object with
``mesh_dim_names`` and ``shape`` will do (``launch.mesh.AbstractMesh``,
or a mesh on a fake process group), so the production meshes' specs need
no ranks.  ``local_shard`` cuts a rank's block out of a global tensor
(the block ``shard_map`` hands that rank), ``local_shape`` gives its
shape, and ``placements`` the same layout as DTensor placements.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import axis_names, axis_size
from repro_torch.launch.mesh import batch_axes, fsdp_axes

Tensor = torch.Tensor


class P(tuple):
    """A partition spec: ``P(entry, ...)``, one entry per dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _size(mesh, axis: str) -> int:
    return axis_size(mesh, (axis,))


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def path_str(path) -> str:
    """``"blocks/0/mixer/wq/w"``: the reference's ``_path_str``."""
    return "/".join(str(e) for e in path)


def entry_axes(entry) -> Tuple[str, ...]:
    """The axes of one spec entry (``()`` for ``None``)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _tree_map_with_path(fn, tree):
    pairs = tree_util.leaves(tree)
    return tree_util.unflatten([p for p, _ in pairs],
                               [fn(p, x) for p, x in pairs])


def param_pspecs(params: Any, cfg: ModelConfig, mesh) -> Any:
    """The spec tree matching ``init_lm``'s parameters."""
    fsdp = fsdp_axes(mesh)
    fsdp_n = axis_size(mesh, fsdp)
    model_n = _size(mesh, "model")

    def spec_for(path, leaf) -> P:
        s = path_str(path)
        shape = tuple(leaf.shape)
        ndim = len(shape)
        stacked = s.startswith("blocks") or s.startswith("enc_blocks")
        lead = (None,) if stacked else ()
        body = shape[1:] if stacked else shape

        def mk(*entries):
            return P(*(lead + entries))

        if s == "embed":
            v, d = shape
            return P("model" if _div(v, model_n) else None,
                     fsdp if _div(d, fsdp_n) else None)
        if s.startswith("head"):
            if ndim == 2:
                d, v = shape
                return P(fsdp if _div(d, fsdp_n) else None,
                         "model" if _div(v, model_n) else None)
            return P()
        if "norm" in s or ndim <= (2 if stacked else 1):
            if "conv_x_b" in s or any(t in s for t in ("a_log", "d_skip",
                                                       "dt_bias")):
                h = body[-1]
                return mk(*([None] * (len(body) - 1)),
                          "model" if _div(h, model_n) else None)
            return P()
        if "/ffn/" in s and ndim == 4 and "router" not in s:
            e, d1, d2 = body
            if _div(e, model_n):
                return mk("model", fsdp if _div(d1, fsdp_n) else None, None)
            if s.endswith("wd/w"):
                return mk(None, "model" if _div(d1, model_n) else None,
                          fsdp if _div(d2, fsdp_n) else None)
            return mk(None, fsdp if _div(d1, fsdp_n) else None,
                      "model" if _div(d2, model_n) else None)
        if "router" in s:
            return mk(fsdp if _div(body[0], fsdp_n) else None, None)
        if any(t in s for t in ("wk/w", "wv/w", "wbc/w")):
            d_in, _ = body
            return mk(fsdp if _div(d_in, fsdp_n) else None, None)
        if any(t in s for t in ("wq/w", "wg/w", "wu/w", "wz/w", "wx/w",
                                "wdt/w")):
            d_in, d_out = body
            return mk(fsdp if _div(d_in, fsdp_n) else None,
                      "model" if _div(d_out, model_n) else None)
        if any(t in s for t in ("wo/w", "wd/w", "out_proj/w")):
            d_in, d_out = body
            return mk("model" if _div(d_in, model_n) else None,
                      fsdp if _div(d_out, fsdp_n) else None)
        if "conv_x_w" in s:
            return mk(None, "model" if _div(body[-1], model_n) else None)
        if "conv_bc_w" in s:
            return mk(None, None)
        return P()

    return _tree_map_with_path(spec_for, params)


def opt_pspecs(opt_state: Any, p_specs: Any) -> Any:
    """Optimizer-state specs: the moment trees mirror the parameters'."""
    out = {}
    for key, val in opt_state.items():
        if key == "step" or val is None:
            out[key] = P() if val is not None else None
        else:
            out[key] = p_specs
    return out


def server_pspecs(p_specs: Any, mesh=None, packed: bool = False,
                  error_feedback: bool = False, adaptive_km: bool = False,
                  async_agg: bool = False, wireless: bool = False) -> Any:
    """The server state's specs.  Packed: every flat buffer split across
    ALL mesh axes (each rank owns its ``d_packed`` slice), ``theta`` and
    ``ctrl`` replicated.  Per leaf: ``g`` and ``age`` mirror the
    parameters."""
    if packed:
        vec = P(tuple(axis_names(mesh)))
        out = {"g": vec, "age": vec, "theta": P()}
        if error_feedback:
            out["res"] = vec
        if adaptive_km:
            out["ctrl"] = P()
        if async_agg:
            out["shadow"] = vec
            out["pending"] = vec
        if wireless:
            out["fad"] = vec
        return out
    return {"g": p_specs, "age": p_specs, "theta": P()}


def cache_pspecs(caches: Any, cfg: ModelConfig, mesh,
                 shard_capacity: bool = False) -> Any:
    """KV / SSM cache specs; every leaf leads with the scan-block dim.
    Attention k/v (n_blocks, B, L, KV, hd): batch on the batch axes,
    capacity on ``model`` (and on ``data`` too with ``shard_capacity``
    when the batch does not divide).  SSM state: heads on ``model``; the
    conv carries: channels on ``model`` (``conv_x``)."""
    b_axes = batch_axes(mesh)
    b_n = axis_size(mesh, b_axes)
    model_n = _size(mesh, "model")

    def spec_for(path, leaf) -> P:
        s = path_str(path)
        shape = tuple(leaf.shape)
        if s.endswith("/k") or s.endswith("/v"):
            _, b, cap, _, _ = shape
            bspec = b_axes if _div(b, b_n) else None
            cap_axes = (("data", "model") if bspec is None else ("model",))
            cap_axes = tuple(a for a in cap_axes
                             if a == "model" or shard_capacity)
            n_cap = axis_size(mesh, cap_axes)
            cap_spec = cap_axes if (cap_axes and _div(cap, n_cap)) else None
            return P(None, bspec, cap_spec, None, None)
        if s.endswith("ssm"):
            _, b, h, _, _ = shape
            return P(None, b_axes if _div(b, b_n) else None,
                     "model" if _div(h, model_n) else None, None, None)
        if s.endswith("conv_x"):
            _, b, _, c = shape
            return P(None, b_axes if _div(b, b_n) else None, None,
                     "model" if _div(c, model_n) else None)
        if s.endswith("conv_bc"):
            _, b, _, _ = shape
            return P(None, b_axes if _div(b, b_n) else None, None, None)
        return P()

    return _tree_map_with_path(spec_for, caches)


def batch_pspec(global_batch: int, mesh, extra_dims: int = 1,
                leading_micro: bool = False) -> P:
    """The spec of a (micro?, batch, ...) input."""
    b_axes = batch_axes(mesh)
    b = b_axes if _div(global_batch, axis_size(mesh, b_axes)) else None
    entries = ((None,) if leading_micro else ()) + (b,) + (None,) * extra_dims
    return P(*entries)


# ---------------------------------------------------------------------------
# blocks of a spec
# ---------------------------------------------------------------------------

def local_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """A rank's block shape of a tensor of ``shape`` under ``spec``."""
    dims = list(shape)
    for i, entry in enumerate(tuple(spec)):
        axes = entry_axes(entry)
        if axes:
            dims[i] //= axis_size(mesh, axes)
    return tuple(dims)


def _coordinate(mesh, coord) -> Tuple[int, ...]:
    if coord is not None:
        return tuple(coord)
    got = mesh.get_coordinate()
    if got is None:
        raise RuntimeError("this rank is not in the mesh")
    return tuple(got)


def block_index(mesh, axes: Sequence[str], coord=None) -> int:
    """The row-major index over ``axes`` of the rank at ``coord`` (this
    rank's by default)."""
    names = axis_names(mesh)
    coord = _coordinate(mesh, coord)
    my = 0
    for a in axes:
        i = names.index(a)
        my = my * mesh.shape[i] + coord[i]
    return my


def local_slices(shape: Sequence[int], spec, mesh, coord=None
                 ) -> Tuple[slice, ...]:
    """The index of a rank's block (``coord``: its mesh coordinate, this
    rank's by default)."""
    out = []
    for i, n in enumerate(shape):
        entry = tuple(spec)[i] if i < len(tuple(spec)) else None
        axes = entry_axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        parts = axis_size(mesh, axes)
        if n % parts:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"divide {parts} ranks ({spec})")
        step = n // parts
        j = block_index(mesh, axes, coord)
        out.append(slice(j * step, (j + 1) * step))
    return tuple(out)


def local_shard(t: Tensor, spec, mesh, coord=None) -> Tensor:
    """A rank's block of the global ``t`` under ``spec`` (a view): along a
    dimension split over several axes, the row-major index over them, as
    ``shard_map`` hands it out."""
    return t[local_slices(t.shape, spec, mesh, coord)]


def local_tree(tree: Any, specs: Any, mesh, coord=None) -> Any:
    """``local_shard`` over a tree and its spec tree (copies)."""
    pairs = tree_util.leaves(tree)
    spec_of = dict(_spec_pairs(specs))
    return tree_util.unflatten(
        [p for p, _ in pairs],
        [local_shard(x, spec_of[p], mesh, coord).clone() for p, x in pairs])


def _spec_pairs(specs: Any, path=()) -> list:
    """(path, spec) pairs of a spec tree (a spec is a leaf)."""
    if isinstance(specs, P):
        return [(path, specs)]
    if isinstance(specs, dict):
        out = []
        for k in sorted(specs):
            if specs[k] is not None:
                out += _spec_pairs(specs[k], path + (k,))
        return out
    if isinstance(specs, (list, tuple)):
        kind = tree_util.TupleIndex if isinstance(specs, tuple) else int
        out = []
        for i, sub in enumerate(specs):
            out += _spec_pairs(sub, path + (kind(i),))
        return out
    raise TypeError(f"not a spec tree: {specs!r}")


def spec_leaves(specs: Any) -> list:
    """The specs of a spec tree in ``tree.leaves`` order."""
    return [s for _, s in _spec_pairs(specs)]


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` for each
    mesh axis that splits a dimension, ``Replicate()`` for the others.  A
    dimension split over several axes lists them in the mesh's order,
    which is DTensor's row-major order."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(tuple(spec)):
        axes = entry_axes(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"spec entry {entry} lists axes out of the "
                             f"mesh's order {names}")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return out


__all__ = ["P", "param_pspecs", "opt_pspecs", "server_pspecs",
           "cache_pspecs", "batch_pspec", "batch_axes", "fsdp_axes",
           "path_str", "entry_axes", "local_shape", "local_slices",
           "local_shard", "local_tree", "block_index", "spec_leaves",
           "placements"]
