"""Collectives over the named axes of a mesh (the reference's ``lax.psum``,
``lax.pmean`` and ``lax.axis_index`` inside ``shard_map``) on
``torch.distributed``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` laid out row
major (``launch.mesh.make_mesh``).  ``psum(x, mesh, axes)`` is an in-place
``all_reduce(SUM)`` over the ranks that share every coordinate outside
``axes`` (one call on the whole process group when ``axes`` names every
axis), ``pmean`` the same times the float32 reciprocal of the group's
size (``oac.reciprocal``, the compiled reference's form), and
``axis_index(mesh, axes)`` a rank's row-major index over ``axes`` (the
reference's ``my = my * mesh.shape[ax] + axis_index(ax)``).  Every
collective runs on the tensor's device and reads nothing back to the
host.

Along one dimension of a tensor sharded in row-major blocks over some
axes (``launch.sharding``): ``all_gather_dim`` rebuilds the dimension from
every rank's block, ``reduce_scatter_dim`` sums the ranks' whole tensors
and leaves each its block, ``pmax`` is the elementwise maximum.  These
three skip the axes of one rank, so a mesh of one rank runs none of them.
"""

from __future__ import annotations

from math import prod
from typing import Sequence, Tuple

import warnings

import torch
import torch.distributed as dist

from repro_torch.core.oac import reciprocal

Tensor = torch.Tensor


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, axes: Sequence[str]) -> int:
    """The number of ranks along ``axes`` (1 for no axes)."""
    names = axis_names(mesh)
    return prod(mesh.shape[names.index(a)] for a in axes)


def mesh_size(mesh) -> int:
    return axis_size(mesh, axis_names(mesh))


def axis_index(mesh, axes: Sequence[str] = None) -> int:
    """This rank's row-major index over ``axes`` (default: every axis, in
    the mesh's order), a host integer."""
    names = axis_names(mesh)
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    my = 0
    for a in (names if axes is None else axes):
        i = names.index(a)
        my = my * mesh.shape[i] + coord[i]
    return my


def psum(x: Tensor, mesh, axes: Sequence[str]) -> Tensor:
    """``x`` summed over the ranks along ``axes``, in place (the
    reference's ``lax.psum``): one ``all_reduce`` over the whole mesh when
    ``axes`` names every axis and the mesh spans the process group, else
    one per axis — also where an axis has one rank, so that a world of one
    runs the collectives of a larger one.  Returns ``x``."""
    names = axis_names(mesh)
    axes = tuple(axes)
    for a in axes:
        if a not in names:
            raise ValueError(f"unknown mesh axis {a!r}; the mesh has "
                             f"{names}")
    if not axes:
        return x
    if set(axes) == set(names) and mesh_size(mesh) == dist.get_world_size():
        dist.all_reduce(x)
        return x
    for a in axes:
        dist.all_reduce(x, group=mesh.get_group(a))
    return x


def pmean(x: Tensor, mesh, axes: Sequence[str]) -> Tensor:
    """The mean of ``x`` over the ranks along ``axes`` (the reference's
    ``lax.pmean``): ``psum`` times the float32 reciprocal of their count.
    ``x`` is summed in place."""
    return psum(x, mesh, axes) * reciprocal(axis_size(mesh, axes))


def all_gather_flat(x: Tensor, mesh) -> Tensor:
    """The 1-D shards ``x`` of every rank of a row-major mesh over the whole
    process group (``launch.mesh.make_mesh``'s), concatenated in the order
    of ``axis_index``: the global vector of a vector sharded across every
    axis."""
    n = mesh_size(mesh)
    if n == 1:
        return x
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError("all_gather_flat needs a row-major mesh over the "
                         "whole process group (launch.mesh.make_mesh)")
    parts = torch.empty(n, x.shape[0], dtype=x.dtype, device=x.device)
    dist.all_gather(list(parts.unbind(0)), x.contiguous())
    return parts.reshape(-1)


def _quiet(fn, *args, **kw):
    # the tensor forms of all_gather / reduce_scatter warn of a rename in
    # newer releases; the old names are what every release accepts
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kw)


def spread(mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    """``axes`` without those of one rank, over which nothing moves."""
    return tuple(a for a in axes if axis_size(mesh, (a,)) > 1)


def all_gather_dim(x: Tensor, mesh, axes: Sequence[str], dim: int
                   ) -> Tensor:
    """``x`` (this rank's block of dimension ``dim``, split over ``axes`` in
    row-major order) -> the whole dimension, on every rank along ``axes``:
    one ``all_gather`` per axis of more than one rank, innermost first
    (``x`` itself when there is none)."""
    for a in reversed(spread(mesh, axes)):
        n = axis_size(mesh, (a,))
        xt = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                          dtype=xt.dtype, device=xt.device)
        _quiet(dist.all_gather_into_tensor, out, xt,
               group=mesh.get_group(a))
        x = out.movedim(0, dim).contiguous()
    return x


def reduce_scatter_dim(x: Tensor, mesh, axes: Sequence[str], dim: int
                       ) -> Tensor:
    """The sum of ``x`` over the ranks along ``axes``, of which each keeps
    its row-major block of dimension ``dim``: one ``reduce_scatter`` per
    axis of more than one rank, outermost first (``x`` itself when there
    is none)."""
    for a in spread(mesh, axes):
        n = axis_size(mesh, (a,))
        xt = x.movedim(dim, 0).contiguous()
        if xt.shape[0] % n:
            raise ValueError(f"dimension {dim} ({xt.shape[0]}) does not "
                             f"divide the {n} ranks of axis {a!r}")
        out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                          dtype=xt.dtype, device=xt.device)
        _quiet(dist.reduce_scatter_tensor, out, xt, group=mesh.get_group(a))
        x = out.movedim(0, dim).contiguous()
    return x


def pmax(x: Tensor, mesh, axes: Sequence[str]) -> Tensor:
    """The elementwise maximum of ``x`` over the ranks along ``axes``, in
    place; returns ``x``."""
    for a in spread(mesh, axes):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    return x


__all__ = ["axis_names", "axis_size", "mesh_size", "axis_index", "psum",
           "pmean", "all_gather_flat", "spread", "all_gather_dim",
           "reduce_scatter_dim", "pmax"]
