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
"""

from __future__ import annotations

from math import prod
from typing import Sequence, Tuple

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


__all__ = ["axis_names", "axis_size", "mesh_size", "axis_index", "psum",
           "pmean", "all_gather_flat"]
