"""Meshes of ranks with named axes (``repro.launch.mesh``) on
``torch.distributed``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group that the caller has already initialised, laid out row
major: the rank at mesh coordinate ``(i, j)`` of a ``(D, M)`` mesh is
``i·M + j``.  Nothing happens at import: a mesh is built only when a
function below is called, and the caller names the device type
(``"cuda"`` for NCCL, ``"cpu"`` for gloo).

The collectives over a mesh's named axes (``psum``, ``pmean``,
``axis_index``) live in ``core.collectives``; ``axis_size`` is re-exported
here with the reference's meaning.
"""

from __future__ import annotations

from math import prod
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.collectives import axis_names, axis_size

PRODUCTION_SHAPE = (16, 16)              # one pod of 256 ranks
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)            # two pods, 512 ranks
MULTI_POD_AXES = ("pod", "data", "model")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """The row-major mesh of ``shape`` with axis names ``axes`` over the
    ranks of the initialised process group, whose size must be
    ``prod(shape)``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError("initialise the process group before building a "
                           "mesh (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {prod(shape)} ranks, the "
                         f"process group has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh: (16, 16) with axes ``("data", "model")``, or
    with ``multi_pod`` (2, 16, 16) with ``("pod", "data", "model")``.
    ``data`` (and ``pod``) carry the batch, i.e. the FL clients;
    ``model`` carries tensor and expert parallelism."""
    if multi_pod:
        return make_mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device_type)
    return make_mesh(PRODUCTION_SHAPE, PRODUCTION_AXES, device_type)


def make_test_mesh(data: int = 2, model: int = 4,
                   device_type: str = "cuda") -> DeviceMesh:
    """A small ``("data", "model")`` mesh for tests."""
    return make_mesh((data, model), ("data", "model"), device_type)


class AbstractMesh:
    """A mesh's axis names and sizes without ranks (the reference's
    ``jax.sharding.AbstractMesh``): enough for the spec functions of
    ``launch.sharding`` and for ``local_shard`` at a given coordinate."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axes)
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.mesh_dim_names} differ in length")

    def size(self) -> int:
        return prod(self.shape)

    def get_coordinate(self):
        return None

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def batch_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The axes across which the global batch (the FL clients) is
    sharded: every axis but ``model``."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def fsdp_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The axes used for fully sharded parameter storage."""
    return batch_axes(mesh)


__all__ = ["AbstractMesh", "make_mesh", "make_production_mesh", "make_test_mesh",
           "batch_axes", "fsdp_axes", "axis_size", "PRODUCTION_SHAPE",
           "PRODUCTION_AXES", "MULTI_POD_SHAPE", "MULTI_POD_AXES"]
