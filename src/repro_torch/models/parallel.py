"""How a rank of a mesh runs its part of the models (the reference's
GSPMD partitioning of ``models.transformer`` under ``launch.sharding``'s
specs, written out).

A ``Parallel`` rides the model functions as ``par=`` (None on one card,
where nothing here runs):

* ``rows``: the mesh axes the batch rows are split over (empty when they
  are replicated).  Each rank runs its rows; the MoE load-balance loss's
  token fractions are averaged over them, so the loss is the global
  batch's; single-token MoE decoding routes the whole batch (the
  reference's one routing group), gathered over them.
* ``gather(tree, stack, i)``: block ``i`` of the parameter stack
  ``stack`` ("blocks", "enc_blocks") from the rank's local blocks of its
  leaves, gathered over the axes that split them — inside the
  checkpointed block function, so full weights live one block at a time
  and are gathered again when the backward pass recomputes the block.
* ``seq``: sequence parallelism — the residual carried (and saved)
  between blocks is the rank's slice of the sequence over these axes;
  each block gathers it back on entry and keeps its slice on exit.
* ``experts``: the expert pin — the MoE layers' expert weights arrive as
  the rank's ``E/M`` experts, and the layer computes only their slots.
* ``kv``, ``cross``, ``ssm``, ``conv``: the axes that split an attention
  cache's capacity, a cross-attention cache's frames, the SSM state's
  heads and the ``conv_x`` carry's channels.

The activations and their gradients are equal on every rank of one row
of the mesh: a gather's backward keeps the rank's block of the gradient
and a slice's backward gathers the blocks back, both exact, so no
gradient is summed inside the model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core import collectives

Tensor = torch.Tensor


def block_of(mesh, axes: Tuple[str, ...]) -> int:
    """This rank's row-major index over ``axes``."""
    return collectives.axis_index(mesh, axes) if axes else 0


def narrow_block(x: Tensor, mesh, axes: Tuple[str, ...], dim: int
                 ) -> Tensor:
    """This rank's row-major block of dimension ``dim`` over ``axes``."""
    if not axes:
        return x
    n = collectives.axis_size(mesh, axes)
    size = x.shape[dim] // n
    return x.narrow(dim, block_of(mesh, axes) * size, size)


class _Gather(torch.autograd.Function):
    """Forward: the whole dimension from every rank's block; backward: the
    rank's block of the gradient (every rank holds the same gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.meta = (mesh, axes, dim)
        return collectives.all_gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.meta
        return narrow_block(g, mesh, axes, dim).contiguous(), None, None, None


class _Slice(torch.autograd.Function):
    """Forward: the rank's block; backward: the gradient's blocks gathered
    from every rank."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.meta = (mesh, axes, dim)
        return narrow_block(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.meta
        return (collectives.all_gather_dim(g.contiguous(), mesh, axes, dim),
                None, None, None)


def gather_dim(x: Tensor, mesh, axes: Tuple[str, ...], dim: int) -> Tensor:
    return _Gather.apply(x, mesh, tuple(axes), dim) if axes else x


def slice_dim(x: Tensor, mesh, axes: Tuple[str, ...], dim: int) -> Tensor:
    return _Slice.apply(x, mesh, tuple(axes), dim) if axes else x


def _gather_entries(x: Tensor, mesh, entries) -> Tensor:
    for dim, axes in entries:
        x = collectives.all_gather_dim(x, mesh, axes, dim)
    return x


class _GatherInto(torch.autograd.Function):
    """A parameter block gathered over the axes of its spec; the backward
    pass adds the whole block's gradient, in float32, into ``sink`` (the
    step's accumulator) and hands nothing on."""

    @staticmethod
    def forward(ctx, x, sink, mesh, entries):
        ctx.sink = sink
        return _gather_entries(x, mesh, entries)

    @staticmethod
    def backward(ctx, g):
        if ctx.sink is not None:
            ctx.sink.add_(g.to(torch.float32))
        return None, None, None, None


def gather_param(x: Tensor, mesh, entries, sink: Optional[Tensor]) -> Tensor:
    """``x`` (a rank's block) gathered over ``entries`` ((dim, axes) pairs);
    with autograd on, its gradient lands in ``sink``.  With no entries
    ``x`` itself, whose gradient autograd hands back to the caller."""
    if not entries:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherInto.apply(x, sink, mesh, entries)
    return _gather_entries(x, mesh, entries)


@dataclasses.dataclass
class Parallel:
    mesh: Any
    rows: Tuple[str, ...] = ()
    gather: Optional[Callable] = None
    seq: Tuple[str, ...] = ()
    experts: Tuple[str, ...] = ()
    kv: Tuple[str, ...] = ()
    cross: Tuple[str, ...] = ()
    ssm: Tuple[str, ...] = ()
    conv: Tuple[str, ...] = ()

    def block_params(self, tree, stack: str, i: int):
        return tree if self.gather is None else self.gather(tree, stack, i)

    def row_mean(self, x: Tensor) -> Tensor:
        """``x`` (a mean over the rank's rows) averaged over the row axes
        (a new tensor; no gradient flows through it)."""
        if not self.rows:
            return x
        return collectives.pmean(x.detach().clone(), self.mesh, self.rows)

    def gather_rows(self, x: Tensor) -> Tensor:
        return gather_dim(x, self.mesh, self.rows, 0)

    def my_rows(self, x: Tensor) -> Tensor:
        return narrow_block(x, self.mesh, self.rows, 0)


__all__ = ["Parallel", "gather_dim", "slice_dim", "gather_param",
           "narrow_block", "block_of"]
