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
* ``gather(tree, stack, i, prefix)``: block ``i`` of the parameter stack
  ``stack`` ("blocks", "enc_blocks") — the layer at ``prefix`` in it —
  from the rank's local blocks of its leaves, gathered over the axes
  that split them inside the layer's (checkpointed) function, so full
  weights live one layer at a time and are gathered again when the
  backward pass recomputes the layer.
* ``seq``: sequence parallelism — the residual carried (and saved)
  between blocks is the rank's slice of the sequence over these axes;
  each block gathers it back on entry and keeps its slice on exit.
* ``experts``: the expert pin — the MoE layers' expert weights arrive as
  the rank's ``E/M`` experts, and the layer computes only their slots.
* ``kv``, ``cross``, ``ssm``, ``conv``: the axes that split an attention
  cache's capacity, a cross-attention cache's frames, the SSM state's
  heads and the ``conv_x`` carry's channels.

* ``tp`` and ``split``: tensor parallelism over ``model`` in the train
  step and the serving steps — the parts of the model named in ``split``
  ("attn", "ffn", "experts", "moe", "ssm", "vocab"; ``tp_split``) arrive
  as the rank's block of their matmul weights along the TP dimension of
  the reference's spec, and each rank computes only its part (heads
  that do not split evenly: ``head_range``'s uneven runs of whole heads,
  ``wq`` / ``wo`` gathered over ``tp`` in the layer and narrowed to
  them, the gather's backward a reduce-scatter of the ranks' partial
  gradients to each rank's block).  Serving runs the same regions under
  ``torch.no_grad`` (only their forwards: nothing, or a sum or gather
  over ``tp``) with ``float32_sums``: a row-parallel product's partial
  outputs are summed in float32 and rounded once to the compute dtype
  (``row_parallel``), as one card's product rounds — partials rounded
  to bfloat16 before their sum move each output by up to an ulp and,
  decoding, flip MoE routes away from one card's decode; training sums
  them in the compute dtype.

Outside a split part the activations and their gradients are equal on
every rank of one row of the mesh: a gather's backward keeps the rank's
block of the gradient and a slice's backward gathers the blocks back.  A
split part is a region (Megatron's column- then row-parallel pair): it
is entered through ``enter`` (forward the input whole, backward the sum
over ``tp`` of the ranks' partial gradients; under sequence parallelism
an all-gather of the sequence slice whose backward is a reduce-scatter)
and left through ``leave`` (forward the sum over ``tp`` of the ranks'
partial outputs, or its reduce-scatter over the sequence; backward the
gradient whole).  Inside a region a replicated weight's gradient is the
rank's partial one: ``partial`` sums it over ``tp``.  Under sequence
parallelism the residual stays the rank's slice of the sequence through
the block, so the norms that run on it see a partial gradient too
(``on_slice``).

The step's gradients leave the model block by block: the backward pass
of ``gather_param`` reduce-scatters a gathered block's gradient over the
batch axes it was gathered over (the FSDP pair of the forward
all-gather), keeps the rank's block along the others, and adds it in
float32 into the step's accumulator of the rank's local shape.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core import collectives
from repro_torch.models.layers import dense

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


def scatter_grad(g: Tensor, mesh, entries, rows: Tuple[str, ...],
                 dtype=torch.float32) -> Tensor:
    """A gathered block's gradient -> the rank's block: narrowed to the
    rank's block along every gathered dimension but the one gathered over
    ``rows`` (the batch axes), which is reduce-scattered over them in
    ``dtype`` (the rank's rows' gradient summed with the other rows')."""
    rs = None
    for dim, axes in entries:
        if rows and tuple(axes) == tuple(rows):
            rs = dim
        else:
            g = narrow_block(g, mesh, axes, dim)
    g = g.to(dtype)
    if rs is not None:
        g = collectives.reduce_scatter_dim(g, mesh, rows, rs)
    return g


class _GatherInto(torch.autograd.Function):
    """A parameter block gathered over the axes of its spec; the backward
    pass reduce-scatters the block's gradient over ``rows`` and keeps the
    rank's block along the other gathered dimensions (``scatter_grad``),
    adds it in float32 into ``sink`` (the step's accumulator of the rank's
    local shape) and hands nothing on."""

    @staticmethod
    def forward(ctx, x, sink, mesh, entries, rows, dtype):
        ctx.meta = (sink, mesh, entries, rows, dtype)
        return _gather_entries(x, mesh, entries)

    @staticmethod
    def backward(ctx, g):
        sink, mesh, entries, rows, dtype = ctx.meta
        if sink is not None:
            sink.add_(scatter_grad(g, mesh, entries, rows, dtype)
                      .to(torch.float32))
        return None, None, None, None, None, None


def gather_param(x: Tensor, mesh, entries, sink: Optional[Tensor],
                 rows: Tuple[str, ...] = (), dtype=torch.float32) -> Tensor:
    """``x`` (a rank's block) gathered over ``entries`` ((dim, axes) pairs);
    with autograd on, the rank's block of its gradient (``scatter_grad``
    over ``rows`` in ``dtype``) lands in ``sink``.  With no entries ``x``
    itself, whose gradient autograd hands back to the caller."""
    if not entries:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherInto.apply(x, sink, mesh, entries, tuple(rows), dtype)
    return _gather_entries(x, mesh, entries)


# ---------------------------------------------------------------------------
# tensor parallelism over ``model``
# ---------------------------------------------------------------------------

def _summed(x: Tensor, mesh, axes) -> Tensor:
    return collectives.psum(x.clone(memory_format=torch.contiguous_format),
                            mesh, axes)


class _CopyTo(torch.autograd.Function):
    """Column-parallel input: forward ``x``; backward the sum over ``axes``
    of the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.meta = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.meta
        return _summed(g, mesh, axes), None, None


class _ReduceFrom(torch.autograd.Function):
    """Row-parallel output: forward the sum over ``axes`` of the ranks'
    partial outputs; backward the gradient (equal on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _summed(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBoth(torch.autograd.Function):
    """A sum over ``axes`` inside a region (a statistic every rank's
    partial output depends on): summed forward and backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.meta = (mesh, axes)
        return _summed(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.meta
        return _summed(g, mesh, axes), None, None


class _GatherSeq(torch.autograd.Function):
    """Sequence-parallel column input (and any dimension a region needs
    whole, as the MoE fallback's hidden units): forward the whole
    dimension from the ranks' blocks; backward the reduce-scatter of the
    partial gradients (each rank keeps its block, summed over the
    ranks)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.meta = (mesh, axes, dim)
        return collectives.all_gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.meta
        return (collectives.reduce_scatter_dim(g, mesh, axes, dim),
                None, None, None)


class _ScatterSeq(torch.autograd.Function):
    """Sequence-parallel row output: forward the ranks' partial outputs
    summed, each rank keeping its slice of the sequence; backward the
    gradient's slices gathered."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.meta = (mesh, axes, dim)
        return collectives.reduce_scatter_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.meta
        return (collectives.all_gather_dim(g.contiguous(), mesh, axes, dim),
                None, None, None)


def copy_to(x: Tensor, mesh, axes) -> Tensor:
    return _CopyTo.apply(x, mesh, tuple(axes)) if axes else x


def reduce_from(x: Tensor, mesh, axes) -> Tensor:
    return _ReduceFrom.apply(x, mesh, tuple(axes)) if axes else x


def sum_both(x: Tensor, mesh, axes) -> Tensor:
    return _SumBoth.apply(x, mesh, tuple(axes)) if axes else x


def gather_seq(x: Tensor, mesh, axes, dim: int = 1) -> Tensor:
    return _GatherSeq.apply(x, mesh, tuple(axes), dim) if axes else x


def scatter_seq(x: Tensor, mesh, axes, dim: int = 1) -> Tensor:
    return _ScatterSeq.apply(x, mesh, tuple(axes), dim) if axes else x


def heads_split(n_heads: int, n_kv: int, m: int) -> bool:
    """Whether ``n_heads`` split into whole heads over ``m`` ranks with
    every rank's heads reading a contiguous run of whole kv groups (the
    even path: the spec's blocks of ``wq`` / ``wo`` are the rank's
    heads)."""
    if not n_heads or n_heads % m:
        return False
    per, hpg = n_heads // m, n_heads // max(n_kv, 1)
    return per % hpg == 0 or hpg % per == 0


def head_range(n_heads: int, r: int, m: int) -> Tuple[int, int]:
    """Rank ``r`` of ``m``'s whole heads ``[h0, h1)`` where they do not
    split evenly (``heads_split`` false): ``h0 = floor(r·H/m)``, ⌊H/m⌋ or
    ⌈H/m⌉ heads each — none on some ranks where H < m."""
    return r * n_heads // m, (r + 1) * n_heads // m


def tp_split(cfg, mesh) -> frozenset:
    """The parts of ``cfg`` that split over ``model`` on ``mesh`` (none
    when ``model`` has one rank): "attn" wherever the spec splits ``wq``'s
    columns, ``n_heads·head_dim`` dividing ``model`` — its whole heads
    evenly (``heads_split``), else in ``head_range``'s uneven runs —,
    "ffn" (dense MLPs) where ``d_ff`` divides, "experts" where the
    experts divide (each rank runs its experts, as under the expert pin,
    which the reference sets only from two experts a rank on), else "moe"
    where ``moe_d_ff`` divides, "ssm" where the SSM heads divide, "vocab"
    where the vocabulary divides — each where the reference's spec puts
    ``model`` on that dimension."""
    m = collectives.axis_size(mesh, collectives.spread(mesh, ("model",)))
    if m == 1:
        return frozenset()
    parts = set()
    if cfg.n_heads and (cfg.n_heads * cfg.head_dim) % m == 0:
        parts.add("attn")
    dense_ffn = cfg.dense_residual or not all(
        cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    if cfg.d_ff and dense_ffn and cfg.d_ff % m == 0:
        parts.add("ffn")
    if cfg.n_experts and cfg.n_experts % m == 0:
        parts.add("experts")
    elif cfg.n_experts and cfg.moe_d_ff % m == 0:
        parts.add("moe")
    if cfg.ssm_state and cfg.ssm_heads % m == 0:
        parts.add("ssm")
    if cfg.vocab % m == 0:
        parts.add("vocab")
    return frozenset(parts)


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
    tp: Tuple[str, ...] = ()
    split: frozenset = frozenset()
    float32_sums: bool = False

    def block_params(self, tree, stack: str, i: int, prefix=()):
        """Block ``i`` of ``stack`` (the subtree at ``prefix`` in it) from
        the rank's blocks of its leaves, gathered."""
        return (tree if self.gather is None
                else self.gather(tree, stack, i, prefix))

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

    # -- the regions of tensor parallelism --------------------------------

    def splits(self, part: str) -> bool:
        return part in self.split

    def tp_index(self) -> Tuple[int, int]:
        """(this rank's index over ``tp``, the number of ranks)."""
        return (block_of(self.mesh, self.tp),
                collectives.axis_size(self.mesh, self.tp))

    def enter(self, x: Tensor, part: Optional[str]) -> Tensor:
        """A sub-layer's input (the residual's layout: the rank's slice of
        the sequence under ``seq``) -> what the sub-layer runs on: the
        region's input when ``part`` splits, else the whole sequence."""
        if part is not None and self.splits(part):
            if self.seq:
                return gather_seq(x, self.mesh, self.seq, 1)
            return copy_to(x, self.mesh, self.tp)
        return gather_dim(x, self.mesh, self.seq, 1)

    def leave(self, y: Tensor, part: Optional[str]) -> Tensor:
        """A sub-layer's output -> the residual's layout: the region's
        partial outputs summed when ``part`` splits, else the rank's
        slice of the whole output."""
        if part is not None and self.splits(part):
            if self.seq:
                return scatter_seq(y, self.mesh, self.seq, 1)
            return reduce_from(y, self.mesh, self.tp)
        return slice_dim(y, self.mesh, self.seq, 1)

    def partial(self, w: Tensor) -> Tensor:
        """A replicated weight used inside a region: its gradient summed
        over ``tp``."""
        return copy_to(w, self.mesh, self.tp)

    def on_slice(self, w: Tensor) -> Tensor:
        """A replicated weight used on the residual's sequence slice: its
        gradient summed over ``seq``."""
        return copy_to(w, self.mesh, self.seq)


def enter(par: Optional[Parallel], x: Tensor, part: Optional[str]) -> Tensor:
    return x if par is None else par.enter(x, part)


def leave(par: Optional[Parallel], y: Tensor, part: Optional[str]) -> Tensor:
    return y if par is None else par.leave(y, part)


def splits(par: Optional[Parallel], part: str) -> bool:
    return par is not None and par.splits(part)


def row_parallel(par: Optional[Parallel], p, x: Tensor, part: str,
                 compute_dtype) -> Tensor:
    """``x @ w (+ b)`` of a row-parallel weight in ``compute_dtype``, left
    to the residual's layout (``leave``).  Where ``part`` splits, ``p``
    holds no bias; with ``par.float32_sums`` the rank's partial product
    of the compute-dtype operands is taken in float32 (their products are
    exact there), summed over ``tp`` and rounded once."""
    if not (splits(par, part) and par.float32_sums):
        return leave(par, dense(p, x, compute_dtype), part)
    w = p["w"].to(compute_dtype).to(torch.float32)
    y = torch.matmul(x.to(compute_dtype).to(torch.float32), w)
    return leave(par, y, part).to(compute_dtype)


__all__ = ["Parallel", "gather_dim", "slice_dim", "gather_param",
           "scatter_grad", "narrow_block", "block_of", "copy_to",
           "reduce_from", "sum_both", "gather_seq", "scatter_seq",
           "heads_split", "head_range", "tp_split", "enter", "leave",
           "splits", "row_parallel"]
