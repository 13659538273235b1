"""Count one rank's step as the card runs it, from the operations PyTorch
dispatches (the port's counterpart of ``repro.roofline.hlo``).

There is no HLO to parse and eager PyTorch fuses nothing, so every
operation that reaches the dispatcher is one trip to device memory.
``StepCounter`` is a ``TorchDispatchMode``; entered inside a
``FakeTensorMode`` it counts a step on tensors that hold no memory, at any
size:

* FLOPs of the matmuls, attention and convolutions by dtype, from
  ``torch.utils.flop_counter``'s formulas.  A Python loop over layers or
  microbatches runs its body once per iteration, so the reference's
  trip-count multiply comes for free;
* bytes: the operands plus the results of every operation that is not a
  view or metadata (the reference's non-fusion rule), with three
  refinements: an ``out=`` argument is written and not read, a write-only
  operation (``copy_``, ``fill_``, ``zero_``, the random fills) does not
  read its destination, and an in-place scatter (``index_copy_``,
  ``index_put_``, ``scatter_``, ...) touches only the rows it writes.  A
  broadcast (stride-0) dimension counts once.  The port's kernels are
  ``torch.library`` custom ops, so each is one operation here, as a
  custom-call is one instruction to the reference;
* collective bytes per rank: for each ``c10d`` operation max(operand,
  result) bytes, by kind, with counts, and split by link: a process group
  inside one node of ``analysis.NODE_RANKS`` ranks rides NVLink, any other
  the network card;
* the peak of the bytes alive on the rank: every output's storage counts
  from its creation until it is freed (a ``weakref.finalize`` on it), and
  ``track`` adds tensors that exist before the step (parameters, optimizer
  and server state, the batch).

``result()`` returns the reference's keys (``flops_per_device``,
``bytes_per_device``, ``collective_bytes_per_device``,
``collective_breakdown``, ``collective_counts``), ``n_ops`` in place of
``n_computations``, and ``flops_by_dtype``, ``collective_link_bytes``,
``peak_bytes``, ``tracked_bytes``, ``ops`` (operations by name) and
``op_bytes`` (their bytes by name).
"""

from __future__ import annotations

import weakref
from collections import Counter, defaultdict
from math import prod
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import NODE_RANKS

Tensor = torch.Tensor

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# ``c10d`` operations by the reference's kind
_COLLECTIVE_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

# allocations, and the views whose schemas declare no alias: no bytes move
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "lift_fresh", "_unsafe_view",
             "_reshape_alias"}
# the destination is written, not read
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_"}
# in-place scatters: only the written rows of ``self`` move
_SCATTER = {"index_copy_", "index_put_", "_index_put_impl_", "index_fill_",
            "index_add_", "scatter_", "scatter_add_"}
_SOURCE_ARGS = ("source", "src", "values")


def tensor_bytes(t: Tensor) -> int:
    """Bytes of ``t``'s distinct elements: a broadcast (stride-0)
    dimension counts once."""
    n = prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return int(n) * t.element_size()


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, Tensor)]


def _group_of(args):
    """The process group a collective runs on (None: the world)."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:
                continue                      # a ReduceOp or a Work
    return None


def _collective_split(func, args, kwargs, out) -> Tuple[int, int]:
    """(operand, result) bytes of a collective.  The ``c10d`` schemas mark
    no argument as written: the result is what the op returns (an
    in-place op returns its buffers) or, when it returns no tensor, its
    ``output`` arguments; the operands are the other tensor arguments."""
    returned = _tensors(out)
    if not returned:
        names = [a.name for a in func._schema.arguments]
        returned = [t for n, v in zip(names, args) if n.startswith("output")
                    for t in _tensors(v)]
    keys = {t._cdata for t in returned}
    operand = sum(tensor_bytes(t) for t in _tensors((args, kwargs))
                  if t._cdata not in keys)
    return operand, sum(tensor_bytes(t) for t in returned)


class StepCounter(TorchDispatchMode):
    """Counts what the operations dispatched under it read, write, compute
    and communicate, and the bytes alive (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = defaultdict(float)
        self.bytes = 0.0
        self.coll = {k: 0.0 for k in COLLECTIVES}
        self.coll_count = {k: 0.0 for k in COLLECTIVES}
        self.link = {"nvlink": 0.0, "nic": 0.0}
        self.ops: Counter = Counter()
        self.op_bytes: Dict[str, float] = defaultdict(float)
        self.n_ops = 0
        self.live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.tracked_bytes = 0
        self._links: Dict[int, str] = {}

    # -- liveness ----------------------------------------------------------

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def _alive(self, t: Tensor) -> int:
        """Count ``t``'s storage from now until it is freed; returns the
        bytes it added (0 when already counted)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return 0
        n = st.nbytes()
        self.live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)
        return n

    def track(self, *trees: Any) -> int:
        """Count the tensors of ``trees`` (nested dicts, lists, tuples) as
        alive, as a step's inputs are; returns the bytes they added."""
        added = 0
        for tree in trees:
            for t in _tensors(tree):
                added += self._alive(t)
        self.tracked_bytes += added
        return added

    # -- links -------------------------------------------------------------

    def _link_of(self, group) -> str:
        if group is None:
            ranks = range(dist.get_world_size()) if dist.is_initialized() \
                else range(1)
        else:
            key = id(group)
            if key in self._links:
                return self._links[key]
            ranks = dist.get_process_group_ranks(group)
        link = ("nvlink" if len({r // NODE_RANKS for r in ranks}) <= 1
                else "nic")
        if group is not None:
            self._links[id(group)] = link
        return link

    # -- dispatch ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":          # metadata (``prim.device``)
            return out
        self.n_ops += 1
        name = func.overloadpacket.__name__
        key = f"{func.namespace}.{name}"
        self.ops[key] += 1
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            ins = _tensors(args)
            dt = str(ins[0].dtype).replace("torch.", "") if ins else "?"
            self.flops_by_dtype[dt] += float(
                formula(*args, **kwargs, out_val=out))
        moved = self._bytes(func, name, args, kwargs, out)
        self.bytes += moved
        self.op_bytes[key] += moved
        if func.namespace == "c10d" and name in _COLLECTIVE_KIND:
            self._collective(func, name, args, kwargs, out)
        for t in _tensors(out):
            self._alive(t)
        return out

    def _bytes(self, func, name, args, kwargs, out) -> float:
        if (func.namespace == "prim" or name in _NO_BYTES
                or getattr(func, "is_view", False)):
            return 0.0
        if func.namespace == "c10d":
            return float(sum(_collective_split(func, args, kwargs, out)))
        schema = func._schema
        written, outs = {}, set()
        values = {}
        for i, arg in enumerate(schema.arguments):
            v = kwargs.get(arg.name) if arg.kwarg_only or i >= len(args) \
                else args[i]
            if v is None and arg.name in kwargs:
                v = kwargs[arg.name]
            values[arg.name] = v
            if arg.alias_info is not None and arg.alias_info.is_write:
                written[arg.name] = v
                if arg.kwarg_only:            # an out= argument
                    outs.add(arg.name)
        if name in _SCATTER:
            reads = sum(tensor_bytes(t) for k, v in values.items()
                        if k != "self" for t in _tensors(v))
            src = [t for k in _SOURCE_ARGS for t in _tensors(values.get(k))]
            if src:
                writes = sum(tensor_bytes(t) for t in src)
            else:                             # index_fill_: whole rows
                self_t = values["self"]
                idx = _tensors(values.get("index"))
                dim = values.get("dim", 0)
                row = self_t.numel() // max(1, self_t.shape[dim]) \
                    if self_t.dim() else 1
                writes = (sum(t.numel() for t in idx) * row
                          * self_t.element_size())
            return float(reads + writes)
        read = 0
        for k, v in values.items():
            if k in outs or (k in written and name in _WRITE_ONLY):
                continue
            read += sum(tensor_bytes(t) for t in _tensors(v))
        result = sum(tensor_bytes(t) for t in _tensors(out))
        if not _tensors(out):                 # an in-place op returning none
            result = sum(tensor_bytes(t) for v in written.values()
                         for t in _tensors(v))
        return float(read + result)

    def _collective(self, func, name, args, kwargs, out) -> None:
        kind = _COLLECTIVE_KIND[name]
        operand, result = _collective_split(func, args, kwargs, out)
        moved = float(max(operand, result))
        self.coll[kind] += moved
        self.coll_count[kind] += 1
        self.link[self._link_of(_group_of(args))] += moved

    # -- the counts --------------------------------------------------------

    def result(self) -> Dict[str, Any]:
        return {
            "flops_per_device": float(sum(self.flops_by_dtype.values())),
            "bytes_per_device": float(self.bytes),
            "collective_bytes_per_device": float(sum(self.coll.values())),
            "collective_breakdown": dict(self.coll),
            "collective_counts": dict(self.coll_count),
            "n_ops": self.n_ops,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "collective_link_bytes": dict(self.link),
            "peak_bytes": int(self.peak_bytes),
            "tracked_bytes": int(self.tracked_bytes),
            "ops": dict(self.ops),
            "op_bytes": dict(self.op_bytes),
        }


def count(fn, *args):
    """``(fn(*args), counts)``: the call run under a fresh ``StepCounter``,
    with the arguments counted as alive from the start."""
    counter = StepCounter()
    counter.track(args)
    with counter:
        out = fn(*args)
    return out, counter.result()


__all__ = ["COLLECTIVES", "StepCounter", "count", "tensor_bytes"]
