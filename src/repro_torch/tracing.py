"""The port's spans: named regions of its own work on the profiler's clock.

``span(name)`` marks a region as ``repro_torch.<name>`` in a
``torch.profiler`` session.  Tracing is on exactly while a session
records (the profiler's own flag, read at each call): there is no
setting of its own.  With no session recording, ``span`` returns one
shared null context and costs a flag read.

A span is a record-function event of the function scope: it lies on the
same clock as the device's events (CUPTI's, linked to their launches by
correlation id) and, unlike a user-scope ``torch.profiler.
record_function``, leaves no mirror of itself on the device's timeline,
which a reader of the device's operations would count as busy time.

On import the module adds one ``gc.callbacks`` hook: while a session
records, each collection of generation 1 or 2 becomes a span
``repro_torch.host.gc1`` / ``host.gc2`` (generation 0 runs thousands of
times a step, microseconds each, and is not recorded).  The hook keeps
one stack of open collections per thread, since a collection may run on
the autograd engine's thread.

The names (prefixed ``repro_torch.``) and where they are opened:

* ``step.grads`` — ``grads_fn``; ``step.micro`` each microbatch;
  ``step.forward`` the loss, ``step.backward`` ``torch.autograd.grad``;
  ``step.accumulate`` the sinks' adds and the closing mean and cast;
* ``step.update`` — ``update``; in the packed server phase
  ``server.pack`` / ``server.unpack``, ``server.vote`` (one-bit),
  ``server.select`` (thresholds and the fused FAIR-k pass),
  ``server.carry`` (the successor state's casts and its copy into the
  carried buffers); ``optim.apply`` the cast to the parameters' dtype and
  the optimizer;
* ``model.attention`` the attention call of the self-attention mixer,
  ``model.ssd`` the chunked SSD and ``model.ssd.link`` its loop over the
  chunks, ``model.logits`` and ``model.loss`` the head and the NLL.

A span inside a checkpointed layer opens again in the recompute, on the
thread that runs the backward pass."""

from __future__ import annotations

import contextlib
import gc
import threading

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

PREFIX = "repro_torch."
_NULL = contextlib.nullcontext()


def span(name: str):
    """The region ``repro_torch.<name>`` while a session records, else the
    one shared null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _RecordFunctionFast(PREFIX + name)


class _GcSpans:
    """The ``gc.callbacks`` hook: generation 1 and 2 collections as spans,
    one stack of open ones per thread."""

    def __init__(self):
        self._open = threading.local()

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            if info["generation"] < 1 or not _profiler._is_profiler_enabled:
                return
            rf = _RecordFunctionFast(f"{PREFIX}host.gc{info['generation']}")
            rf.__enter__()
            self._stack().append(rf)
        else:
            stack = getattr(self._open, "stack", None)
            if stack and info["generation"] >= 1:
                stack.pop().__exit__(None, None, None)

    def _stack(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack


GC_HOOK = _GcSpans()
gc.callbacks.append(GC_HOOK)
