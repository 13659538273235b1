"""Device timing and exactness helpers for the port's kernel measurements,
shared by ``chip_smoke.py``, ``benchmarks/torch_kernels_bench.py`` and
``tools/torch_kernel_ab.py``.

- ``same(a, b, what)``: bit-for-bit equality (NaN matches NaN), raising
  ``AssertionError`` with the largest difference otherwise;
- ``time_ms(fn)``: (device ms, eager ms) per call, from calls captured in
  one CUDA graph and replayed between CUDA events, and from the same calls
  launched from Python;
- ``bound_ms(n_bytes, n_ops)``: the least time the card could take, the
  larger of the bytes over the memory rate and the operations over the
  float32 rate (H100 SXM data sheet, from ``repro_torch.roofline.
  analysis``);
- ``input_sets(n_bytes)``: how many copies of a call's inputs to cycle
  through so that every call reads its inputs from HBM and not from L2.
"""

from __future__ import annotations

import math
import statistics
from typing import Callable, Sequence, Union

import torch

from repro_torch.roofline.analysis import HBM_BW as PEAK_BYTES_PER_S
from repro_torch.roofline.analysis import \
    PEAK_F32_FLOPS as PEAK_F32_OPS_PER_S

L2_BYTES = 50 * 2**20               # H100 SXM L2 cache


def same(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """Exact equality (bit for bit, NaN matches NaN) -> max |a - b| (0)."""
    assert a.shape == b.shape and a.dtype == b.dtype, (
        f"{what}: shape/dtype {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    assert bool(torch.equal(nan_a, nan_b)), f"{what}: NaN positions differ"
    if a.dtype == torch.float32:
        identical = torch.equal(a[~nan_a].view(torch.int32),
                                b[~nan_b].view(torch.int32))
    else:
        identical = torch.equal(a, b)
    a_n, b_n = a[~nan_a], b[~nan_b]
    # equal infinities differ by 0, not by inf - inf = NaN
    diff = torch.where(a_n == b_n, 0, (a_n - b_n).abs())
    err = float(diff.max()) if diff.numel() else 0.0
    assert bool(identical), f"{what}: kernel and plain differ (max abs {err})"
    return err


def time_ms(fn: Union[Callable, Sequence[Callable]], blocks: int = 50,
            per_block: int = 20):
    """(device ms, eager ms) per call.  Device: ``per_block`` calls
    captured in one CUDA graph, replayed ``blocks`` times between CUDA
    events, median per call — the host's Python and launch overhead is out
    of it.  Eager: the same calls launched from Python, which at small
    sizes mostly measures the host.  ``fn`` may be a list of calls on
    separate inputs, run in turn (at least once each per block): with
    ``input_sets`` copies no call finds its inputs in L2."""
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    per_block = max(per_block, len(fns))
    calls = [fns[i % len(fns)] for i in range(per_block)]
    for call in fns * 3:
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    out = []
    for run in (graph.replay, lambda: [call() for call in calls]):
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(blocks):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        out.append(statistics.median(a.elapsed_time(b) for a, b in pairs)
                   / per_block)
    return out[0], out[1]


def bound_ms(n_bytes: float, n_ops: float):
    """(ms, "bytes" or "operations"): the larger of the two least times."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def input_sets(n_bytes: float) -> int:
    """Copies of a call's inputs whose bytes together reach twice the L2,
    so that between two calls on one copy the others evict it."""
    return max(1, math.ceil(2 * L2_BYTES / n_bytes))
