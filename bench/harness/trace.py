"""The reduction of one profiler session (``torch.profiler``, CPU and CUDA
activity, kept in memory) over the traced window: the device's busy
time (the union of its operations' intervals inside the window), the
device operations by total time, the idle gaps labelled by the
benchmark's host span they fell in, and each kernel's device time and
calls; ``summarize`` adds the program's spans (``spans.py``)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "bench.window"
SPANS = ("bench.stage_batch", "bench.grads_fn", "bench.update")
NAMES = frozenset(SPANS) | {WINDOW}
TOP = 10

Interval = Tuple[float, float]


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of intervals as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: Sequence[Interval], window: Interval) -> List[Interval]:
    """The stretches of ``window`` that no interval of ``busy`` covers."""
    out, at = [], window[0]
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < window[1]:
        out.append((at, window[1]))
    return out


def label(t: float, spans: Sequence[Tuple[float, float, str]]) -> str:
    """The shortest host span that holds time ``t``."""
    best: Optional[Tuple[float, str]] = None
    for a, b, name in spans:
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else "host"


def reduce(device: Sequence[Tuple[float, float, str]],
           host: Sequence[Tuple[float, float, str]]) -> Optional[Dict]:
    """``device``: (start, end, name) of every device operation; ``host``:
    (start, end, name) of the benchmark's spans, one of them the window;
    all in seconds on one clock.  None when the window or the device's
    operations are missing."""
    win = [(a, b) for a, b, n in host if n == WINDOW]
    if not win:
        return None
    w = win[0]
    inside = [(max(a, w[0]), min(b, w[1]), n) for a, b, n in device
              if b > w[0] and a < w[1]]
    if not inside:
        return None
    busy = merge([(a, b) for a, b, _ in inside])
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for a, b, n in inside:
        by_name[n][0] += b - a
        by_name[n][1] += 1
    spans = [s for s in host if s[2] != WINDOW]
    idle = sorted(((label((a + b) / 2, spans), b - a)
                   for a, b in gaps(busy, w)), key=lambda x: -x[1])
    ops = sorted(((n, v[0]) for n, v in by_name.items()),
                 key=lambda x: -x[1])
    return {"window_s": w[1] - w[0],
            "busy_s": sum(b - a for a, b in busy),
            "device_ops": [[n, s] for n, s in ops[:TOP]],
            "idle_gaps": [[n, s] for n, s in idle[:TOP]],
            "kernels": {n: (v[0], v[1]) for n, v in by_name.items()}}


def take(ev, name: str, cuda: bool, device: list, host: list) -> None:
    """Keep one raw profiler event for ``reduce``: the benchmark's spans
    on the host, every other device event."""
    if name in NAMES:
        # a span is also mirrored on the device's timeline
        if not cuda:
            host.append((ev.start_ns() * 1e-9, ev.end_ns() * 1e-9, name))
    elif cuda:
        device.append((ev.start_ns() * 1e-9, ev.end_ns() * 1e-9, name))


def from_profiler(prof) -> Optional[Dict]:
    """``reduce`` over a finished ``torch.profiler.profile``, read from its
    raw events (building the profiler's own event tree takes minutes on a
    window of some 10^5 device operations)."""
    from torch.autograd import DeviceType
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        take(ev, ev.name(), ev.device_type() == DeviceType.CUDA, device,
             host)
    return reduce(device, host)


def summarize(prof) -> Optional[Dict]:
    """``from_profiler``'s summary with the span reduction
    (``spans.from_profiler``'s, or None) under ``"spans"``, both from one
    pass over the raw events; None where the summary is."""
    from torch.autograd import DeviceType
    from bench.harness import spans
    device, host, s_device, s_host = [], [], [], []
    for ev in prof.profiler.kineto_results.events():
        name, cuda = ev.name(), ev.device_type() == DeviceType.CUDA
        take(ev, name, cuda, device, host)
        spans.take(ev, name, cuda, s_device, s_host)
    summary = reduce(device, host)
    if summary is not None:
        summary["spans"] = spans.reduce(s_device, s_host)
    return summary


def kernel_time(summary: Optional[Dict], needle: str
                ) -> Optional[Tuple[float, int]]:
    """(device seconds, calls) of the kernels whose name holds ``needle``;
    None when the trace has none."""
    if not summary:
        return None
    hits = [v for n, v in summary["kernels"].items() if needle in n]
    if not hits:
        return None
    return sum(h[0] for h in hits), sum(h[1] for h in hits)
