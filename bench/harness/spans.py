"""Device time traced to the program's spans (``repro_torch.*``, opened
by ``repro_torch.tracing``), from the events of one profiler session.

Each device operation (a kernel, a copy or a fill) is linked by its
correlation id to the runtime or driver call that launched it.  On the
launching thread, the innermost open event among the program's spans and
autograd's ``evaluate_function`` events decides its owner:

* a program span owns it (a span that a checkpoint's recompute opens
  again, inside the backward pass, owns the recompute's operations);
* an ``evaluate_function`` hands it to the forward operation of the same
  ``(forward thread, sequence number)``, and the innermost span open
  around that operation owns it (a backward operation belongs to the
  span of the forward work it differentiates);
* without either, or where the link finds no span, the innermost span
  open on any thread at the launch owns it; else nothing does.

Per span name the reduction gives its own device seconds, its inclusive
device seconds (the operations whose owner is the span, or that were
launched while a span of that name was open on any thread), its own and
inclusive launch calls, its calls and their host seconds, the
device-idle seconds that its calls' intervals overlap, and the idle
seconds that ended at one of its operations (the device waited for the
launch); every idle gap is labelled with the innermost
program span open at its middle on any thread, else the benchmark's
innermost span there, else ``host``.  Everything is one pass over the
events with dictionaries and per-thread bisection: the profiler's own
event tree takes minutes at the size of a window."""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from bench.harness import trace

PREFIX = "repro_torch."
BACKWARD = "autograd::engine::evaluate_function:"
LONG_GAP_S = 0.02
# the host events the link reads, by the start of their names
_KEEP = (PREFIX, BACKWARD, "bench.", "cu")

# (start, end, name, correlation id) of a device operation
Device = Tuple[float, float, str, int]
# (start, end, name, thread, correlation id, sequence number, forward
# thread) of a host event: a span, an evaluate_function, a forward
# operation that made an autograd node, or a runtime or driver call
Host = Tuple[float, float, str, int, int, int, int]


class _Nest:
    """The properly nested intervals of one thread, sorted by start."""

    def __init__(self, items: List[Tuple[float, float, str, object]]):
        items.sort(key=lambda x: (x[0], -x[1]))
        self.items = items
        self.starts = [x[0] for x in items]
        self.parent: List[int] = []
        # the nearest program span at or above each interval, and the
        # names of the program spans on its chain
        self.span_up: List[int] = []
        self.names_up: List[frozenset] = []
        stack: List[int] = []
        empty = frozenset()
        for i, (a, _, name, kind) in enumerate(items):
            while stack and items[stack[-1]][1] <= a:
                stack.pop()
            p = stack[-1] if stack else -1
            self.parent.append(p)
            if kind is _SPAN:
                self.span_up.append(i)
                self.names_up.append((self.names_up[p] if p >= 0 else empty)
                                     | {name})
            else:
                self.span_up.append(self.span_up[p] if p >= 0 else -1)
                self.names_up.append(self.names_up[p] if p >= 0 else empty)
            stack.append(i)

    def innermost(self, t: float) -> int:
        """The innermost interval open at ``t`` (-1: none)."""
        i = bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] < t:
            i = self.parent[i]
        return i


_SPAN, _EVAL = object(), object()


def _any_thread(nests: Dict[int, _Nest], t: float
                ) -> Tuple[Optional[str], frozenset]:
    """(the innermost program span open at ``t`` on any thread: the one
    that opened last, the names of every program span open at ``t``)."""
    best, best_start, names = None, None, frozenset()
    for nest in nests.values():
        i = nest.innermost(t)
        if i < 0:
            continue
        s = nest.span_up[i]
        if s < 0:
            continue
        names = names | nest.names_up[s]
        if best_start is None or nest.starts[s] > best_start:
            best, best_start = nest.items[s][2], nest.starts[s]
    return best, names


def _idle_before(gaps: List[Tuple[float, float]], starts: List[float],
                 prefix: List[float], t: float) -> float:
    """The idle seconds of ``gaps`` before time ``t``."""
    k = bisect_right(starts, t)
    if k == 0:
        return 0.0
    a, b = gaps[k - 1]
    return prefix[k - 1] + max(0.0, min(t, b) - a)


def reduce(device: Sequence[Device], host: Sequence[Host]) -> Optional[Dict]:
    """The span reduction over the window (the benchmark's
    ``bench.window`` span among ``host``); None without a window or device
    operations inside it.  Times in seconds on one clock."""
    win = [(h[0], h[1]) for h in host if h[2] == trace.WINDOW]
    if not win:
        return None
    w0, w1 = win[0]
    inside = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in device
              if b > w0 and a < w1]
    if not inside:
        return None
    corr = {c for _, _, _, c in inside}

    per_thread: Dict[int, list] = defaultdict(list)
    forward: Dict[Tuple[int, int], float] = {}
    launches: Dict[int, Tuple[float, int]] = {}
    bench: list = []
    spans: List[Tuple[float, float, str]] = []
    for a, b, name, tid, c, seq, ftid in sorted(host):
        if name.startswith(PREFIX):
            per_thread[tid].append((a, b, name, _SPAN))
            spans.append((a, b, name))
        elif name.startswith(BACKWARD):
            per_thread[tid].append((a, b, (ftid, seq), _EVAL))
        elif name.startswith("bench."):
            if name != trace.WINDOW:
                bench.append((a, b, name, _SPAN))
        elif name.startswith("cu"):
            if c in corr:
                launches[c] = (a, tid)
        elif seq >= 0 and ftid == 0:
            # the last operation of a sequence number made its node
            forward[(tid, seq)] = a
    nests = {tid: _Nest(items) for tid, items in per_thread.items()}
    bench_nest = _Nest(bench)

    def span_at(tid: int, t: float) -> Optional[str]:
        nest = nests.get(tid)
        if nest is None:
            return None
        i = nest.innermost(t)
        s = nest.span_up[i] if i >= 0 else -1
        return nest.items[s][2] if s >= 0 else None

    def owner(tid: int, t: float) -> Tuple[Optional[str], frozenset]:
        found: Optional[str] = None
        nest = nests.get(tid)
        i = nest.innermost(t) if nest is not None else -1
        if i >= 0:
            name, kind = nest.items[i][2], nest.items[i][3]
            if kind is _SPAN:
                found = name
            elif name in forward:
                found = span_at(name[0], forward[name])
        anywhere, names = _any_thread(nests, t)
        found = found or anywhere
        return found, (names | {found}) if found else names

    stats: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"own_s": 0.0, "incl_s": 0.0, "launches": 0,
                 "incl_launches": 0, "calls": 0, "host_s": 0.0,
                 "idle_s": 0.0, "wait_s": 0.0})
    link: Dict[int, Tuple[Optional[str], frozenset]] = {}
    n_launches = 0
    for c, (t, tid) in launches.items():
        own, names = link[c] = owner(tid, t)
        if not w0 <= t <= w1:
            continue
        n_launches += 1
        if own is not None:
            stats[own]["launches"] += 1
        for n in names:
            stats[n]["incl_launches"] += 1
    total = unowned = 0.0
    unowned_at: Dict[str, float] = defaultdict(float)
    for a, b, _, c in inside:
        dt = b - a
        total += dt
        own, names = link.get(c, (None, frozenset()))
        if own is None:
            unowned += dt
            t = launches[c][0] if c in launches else a
            i = bench_nest.innermost(t)
            unowned_at[bench_nest.items[i][2] if i >= 0 else "host"] += dt
            continue
        stats[own]["own_s"] += dt
        for n in names:
            stats[n]["incl_s"] += dt

    busy = trace.merge([(a, b) for a, b, _, _ in inside])
    gaps = trace.gaps(busy, (w0, w1))
    g_starts = [a for a, _ in gaps]
    prefix = [0.0]
    for a, b in gaps:
        prefix.append(prefix[-1] + b - a)
    for a, b, name in spans:
        if w0 <= a <= w1:
            stats[name]["calls"] += 1
            stats[name]["host_s"] += min(b, w1) - a
        stats[name]["idle_s"] += (_idle_before(gaps, g_starts, prefix, b)
                                  - _idle_before(gaps, g_starts, prefix, a))

    # the operation that ends a gap: the device waited for its launch
    ends = sorted(((a, link.get(c, (None,))[0]) for a, _, _, c in inside),
                  key=lambda x: x[0])
    end_at = [a for a, _ in ends]
    unowned_wait = 0.0
    labelled = []
    by_label: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        k = bisect_left(end_at, b)
        if k < len(ends):
            if ends[k][1] is None:
                unowned_wait += b - a
            else:
                stats[ends[k][1]]["wait_s"] += b - a
        mid = (a + b) / 2
        lab, _ = _any_thread(nests, mid)
        if lab is None:
            i = bench_nest.innermost(mid)
            lab = bench_nest.items[i][2] if i >= 0 else "host"
        labelled.append((lab, b - a, a - w0))
        by_label[lab] += b - a
    labelled.sort(key=lambda x: -x[1])
    return {"window_s": w1 - w0,
            "device_s": total,
            "unowned_s": unowned,
            "unowned_at": dict(unowned_at),
            "unowned_wait_s": unowned_wait,
            "launches": n_launches,
            "spans": {n: dict(v) for n, v in sorted(stats.items())},
            "idle_gaps": [[n, s] for n, s, _ in labelled[:trace.TOP]],
            "long_gaps": [[n, s, at] for n, s, at in labelled
                          if s >= LONG_GAP_S],
            "idle_by_label": dict(by_label)}


def take(ev, name: str, cuda: bool, device: List[Device],
         host: List[Host]) -> None:
    """Keep one raw profiler event for ``reduce``: every device operation
    but user annotations (a user-scope span's mirror on the device's
    timeline), and the host events that the link reads."""
    if cuda:
        if not ev.is_user_annotation():
            device.append((ev.start_ns() * 1e-9, ev.end_ns() * 1e-9, name,
                           ev.correlation_id()))
    elif name.startswith(_KEEP) or ev.sequence_nr() >= 0:
        host.append((ev.start_ns() * 1e-9, ev.end_ns() * 1e-9, name,
                     ev.start_thread_id(), ev.correlation_id(),
                     ev.sequence_nr(), ev.fwd_thread_id()))


def from_profiler(prof) -> Optional[Dict]:
    """``reduce`` over a finished ``torch.profiler.profile``, read from its
    raw events."""
    from torch.autograd import DeviceType
    device: List[Device] = []
    host: List[Host] = []
    for ev in prof.profiler.kineto_results.events():
        take(ev, ev.name(), ev.device_type() == DeviceType.CUDA, device,
             host)
    return reduce(device, host)


def per_round(ctx: Dict, names: Sequence[str], field: str
              ) -> Optional[float]:
    """A traced run's ``field`` summed over the spans ``names`` (without
    the prefix), per round of the window: None without the span
    reduction, or where none of the spans ran in it."""
    red = (ctx.get("trace") or {}).get("spans")
    if not red:
        return None
    hits = [red["spans"][PREFIX + n][field] for n in names
            if PREFIX + n in red["spans"]]
    if not hits:
        return None
    return sum(hits) / ctx["rounds"]
