#!/usr/bin/env python3
"""One benchmark cell's rounds traced to the port's spans, on the card.

    python3 tools/torch_trace_cell.py --workload <cell> --seed <n> \\
        [--seconds 30] [--out FILE.json]

Builds the cell as ``bench/run.py`` does (weights and inputs drawn from
the seed, the followed rounds as set-up), then runs one window without a
profiler and one under ``torch.profiler`` (CPU and CUDA activity), and
prints per round of the traced window: the round's milliseconds in both
windows (what tracing costs when on), the benchmark's trace summary
(``bench/harness/trace.py``: ``idle_pct``, the device operations), and the
span reduction (``bench/harness/spans.py``): each ``repro_torch.*``
span's own and inclusive device milliseconds, idle milliseconds (under
the span, and waiting for its launches), host milliseconds, launches and
calls, the idle gaps of 20 ms or more with their labels, and
the device time no span owns.  ``--out`` keeps all of it as JSON.  No
comparison with the reference is made."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the benchmark's build and kernel caches, inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(
    ROOT / "build" / "bench_cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(
    ROOT / "build" / "bench_cache" / "triton"))
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def trace_cell(workload: str, seed: int, seconds: float, root=ROOT,
               device=None):
    """The cell's two windows and their readings (a dict).  ``device``
    None means the card, which must be there."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bench.harness import cells, spans, trace
    from bench.harness.registry import Registry

    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA card")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    reg = Registry(root)
    entry = reg.cell(workload)
    wl = reg.workload(workload, entry["traffic"])
    cell = cells.Cell(reg.config(entry["config"]), wl, seed, device)
    t0 = time.perf_counter()
    cell.first_rounds()
    cells._sync(device)
    setup_s = time.perf_counter() - t0
    plain = cell.window(seconds)
    cell.marks.clear()
    cell.losses.clear()
    cell.traced = True
    with profile(activities=acts) as prof:
        traced = cell.window(seconds)
    cell.traced = False
    t1 = time.perf_counter()
    summary = trace.from_profiler(prof)
    reduced = spans.from_profiler(prof)
    reduce_s = time.perf_counter() - t1
    rounds = traced["rounds"]
    out = {"workload": workload, "seed": seed, "card": _card(),
           "torch": torch.__version__, "setup_s": setup_s,
           "reduce_s": reduce_s,
           "untraced": {"rounds": plain["rounds"],
                        "round_ms": 1e3 * plain["window_s"] / plain["rounds"]},
           "traced": {"rounds": rounds,
                      "round_ms": 1e3 * traced["window_s"] / rounds},
           "grads_ms": (sum(traced["grads_ms"]) / rounds
                        if "grads_ms" in traced else None),
           "update_ms": sum(traced["update_ms"]) / rounds,
           "trace": summary and {k: summary[k] for k in
                                 ("window_s", "busy_s", "device_ops",
                                  "idle_gaps")},
           "spans": reduced}
    cell.close()
    return out


def report(out) -> str:
    """The per-round table of a ``trace_cell`` result."""
    r = out["traced"]["rounds"]
    sp = out["spans"] or {}
    lines = [f"{out['workload']} seed {out['seed']} on {out['card']}: "
             f"round_ms untraced {out['untraced']['round_ms']:.2f} "
             f"({out['untraced']['rounds']} rounds), traced "
             f"{out['traced']['round_ms']:.2f} ({r} rounds); grads_ms "
             f"{out['grads_ms']}, update_ms {out['update_ms']:.3f}"]
    tr = out["trace"]
    if tr:
        idle = 100 * (1 - tr["busy_s"] / tr["window_s"])
        lines.append(f"idle_pct {idle:.3f}")
    if not sp:
        return "\n".join(lines + ["no span reduction"])
    at = {k: round(1e3 * v / r, 3) for k, v in sp["unowned_at"].items()}
    lines.append(f"device ms/round {1e3 * sp['device_s'] / r:.3f}, unowned "
                 f"{1e3 * sp['unowned_s'] / r:.3f} {at}, launches/round "
                 f"{sp['launches'] / r:.1f}")
    lines.append(f"{'span':32s} {'own ms':>10s} {'incl ms':>10s} "
                 f"{'idle ms':>9s} {'wait ms':>9s} {'host ms':>10s} "
                 f"{'launch':>8s} {'incl l.':>8s} {'calls':>7s}")
    for name, v in sorted(sp["spans"].items(), key=lambda x: -x[1]["incl_s"]):
        lines.append(f"{name:32s} {1e3 * v['own_s'] / r:10.3f} "
                     f"{1e3 * v['incl_s'] / r:10.3f} "
                     f"{1e3 * v['idle_s'] / r:9.3f} "
                     f"{1e3 * v['wait_s'] / r:9.3f} "
                     f"{1e3 * v['host_s'] / r:10.3f} "
                     f"{v['launches'] / r:8.1f} {v['incl_launches'] / r:8.1f} "
                     f"{v['calls'] / r:7.2f}")
    lines.append("idle by label (ms/round): " + ", ".join(
        f"{k} {1e3 * v / r:.3f}" for k, v in
        sorted(sp["idle_by_label"].items(), key=lambda x: -x[1])[:12]))
    lines.append("gaps >= 20 ms: " + ", ".join(
        f"{lab} {1e3 * s:.1f} ms at {at:.3f} s" for lab, s, at in
        sp["long_gaps"]))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    out = trace_cell(args.workload, args.seed, args.seconds)
    print(report(out), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
