#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Draws the cell's weights and inputs from ``--seed``, builds the port's
train step, drives it through its first rounds (set-up: the rounds the
reference follows, three or the traffic's ``rounds``), measures rounds
for ``--seconds`` (with ``--trace 1`` under the profiler), then frees
the port's state and holds those first rounds against the plain
reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``breakdown`` when traced) and ``checks``, each compared number beside
its limit; the same numbers are the last lines of standard error, after
two readings of the warm-corrected thresholds' use.  Exits 2 without a result when there
is no card or too few, and 3 when the process holds JAX, the JAX
package or its benchmarks."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the build and kernel caches live at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench_cache"
                                         / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench_cache"
                                     / "triton")
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def round_flops(config, wl):
    """A round's model FLOPs (``yardstick.model_flops``), counted by the
    configuration's reference module where it defines ``active_params``;
    None where neither it nor the yardstick counts the family."""
    from bench.harness import yardstick
    from bench.reference.follow import family
    tokens = wl.get("batch", 0) * wl.get("seq_len", 0)
    return yardstick.model_flops(
        config["model"], tokens,
        getattr(family(config), "active_params", None))


def run(args, root=ROOT, device=None, t0=T0):
    """The run's result (a dict) and the compared numbers' lines.
    ``device`` None means the card, which must be there."""
    import torch
    from bench.harness import cells, compare
    from bench.harness.registry import Registry
    from bench.reference.follow import follow

    reg = Registry(root)
    entry = reg.cell(args.workload)
    wl = reg.workload(args.workload, entry["traffic"])
    config = reg.config(entry["config"])
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < entry["chips"]):
            print(f"the cell needs {entry['chips']} CUDA card(s); found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            raise SystemExit(2)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    cell = cells.Cell(config, wl, args.seed, device)
    prog = cell.first_rounds()
    cells._sync(device)
    setup_s = time.perf_counter() - t0
    win = (cells.trace_window(cell, args.seconds) if args.trace
           else cell.window(args.seconds))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    ctx = dict(win, workload=wl, model=config["model"], setup_s=setup_s,
               d_packed=cell.d_packed, trace=win.get("trace"),
               flops_per_round=round_flops(config, wl))
    metrics = {}
    for m in reg.metrics(args.workload, bool(args.trace)):
        value = reg.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cell.close()
    del cell
    ref = follow(config, wl, args.seed, device)
    checks = compare.judge(compare.numbers(prog, ref), wl["limits"])
    result = {"correct": compare.passed(checks),
              "attempted": win["rounds"], "failed": win["failed"],
              "metrics": metrics, "device": dev}
    if args.trace:
        tr = win.get("trace") or {}
        dev.update(busy_s=tr.get("busy_s", 0.0),
                   window_s=tr.get("window_s", win["window_s"]))
        if tr:
            result["breakdown"] = {"device_ops": tr["device_ops"],
                                   "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    # the warm path's readings: its rounds among those the reference
    # follows, and the window's rounds that left it
    lines = [f"reading warm_rounds: {ref['warm_rounds']} of "
             f"{ref['rounds']} followed",
             f"reading window_stalls: {win['stalls']!r}"]
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
              for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    args = parse(argv)
    result, lines = run(args)
    found = forbidden_modules()
    if found:
        print(f"the process holds {found}: the benchmark may not load JAX, "
              f"the JAX package or its benchmarks", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
