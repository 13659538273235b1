#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process: the
program's first rounds against the reference on each of ``--seeds``
(the lower readings), the control — the reference put in the program's
place in the next lower precision — on each of ``--control-seeds``, and
the program with a fault planted (``--faults``) on each of
``--fault-seeds`` (the upper readings).  No window is measured.  One JSON
line per reading on standard output.  ``--dump-rms`` instead prints, for
a train cell and each of ``--seeds``, the RMS of every leaf of the
reference's first-round gradient (per layer for stacked leaves): the
table an update cell's traffic draws its gradients at.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --control float8_e4m3fn \
        --faults half_batch,altered --fault-seeds 7,8,9
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None, root=ROOT, device=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--control", default="float8_e4m3fn")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--dump-rms", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from bench.harness import cells, compare, faults
    from bench.harness.registry import Registry
    from bench.reference.follow import first_gradient, follow

    reg = Registry(root)
    entry = reg.cell(args.workload)
    wl = reg.workload(args.workload, entry["traffic"])
    config = reg.config(entry["config"])
    if device is None:
        device = torch.device("cuda", 0)

    def program(seed, fault=None):
        cell = cells.Cell(config, wl, seed, device)
        if fault:
            faults.plant(cell, fault)
        out = cell.first_rounds()
        cell.close()
        return out

    def emit(kind, seed, prog, **extra):
        t = time.perf_counter()
        ref = follow(config, wl, seed, device)
        vals = compare.numbers(prog, ref)
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, **extra, "numbers": vals,
                          "loss": prog["loss"], "ref_loss": ref["loss"],
                          "carried": {k: float(v) for k, v in
                                      prog["carried"].items()},
                          "ref_carried": {k: float(v) for k, v in
                                          ref["carried"].items()},
                          "ref_warm_rounds": ref["warm_rounds"],
                          "widest_leaves": {k: compare.leaf_gaps(prog, ref, k)
                                            for k in ("m1", "change")},
                          "widest_state": sorted(
                              compare.state_gaps(prog, ref, True),
                              key=lambda x: -x[1])[:5],
                          "ref_s": time.perf_counter() - t}), flush=True)

    if args.dump_rms:
        for s in args.seeds:
            paths, grads = first_gradient(config, wl, s, device)
            rms = {}
            for path, g in zip(paths, grads):
                if path.startswith("blocks/"):
                    rms[path] = g.reshape(g.shape[0], -1).pow(2).mean(
                        1).sqrt().tolist()
                else:
                    rms[path] = float(g.pow(2).mean().sqrt())
            print(json.dumps({"workload": args.workload, "seed": s,
                              "rms": rms}), flush=True)
        return 0
    for s in args.seeds:
        emit("program", s, program(s))
    for s in args.control_seeds:
        emit("control", s, follow(config, wl, s, device, prec=args.control),
             precision=args.control)
    for f in [f for f in args.faults.split(",") if f]:
        for s in args.fault_seeds:
            emit("fault", s, program(s, f), fault=f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
