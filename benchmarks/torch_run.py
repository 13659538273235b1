"""Run the paper's figures, Table I, the engine and packed server-phase
benchmarks and the population benchmark through the PyTorch port.

Prints ``name,us_per_call,derived`` CSV rows (stdout), in the format of
``benchmarks/run.py``, and writes the full detail payload to
``benchmarks/artifacts/torch_results.json``.  Runs on the card unless
``--device cpu`` is given.

  PYTHONPATH=src python -m benchmarks.torch_run [--full] [--only fig3,fig5]
      [--device cpu]
"""

import argparse
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import (torch_engine_bench,  # noqa: E402
                        torch_fig3_aou, torch_fig4_convergence,
                        torch_fig5_staleness, torch_fig6_km_ratio,
                        torch_fig7_local_epochs, torch_fig9_prototype,
                        torch_packed_bench, torch_population_bench,
                        torch_table1_lipschitz)

MODULES = {
    "fig3": torch_fig3_aou, "fig4": torch_fig4_convergence,
    "fig5": torch_fig5_staleness, "fig6": torch_fig6_km_ratio,
    "fig7": torch_fig7_local_epochs, "table1": torch_table1_lipschitz,
    "fig9": torch_fig9_prototype, "engine": torch_engine_bench,
    "packed": torch_packed_bench, "population": torch_population_bench,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale settings")
    ap.add_argument("--only", default="",
                    help="comma-separated subset of " + ",".join(MODULES))
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    selected = ([m.strip() for m in args.only.split(",") if m.strip()]
                or list(MODULES))
    unknown = [m for m in selected if m not in MODULES]
    if unknown:
        ap.error(f"unknown benchmark(s) {unknown}; choose from "
                 f"{list(MODULES)}")

    print("name,us_per_call,derived")
    details, failures = {}, []
    for name in selected:
        t0 = time.time()
        try:
            rows, detail = MODULES[name].run(fast=not args.full,
                                             device=args.device)
        except Exception as e:
            failures.append((name, repr(e)))
            traceback.print_exc()
            continue
        details[name] = detail
        for row in rows:
            print(f"{row[0]},{row[1]:.1f},{row[2]}", flush=True)
        print(f"# {name} done in {time.time()-t0:.1f}s", flush=True)

    out = os.path.join(os.path.dirname(__file__), "artifacts")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "torch_results.json"), "w") as f:
        json.dump(details, f, indent=1)
    if failures:
        print(f"# FAILURES: {failures}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
