"""Benchmark-regression gate for the PyTorch port (the twin of
``tools/check_bench_regression.py``).

Structural part: the counters of ``benchmarks.torch_client_bench --smoke``
and ``benchmarks.torch_packed_bench --smoke`` (their artifacts under
``benchmarks/artifacts/``) must equal their stated values, under the
names the reference's gate uses: one streaming client fold per round, no
live (N, d) client matrix with C < N and one read of g on the packed FL
round; one read of g, one fused launch and (1 pack, 1 unpack) per fused,
adaptive, async, sanitize, chaos and channel round, 3 reads on the
persisted legacy round.  A counter that is missing fails, as does a
missing artifact.

Ratio part: the same-card ratios of a full ``torch_client_bench`` run on
the card (``benchmarks/artifacts/torch_client_bench.json``) must stay
within the tolerance of the committed baseline
``benchmarks/BENCH_torch_clients.json``.  The baseline holds the median
of each ratio over at least 3 full runs on one card, the runs
themselves, each ratio's spread (the largest relative deviation of a run
from the median), the tolerance (twice the largest spread, rounded up to
5 points, at least 15%; ``--tol`` overrides it) and the card's name and
power limit.  Ratios, not times, are compared, because two runs rarely
share a card and its power limit.  A missing baseline, artifact or ratio
fails; ``--structural-only`` skips the ratio part and says so (the CPU
has no rates).  ``--make-baseline RUN.json ...`` writes the baseline from
full runs' artifacts.

  # on the CPU: the structural part
  PYTHONPATH=src python -m benchmarks.torch_client_bench --smoke --device cpu
  PYTHONPATH=src python -m benchmarks.torch_packed_bench --smoke --device cpu
  python tools/torch_check_bench_regression.py --structural-only
  # on the card: both smokes, a full client run, then both parts
  PYTHONPATH=src python -m benchmarks.torch_client_bench --smoke
  PYTHONPATH=src python -m benchmarks.torch_packed_bench --smoke
  PYTHONPATH=src python -m benchmarks.torch_client_bench
  python tools/torch_check_bench_regression.py
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "benchmarks", "artifacts")
CLIENT_SMOKE = os.path.join(ARTIFACTS, "torch_client_bench_smoke.json")
PACKED_SMOKE = os.path.join(ARTIFACTS, "torch_packed_bench_smoke.json")
CLIENT_FULL = os.path.join(ARTIFACTS, "torch_client_bench.json")
BASELINE = os.path.join(ROOT, "benchmarks", "BENCH_torch_clients.json")

# the streaming client aggregation: exact values
STRUCTURAL_CLIENTS = {
    "client_stream_passes": 1,
    "client_nd_live": 0,
    "g_reads_fl_packed": 1,
}

# the packed server phase on the tree: exact values (the reference gate's
# names; its ``adaptive_traces`` counts XLA compilations, which the port
# does not have)
STRUCTURAL_PACKED = {
    "g_reads_fused_stats": 1,
    "g_reads_persisted": 3,
    "fused_calls_packed": 1,
    "copies_fused_stats": [1, 1],
    "copies_persisted": [1, 1],
    "g_reads_adaptive": 1,
    "copies_adaptive": [1, 1],
    "g_reads_async": 1,
    "copies_async": [1, 1],
    "fused_calls_async": 1,
    "g_reads_sanitize": 1,
    "copies_sanitize": [1, 1],
    "fused_calls_sanitize": 1,
    "g_reads_chaos": 1,
    "copies_chaos": [1, 1],
    "fused_calls_chaos": 1,
    "g_reads_channel": 1,
    "copies_channel": [1, 1],
    "fused_calls_channel": 1,
}

# same-card ratios of the full client bench (higher = better): the chunked
# round's clients per second against the dense fold's, and the dense
# fold's peak bytes against the chunked round's
GUARDED_RATIOS = ("clients_per_s_8_vs_512", "peak_dense_vs_8")
MIN_BASELINE_RUNS = 3
MIN_TOL = 0.15


def structural(path: str, want: dict, label: str) -> list:
    """Failures of the counters ``want`` in the artifact at ``path``."""
    if not os.path.exists(path):
        return [f"STRUCTURAL ({label}): no artifact at {path}"]
    with open(path) as f:
        cur = json.load(f)
    failures = []
    for key, val in want.items():
        got = cur.get(key)
        ok = (got is not None and list(got) == val
              if isinstance(val, list) else got is not None and got == val)
        if not ok:
            failures.append(f"STRUCTURAL ({label}) {key}: expected {val}, "
                            f"got {got}")
    return failures


def make_baseline(runs: list, card: str) -> dict:
    """The baseline from full runs' artifacts (dicts): each guarded
    ratio's median, the runs, each ratio's spread and the tolerance."""
    if len(runs) < MIN_BASELINE_RUNS:
        raise ValueError(f"a baseline needs at least {MIN_BASELINE_RUNS} "
                         f"runs, got {len(runs)}")
    base = {"card": card,
            "source": "tools/torch_check_bench_regression.py "
                      "--make-baseline over full runs of "
                      "benchmarks.torch_client_bench, one process each",
            "n_runs": len(runs),
            "runs": [{key: run[key] for key in
                      GUARDED_RATIOS + ("clients_per_s",
                                        "peak_client_bytes")}
                     for run in runs],
            "spread": {}}
    for key in ("n_clients", "d") + tuple(STRUCTURAL_CLIENTS):
        values = {run[key] for run in runs}
        if len(values) != 1:
            raise ValueError(f"the runs disagree on {key}: {values}")
        base[key] = values.pop()
    for key in GUARDED_RATIOS:
        values = [run[key] for run in runs]
        base[key] = statistics.median(values)
        base["spread"][key] = max(abs(v / base[key] - 1.0) for v in values)
    base["tol"] = max(MIN_TOL, math.ceil(
        2 * max(base["spread"].values()) / 0.05 - 1e-9) * 0.05)
    return base


def ratios(artifact: str, baseline: str, tol) -> list:
    """Failures of the guarded ratios against the baseline; ``tol`` None
    takes the baseline's own tolerance."""
    if not os.path.exists(baseline):
        return [f"RATIO: no baseline at {baseline} — the ratio part "
                f"cannot pass"]
    if not os.path.exists(artifact):
        return [f"RATIO: no full client-bench artifact at {artifact} "
                f"(run benchmarks.torch_client_bench on the card)"]
    with open(artifact) as f:
        cur = json.load(f)
    with open(baseline) as f:
        base = json.load(f)
    if tol is None:
        tol = base.get("tol", MIN_TOL)
    failures = []
    for key in GUARDED_RATIOS:
        b, c = base.get(key), cur.get(key)
        if b is None or c is None:
            failures.append(f"RATIO {key}: missing (baseline={b}, "
                            f"current={c})")
            continue
        floor = b * (1.0 - tol)
        status = "OK" if c >= floor else "REGRESSED"
        print(f"[torch-bench-regression] {key}: current={c:.4f} "
              f"baseline={b:.4f} floor={floor:.4f} {status}")
        if c < floor:
            failures.append(f"RATIO {key}: {c:.4f} < {floor:.4f} "
                            f"(baseline {b:.4f} - {tol:.0%})")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tol", type=float, default=None,
                    help="allowed relative regression of each guarded "
                         "ratio (default: the baseline's own)")
    ap.add_argument("--client-artifact", default=CLIENT_SMOKE)
    ap.add_argument("--packed-artifact", default=PACKED_SMOKE)
    ap.add_argument("--full-artifact", default=CLIENT_FULL)
    ap.add_argument("--baseline", default=BASELINE)
    ap.add_argument("--structural-only", action="store_true",
                    help="skip the ratio part (it needs a card run)")
    ap.add_argument("--make-baseline", nargs="+", metavar="RUN",
                    help="write --baseline from these full runs' "
                         "artifacts and exit")
    ap.add_argument("--card", default=None,
                    help="with --make-baseline: the card's nvidia-smi "
                         "name and power limit")
    args = ap.parse_args(argv)
    if args.make_baseline:
        if not args.card:
            ap.error("--make-baseline needs --card")
        runs = []
        for path in args.make_baseline:
            with open(path) as f:
                runs.append(json.load(f))
        base = make_baseline(runs, args.card)
        with open(args.baseline, "w") as f:
            json.dump(base, f, indent=1)
        print(f"[torch-bench-regression] baseline of {len(runs)} runs -> "
              f"{args.baseline}: " + ", ".join(
                  f"{key} {base[key]:.6g} (spread {base['spread'][key]:.4f})"
                  for key in GUARDED_RATIOS) + f", tol {base['tol']:.2f}")
        return 0

    failures = (structural(args.client_artifact, STRUCTURAL_CLIENTS,
                           "clients")
                + structural(args.packed_artifact, STRUCTURAL_PACKED,
                             "packed"))
    if args.structural_only:
        print("[torch-bench-regression] ratio part skipped "
              "(--structural-only): no ratio was checked")
    else:
        failures += ratios(args.full_artifact, args.baseline, args.tol)
    if failures:
        print("\n[torch-bench-regression] FAILED:")
        for msg in failures:
            print("  -", msg)
        return 1
    print(f"[torch-bench-regression] OK: "
          f"{len(STRUCTURAL_CLIENTS) + len(STRUCTURAL_PACKED)} structural "
          f"counters intact"
          + ("" if args.structural_only else
             f", {len(GUARDED_RATIOS)} ratios within the baseline's "
             f"tolerance"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
