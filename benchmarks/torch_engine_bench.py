"""SelectionEngine backends through the PyTorch port: exact (stable-sort
index policies and one ``aou_merge`` launch) against threshold (sampled
quantiles and one fused ``fairk_update`` launch) across model sizes — the
twin of ``benchmarks/engine_bench.py``, same sizes and inputs.

Times are medians of single calls, CUDA events on the card (the host
clock on the CPU).  Writes ``benchmarks/artifacts/torch_engine_bench.json``.

  PYTHONPATH=src python -m benchmarks.torch_engine_bench [--full]
      [--device cpu]

fast: d in {1e5, 1e6, 1e7};  --full adds 1e8.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_packed_bench import timed_med  # noqa: E402
from repro_torch.core.engine import (EngineConfig,  # noqa: E402
                                     SelectionEngine)
from repro_torch.device import DeviceLike, resolve_device  # noqa: E402

FAST_SIZES = (100_000, 1_000_000, 10_000_000)
FULL_SIZES = FAST_SIZES + (100_000_000,)


def inputs(d: int, device):
    """(g, g_prev, age) of the reference bench: seeded by ``d % 7919``."""
    rng = np.random.default_rng(d % 7919)
    g = rng.standard_normal(d).astype("f4")
    g_prev = rng.standard_normal(d).astype("f4")
    age = rng.integers(0, 40, d).astype("f4")
    return tuple(torch.from_numpy(a).to(device) for a in (g, g_prev, age))


def bench_one(d: int, rho: float = 0.1, k_m_frac: float = 0.75,
              device: DeviceLike = None, repeats: int = 5):
    dev = resolve_device(device)
    g, g_prev, age = inputs(d, dev)
    res = {"d": d, "rho": rho, "k_m_frac": k_m_frac}
    for backend in ("exact", "threshold"):
        eng = SelectionEngine(EngineConfig(policy="fairk", backend=backend,
                                           rho=rho, k_m_frac=k_m_frac), d)
        us, (g_t, age_next, stats) = timed_med(
            lambda e=eng: e.select_and_merge(g, g_prev, age), repeats)
        res[backend + "_us"] = us
        res[backend + "_gbps"] = 5 * 4 * d / (us * 1e-6) / 1e9  # 3 in, 2 out
        res[backend + "_n_selected"] = float(stats["n_selected"])
    res["speedup_threshold"] = res["exact_us"] / res["threshold_us"]
    return res


def run(fast: bool = True, device: DeviceLike = None, repeats: int = 5):
    sizes = FAST_SIZES if fast else FULL_SIZES
    resolve_device(device)
    rows, per_size = [], []
    for d in sizes:
        r = bench_one(d, device=device, repeats=repeats)
        per_size.append(r)
        tag = f"{d:.0e}".replace("+0", "")
        rows.append((f"torch_engine/exact_d{tag}", r["exact_us"],
                     f"gbps={r['exact_gbps']:.2f}"))
        rows.append((f"torch_engine/threshold_d{tag}", r["threshold_us"],
                     f"speedup={r['speedup_threshold']:.2f}x"))
    detail = {"sizes": per_size,
              "note": "threshold = sampled-quantile theta + one fused "
                      "fairk_update launch; exact = stable-sort FAIR-k "
                      "indices + one aou_merge launch"}
    out_dir = os.path.join(os.path.dirname(__file__), "artifacts")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "torch_engine_bench.json"), "w") as f:
        json.dump(detail, f, indent=1)
    return rows, detail


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    rows, detail = run(fast=not args.full, device=args.device)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    print(json.dumps(detail["sizes"], indent=1))


if __name__ == "__main__":
    main()
