"""Fig. 6 — FAIR-k quality vs the magnitude share k_M/k, through the
port's batched sweep (``repro_torch.fl.sweep``; the twin of
``benchmarks/fig6_km_ratio.py``).

k_M/k = 1 is Top-k, k_M/k = 0 is Round-Robin; the paper's claim is a wide
stable plateau.  Every ratio × every seed runs as one (lanes, d) program,
beside ``fairk_auto`` lanes whose budget controller picks its own split
per round from every initial ratio.  The claim is relative: interior
ratios must not be worse than the endpoints, and the adaptive curve must
land on the plateau, by final loss on the heterogeneous-quadratic
scenario."""

import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fl.sweep import SweepConfig, run_sweep

RATIOS = (0.0, 0.25, 0.5, 0.75, 1.0)


def run(fast: bool = True, device=None, rounds=None):
    """``rounds`` cuts the rounds (fast 120, full 600)."""
    dev = resolve_device(device)
    if rounds is None:
        rounds = 120 if fast else 600
    n_seeds = 4 if fast else 8
    cfg = SweepConfig(d=2048, n_clients=16, rho=0.2, rounds=rounds)
    t0 = time.perf_counter()
    out = run_sweep(cfg, policies=("fairk", "fairk_auto"),
                    k_m_fracs=RATIOS, n_seeds=n_seeds, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    total_us = (time.perf_counter() - t0) * 1e6
    finals, adaptive, km_final = {}, [], []
    for i, (pol, frac, _) in enumerate(out["labels"]):
        if pol == "fairk_auto":
            adaptive.append(float(out["loss"][i, -1]))
            km_final.append(float(out["km_frac"][i, -1]))
        else:
            finals.setdefault(frac, []).append(float(out["loss"][i, -1]))
    n_grid = len(out["labels"])
    rows, detail = [], {"rounds": rounds, "n_seeds": n_seeds,
                        "grid_points": n_grid,
                        "grid_total_us": total_us}
    for frac in sorted(finals):
        loss = float(np.mean(finals[frac]))
        detail[str(frac)] = loss
        rows.append((f"fig6/km_ratio_{frac:.2f}", total_us / n_grid,
                     f"loss={loss:.4f}"))
    loss_ad = float(np.mean(adaptive))
    detail["adaptive"] = {"loss": loss_ad,
                          "km_final": float(np.mean(km_final))}
    rows.append(("fig6/km_adaptive", total_us / n_grid,
                 f"loss={loss_ad:.4f};km_final={np.mean(km_final):.2f}"))
    return rows, detail
