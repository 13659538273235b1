"""Fig. 5 — staleness statistics through the PyTorch port (the twin of
``benchmarks/fig5_staleness.py``): (a) average AoU per round, (b)
per-entry participation frequency after the run."""

import time

import numpy as np

from benchmarks.torch_common import make_task, run_policy

POLICIES = ("fairk", "topk", "agetopk", "toprand", "roundrobin")


def run(fast: bool = True, device=None, rounds=None):
    """``rounds`` cuts the rounds (fast 100, full 300)."""
    if rounds is None:
        rounds = 100 if fast else 300
    task = make_task(fast=fast, device=device)
    rows, detail = [], {}
    for policy in POLICIES:
        t0 = time.perf_counter()
        h = run_policy(task, policy, rounds)
        us = (time.perf_counter() - t0) / rounds * 1e6
        tail = np.mean(h["mean_aou"][rounds // 2:])
        never = float((h["sel_count"] == 0).mean())
        gini_src = np.sort(h["sel_count"])
        lorenz = np.cumsum(gini_src) / max(gini_src.sum(), 1)
        gini = float(1 - 2 * lorenz.mean())
        detail[policy] = {"mean_aou_curve": h["mean_aou"],
                          "mean_aou_tail": float(tail),
                          "frac_never_selected": never,
                          "participation_gini": gini,
                          "round_ms": h["round_ms"]}
        rows.append((f"fig5/{policy}", us,
                     f"meanAoU={tail:.1f};never={never:.2f};gini={gini:.2f}"))
    return rows, detail
