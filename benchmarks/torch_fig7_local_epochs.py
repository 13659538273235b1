"""Fig. 7 — effect of the local-iteration count H through the PyTorch port
(the twin of ``benchmarks/fig7_local_epochs.py``): training still
converges at large H, and FAIR-k stays ahead of Top-k throughout."""

import time

from benchmarks.torch_common import make_task, run_policy


def run(fast: bool = True, device=None, rounds=None):
    """``rounds`` cuts the rounds (fast 80, full 400)."""
    if rounds is None:
        rounds = 80 if fast else 400
    hs = (1, 5, 10) if fast else (1, 5, 20)
    task = make_task(fast=fast, device=device)
    rows, detail = [], {}
    for h_steps in hs:
        for policy in ("fairk", "topk"):
            t0 = time.perf_counter()
            h = run_policy(task, policy, rounds, local_steps=h_steps)
            us = (time.perf_counter() - t0) / rounds * 1e6
            detail[f"H{h_steps}/{policy}"] = h["acc"][-1]
            rows.append((f"fig7/H{h_steps}/{policy}", us,
                         f"acc={h['acc'][-1]:.3f}"))
    return rows, detail
