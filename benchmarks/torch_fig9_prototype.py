"""Fig. 9 — prototype path through the PyTorch port (the twin of
``benchmarks/fig9_prototype.py``): one-bit (sign + FSK majority vote)
transport at rho = 20%, FAIR-k vs baselines, on the EMNIST-like task
(26 classes)."""

import time

from benchmarks.torch_common import make_task, run_policy
from repro_torch.core.oac import ChannelConfig


def run(fast: bool = True, device=None, rounds=None):
    """``rounds`` cuts the rounds (fast 80, full 300)."""
    if rounds is None:
        rounds = 80 if fast else 300
    task = make_task(fast=fast, n_classes=26, model="mlp", device=device)
    channel = ChannelConfig(fading="none", mean=1.0, noise_std=2.0)
    rows, detail = [], {}
    for policy in ("fairk", "topk", "toprand"):
        t0 = time.perf_counter()
        h = run_policy(task, policy, rounds, rho=0.2, one_bit=True,
                       lr=0.003, channel=channel)
        us = (time.perf_counter() - t0) / rounds * 1e6
        detail[policy] = h["acc"][-1]
        rows.append((f"fig9/onebit/{policy}", us,
                     f"acc={h['acc'][-1]:.3f}"))
    return rows, detail
