"""Beyond-paper extension through the PyTorch port (the twin of
``benchmarks/ext_error_feedback.py``): error feedback (EF-SGD, Stich et
al. 2018) on the unsent gradient mass, composed with the selection
policies, on the exact backend.

The reference's finding: EF is complementary to FAIR-k (+2-3 accuracy
points) but cannot rescue Top-k — EF fixes what is sent, not what is
selected.  The port's initial weights and draws differ from the
reference's, so only the orderings compare."""

import time

from benchmarks.torch_common import PAPER_CHANNEL, make_task
from repro_torch.fl import FLConfig, train

POLICIES = ("fairk", "topk", "toprand")


def run(fast: bool = True, device=None, rounds=None):
    """``rounds`` cuts the rounds (fast 120, full 400)."""
    if rounds is None:
        rounds = 120 if fast else 400
    task = make_task(fast=fast, device=device)
    rows, detail = [], {}
    for policy in POLICIES:
        for ef in (False, True):
            fl = FLConfig(n_clients=task.n_clients, local_steps=5,
                          batch_size=20, local_lr=0.05, global_lr=0.05,
                          rounds=rounds, policy=policy,
                          compression_ratio=0.1, error_feedback=ef,
                          channel=PAPER_CHANNEL)
            t0 = time.perf_counter()
            h = train(fl, task.params0, task.loss_fn,
                      lambda t: task.sample_round(t),
                      eval_fn=task.eval_fn, eval_every=rounds,
                      device=task.device)
            us = (time.perf_counter() - t0) / rounds * 1e6
            tag = f"{policy}{'+ef' if ef else ''}"
            detail[tag] = h["acc"][-1]
            rows.append((f"ext/error_feedback/{tag}", us,
                         f"acc={h['acc'][-1]:.3f}"))
    return rows, detail
