"""Beyond-paper extension through the PyTorch port (the twin of
``benchmarks/ext_fairk_auto.py``): FAIR-k-auto adapts the magnitude share
k_M/k online (``core/controller.py``), against fixed splits of 0.75 and
0.25, on the exact backend.

The split rides as controller state on the device through the round: no
host sync, one round function for every split.  The port's initial
weights and draws differ from the reference's, so only the orderings and
the direction of the split's path compare."""

import time

from benchmarks.torch_common import PAPER_CHANNEL, make_task
from repro_torch.fl import FLConfig, train

RUNS = (("fairk", 0.75), ("fairk", 0.25), ("fairk_auto", 0.5))


def run(fast: bool = True, device=None, rounds=None):
    """``rounds`` cuts the rounds (fast 120, full 400)."""
    if rounds is None:
        rounds = 120 if fast else 400
    task = make_task(fast=fast, device=device)
    rows, detail = [], {}
    for policy, kmf in RUNS:
        fl = FLConfig(n_clients=task.n_clients, local_steps=5, batch_size=20,
                      local_lr=0.05, global_lr=0.05, rounds=rounds,
                      policy=policy, k_m_frac=kmf, compression_ratio=0.1,
                      channel=PAPER_CHANNEL)
        t0 = time.perf_counter()
        h = train(fl, task.params0, task.loss_fn,
                  lambda t: task.sample_round(t), eval_fn=task.eval_fn,
                  eval_every=rounds, device=task.device)
        us = (time.perf_counter() - t0) / rounds * 1e6
        tag = f"{policy}_km{kmf}"
        km = h.get("km_frac", [])
        path = {"start": round(km[0], 3), "end": round(km[-1], 3),
                "min": round(min(km), 3), "max": round(max(km), 3)}
        detail[tag] = {"acc": h["acc"][-1], "km_path": path}
        rows.append((f"ext/fairk_auto/{tag}", us,
                     f"acc={h['acc'][-1]:.3f};"
                     f"km={path['start']}->{path['end']}"))
    return rows, detail
