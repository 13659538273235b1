"""Fig. 4 — test accuracy vs communication rounds for FAIR-k and the
baselines (Top-k, AgeTop-k, TopRand), plus Round-Robin for reference,
through the PyTorch port (the twin of ``benchmarks/fig4_convergence.py``).

Two synthetic regimes exercise both ends of the magnitude/freshness
trade-off: the sparse-signal classification task (freshness matters;
Top-k collapses) and a power-law-curvature regression (magnitude matters;
Round-Robin diverges).  FAIR-k is the only policy that is strong in
both — the paper's robustness claim."""

import time

import numpy as np
import torch

from benchmarks.torch_common import make_task, run_policy
from repro_torch.core.oac import ChannelConfig
from repro_torch.device import resolve_device
from repro_torch.fl import FLConfig, train

POLICIES = ("fairk", "topk", "agetopk", "toprand", "roundrobin")


def _powerlaw_regression(policies, rounds, device, n_clients=16,
                         d_feat=1500):
    rng = np.random.default_rng(0)
    scales = (np.arange(1, d_feat + 1) ** -0.8).astype(np.float32)
    w_star = rng.normal(size=d_feat).astype(np.float32)
    data = []
    for _ in range(n_clients):
        X = rng.normal(size=(80, d_feat)).astype(np.float32) * scales
        data.append((X, X @ w_star + 0.05 * rng.normal(size=80).astype("f4")))
    Xte = rng.normal(size=(400, d_feat)).astype(np.float32) * scales
    yte = Xte @ w_star
    params0 = {"w": torch.zeros(d_feat, dtype=torch.float32, device=device)}

    def loss_fn(p, x, y):
        return torch.mean((x @ p["w"] - y) ** 2)

    def eval_fn(p):
        resid = Xte @ p["w"].detach().cpu().numpy() - yte
        return {"acc": 1.0 - float(np.mean(resid**2) / np.mean(yte**2))}

    def sample_round(t):
        r = np.random.default_rng(300 + t)
        idx = r.integers(0, 80, (n_clients, 5, 20))
        xs = np.stack([data[i][0][idx[i]] for i in range(n_clients)])
        ys = np.stack([data[i][1][idx[i]] for i in range(n_clients)])
        return xs, ys

    out = {}
    for policy in policies:
        fl = FLConfig(n_clients=n_clients, local_steps=5, batch_size=20,
                      rounds=rounds, policy=policy, compression_ratio=0.05,
                      local_lr=0.02, global_lr=0.02,
                      channel=ChannelConfig(fading="rayleigh", mean=1.0,
                                            noise_std=0.05))
        h = train(fl, params0, loss_fn, sample_round, eval_fn=eval_fn,
                  eval_every=rounds, device=device)
        out[policy] = h["acc"][-1]
    return out


def run(fast: bool = True, device=None, rounds=None):
    """``rounds`` cuts the rounds of both regimes (fast 120, full 600; the
    regression runs at most 200)."""
    dev = resolve_device(device)
    if rounds is None:
        rounds = 120 if fast else 600
    task = make_task(fast=fast, device=dev)
    rows, detail = [], {"classification": {}, "powerlaw_r2": {}}
    for policy in POLICIES:
        t0 = time.perf_counter()
        h = run_policy(task, policy, rounds, eval_every=max(rounds // 4, 1))
        us = (time.perf_counter() - t0) / rounds * 1e6
        detail["classification"][policy] = {"rounds": h["round"],
                                            "acc": h["acc"],
                                            "round_ms": h["round_ms"]}
        rows.append((f"fig4/classification/{policy}", us,
                     f"acc={h['acc'][-1]:.3f}"))
    r2 = _powerlaw_regression(POLICIES, min(rounds, 200), dev)
    detail["powerlaw_r2"] = r2
    for policy, v in r2.items():
        rows.append((f"fig4/powerlaw/{policy}", 0.0,
                     f"R2={max(v, -9.99):.3f}"))
    return rows, detail
