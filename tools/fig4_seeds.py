"""Fig. 4's power-law regression task over several seeds, for one package
per process: the final R² of FAIR-k, TopRand and Top-k per seed, and the
mean and spread of each policy and of the FAIR-k minus TopRand gap.

The JAX script (``benchmarks/fig4_convergence.py``) and the port's
(``benchmarks/torch_fig4_convergence.py``) fix three seeds: the data
(``default_rng(0)``), the client batches (``default_rng(300 + t)``) and the
trainer's draws (``FLConfig.seed = 0``).  Seed s here takes
``default_rng(s)``, ``default_rng(300 + t + 1000 s)`` and ``FLConfig.seed
= s``; s = 0 gives each script's own rows.  Fast setting: 120 rounds.

    PYTHONPATH=src python tools/fig4_seeds.py --package jax --seeds 4
    PYTHONPATH=src python tools/fig4_seeds.py --package torch --seeds 4

Prints one line per seed and a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

POLICIES = ("fairk", "toprand", "topk")


def task(seed: int, n_clients: int = 16, d_feat: int = 1500):
    """The regression's data and batch stream for seed ``seed``."""
    rng = np.random.default_rng(seed)
    scales = (np.arange(1, d_feat + 1) ** -0.8).astype(np.float32)
    w_star = rng.normal(size=d_feat).astype(np.float32)
    data = []
    for _ in range(n_clients):
        X = rng.normal(size=(80, d_feat)).astype(np.float32) * scales
        data.append((X, X @ w_star + 0.05 * rng.normal(size=80).astype("f4")))
    Xte = rng.normal(size=(400, d_feat)).astype(np.float32) * scales
    yte = Xte @ w_star

    def sample_round(t):
        r = np.random.default_rng(300 + t + 1000 * seed)
        idx = r.integers(0, 80, (n_clients, 5, 20))
        xs = np.stack([data[i][0][idx[i]] for i in range(n_clients)])
        ys = np.stack([data[i][1][idx[i]] for i in range(n_clients)])
        return xs, ys

    def r2(w: np.ndarray) -> float:
        resid = Xte @ w - yte
        return 1.0 - float(np.mean(resid**2) / np.mean(yte**2))

    return sample_round, r2, d_feat, n_clients


def fl_kwargs(policy: str, rounds: int, n_clients: int, seed: int) -> dict:
    return dict(n_clients=n_clients, local_steps=5, batch_size=20,
                rounds=rounds, policy=policy, compression_ratio=0.05,
                local_lr=0.02, global_lr=0.02, seed=seed)


def jax_r2(seed: int, rounds: int) -> dict:
    import jax.numpy as jnp
    from repro.core.oac import ChannelConfig
    from repro.fl import FLConfig, train

    sample_round, r2, d_feat, n = task(seed)
    out = {}
    for policy in POLICIES:
        fl = FLConfig(channel=ChannelConfig(fading="rayleigh", mean=1.0,
                                            noise_std=0.05),
                      **fl_kwargs(policy, rounds, n, seed))
        h = train(fl, {"w": jnp.zeros((d_feat,), jnp.float32)},
                  lambda p, x, y: jnp.mean((x @ p["w"] - y) ** 2),
                  sample_round)
        out[policy] = r2(np.asarray(h["params"]["w"]))
    return out


def torch_r2(seed: int, rounds: int) -> dict:
    import torch
    from repro_torch.core.oac import ChannelConfig
    from repro_torch.fl import FLConfig, train

    sample_round, r2, d_feat, n = task(seed)
    out = {}
    for policy in POLICIES:
        fl = FLConfig(channel=ChannelConfig(fading="rayleigh", mean=1.0,
                                            noise_std=0.05),
                      **fl_kwargs(policy, rounds, n, seed))
        h = train(fl, {"w": torch.zeros(d_feat, dtype=torch.float32)},
                  lambda p, x, y: torch.mean((x @ p["w"] - y) ** 2),
                  sample_round, device="cpu")
        out[policy] = r2(h["params"]["w"].numpy())
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=120)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    rows = jax_r2 if args.package == "jax" else torch_r2
    r2 = np.zeros((args.seeds, len(POLICIES)))
    for s in range(args.seeds):
        res = rows(s, args.rounds)
        r2[s] = [res[p] for p in POLICIES]
        print(f"{args.package} seed {s}: " + "; ".join(
            f"{p} R2 {v:.4f}" for p, v in res.items()), flush=True)
    gap = r2[:, 0] - r2[:, 1]
    print(json.dumps({
        "package": args.package, "seeds": args.seeds,
        "rounds": args.rounds,
        "r2_mean": dict(zip(POLICIES, r2.mean(axis=0).tolist())),
        "r2_std": dict(zip(POLICIES, r2.std(axis=0, ddof=1).tolist())),
        "fairk_minus_toprand": gap.tolist(),
        "gap_mean": float(gap.mean()), "gap_std": float(gap.std(ddof=1)),
        "fairk_above_toprand_seeds": int((gap > 0).sum())}))


if __name__ == "__main__":
    main()
