"""Table I's fast setting over several seeds, for one package per process:
the smoothness constants at each Dirichlet level, and whether L-tilde^2
grows from Dir 0.3 to Dir 0.1 on average.

The JAX script (``benchmarks/table1_lipschitz.py``) and the port's
(``benchmarks/torch_table1_lipschitz.py``) use one seed for the initial
weights and one for the perturbations; their two rows differ in the draws
alone.  Seed s here draws the weights from 2s and the perturbations from
2s + 1 (s = 0 gives each script's own rows).

    PYTHONPATH=src python tools/table1_seeds.py --package jax --seeds 8
    PYTHONPATH=src python tools/table1_seeds.py --package torch --seeds 8

Prints one line per seed and a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

LEVELS = (0.1, 0.3, 1.0)


def jax_rows(seed: int) -> dict:
    """``benchmarks/table1_lipschitz.run(fast=True)`` with the keys 2s and
    2s + 1 in place of 0 and 1."""
    import jax
    import jax.numpy as jnp
    from repro.core.lipschitz import estimate_constants
    from repro.data import partition, synthetic
    from repro.models import cnn

    n_clients = 8
    spec = synthetic.DatasetSpec("lip", (12, 12, 1), 6, 4000, 100,
                                 noise_std=1.0, sparsity=0.1)
    (xtr, ytr), _ = synthetic.make_dataset(spec, seed=0)
    out = {}
    for dir_alpha in LEVELS:
        parts = partition.dirichlet_partition(ytr, n_clients, dir_alpha,
                                              seed=0)
        params = cnn.init_mlp_classifier(jax.random.PRNGKey(2 * seed), 144,
                                         6, hidden=(32,))
        subsets = [(jnp.asarray(xtr[p[:300]]), jnp.asarray(ytr[p[:300]]))
                   for p in parts]

        @jax.jit
        def client_grad(p, x, y):
            return jax.grad(
                lambda q: cnn.softmax_xent(cnn.mlp_classifier(q, x), y))(p)

        def grad_fn(p, n):
            return client_grad(p, *subsets[n])

        out[dir_alpha] = estimate_constants(
            jax.random.PRNGKey(2 * seed + 1), params, grad_fn, n_clients,
            n_pairs=4)
    return out


def torch_rows(seed: int) -> dict:
    from benchmarks import torch_table1_lipschitz

    _, detail = torch_table1_lipschitz.run(fast=True, device="cpu",
                                           seed=seed)
    return {a: detail[str(a)] for a in LEVELS}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    rows = jax_rows if args.package == "jax" else torch_rows
    lt2 = np.zeros((args.seeds, len(LEVELS)))
    for s in range(args.seeds):
        consts = rows(s)
        lt2[s] = [consts[a]["L_tilde2"] for a in LEVELS]
        print(f"{args.package} seed {s}: " + "; ".join(
            f"Dir {a}: Lt2 {c['L_tilde2']:.4f} Lg2 {c['L_g2']:.4f} "
            f"Lh2 {c['L_h2']:.4f}" for a, c in consts.items()), flush=True)
    mean = lt2.mean(axis=0)
    print(json.dumps({
        "package": args.package, "seeds": args.seeds,
        "L_tilde2_mean": dict(zip(map(str, LEVELS), mean.tolist())),
        "L_tilde2_std": dict(zip(map(str, LEVELS),
                                 lt2.std(axis=0, ddof=1).tolist())),
        "grows_0.3_to_0.1_mean": bool(mean[0] > mean[1]),
        "grows_0.3_to_0.1_seeds": int((lt2[:, 0] > lt2[:, 1]).sum())}))


if __name__ == "__main__":
    main()
