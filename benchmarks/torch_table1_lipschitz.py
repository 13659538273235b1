"""Table I — empirical smoothness constants through the PyTorch port (the
twin of ``benchmarks/table1_lipschitz.py``): the conventional per-client
L-tilde^2 vs the fine-grained L_g^2 (global) and L_h^2 (heterogeneity),
across Dirichlet levels.  The paper's point: L_tilde >> L_g >> L_h, and
L_tilde grows sharply as data gets more non-iid."""

import time

import torch

from repro_torch.core.lipschitz import estimate_constants
from repro_torch.data import partition, synthetic
from repro_torch.device import resolve_device
from repro_torch.models import cnn


def run(fast: bool = True, device=None, rounds=None, seed: int = 0):
    """``rounds`` cuts the perturbation pairs per level (fast 4, full 8);
    the initial weights are drawn from seed ``2·seed`` and the
    perturbations from ``2·seed + 1`` (seed 0: the JAX script's keys 0 and
    1, as numbers of another generator)."""
    dev = resolve_device(device)
    n_clients = 8 if fast else 20
    n_pairs = rounds if rounds is not None else (4 if fast else 8)
    spec = synthetic.DatasetSpec("lip", (12, 12, 1), 6, 4000, 100,
                                 noise_std=1.0, sparsity=0.1)
    (xtr, ytr), _ = synthetic.make_dataset(spec, seed=0)
    rows, detail = [], {}
    for dir_alpha in ((0.1, 0.3, 1.0) if fast else (0.1, 0.3, 0.5, 1.0)):
        parts = partition.dirichlet_partition(ytr, n_clients, dir_alpha,
                                              seed=0)
        params = cnn.init_mlp_classifier(
            torch.Generator(device=dev).manual_seed(2 * seed), 144, 6,
            hidden=(32,), device=dev)
        subsets = [(torch.as_tensor(xtr[p[:300]], device=dev),
                    torch.as_tensor(ytr[p[:300]], device=dev))
                   for p in parts]

        def grad_fn(p, n):
            x, y = subsets[n]
            return torch.func.grad(
                lambda q: cnn.softmax_xent(cnn.mlp_classifier(q, x), y))(p)

        t0 = time.perf_counter()
        consts = estimate_constants(
            params, grad_fn, n_clients, n_pairs=n_pairs,
            generator=torch.Generator(device=dev).manual_seed(2 * seed + 1))
        us = (time.perf_counter() - t0) * 1e6
        detail[str(dir_alpha)] = consts
        rows.append((f"table1/dir_{dir_alpha}", us,
                     f"Lt2={consts['L_tilde2']:.2f};Lg2={consts['L_g2']:.2f};"
                     f"Lh2={consts['L_h2']:.2f}"))
    return rows, detail
