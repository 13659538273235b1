"""Client data partitioning for federated learning.

Implements the symmetric Dirichlet partitioning of Hsu et al. [46] used by
the paper (Sec. V-A): per client, a Dirichlet(Dir)-distributed class mixture
controls heterogeneity (smaller Dir => stronger non-i.i.d.), and client
dataset sizes are also heterogeneous.  An ``iid`` mode shards uniformly.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 8,
                        max_retries: int = 100) -> List[np.ndarray]:
    """Partition sample indices across clients with Dirichlet class mixtures.

    Returns a list of index arrays, one per client (sizes vary).  Redraws
    until every client holds at least ``min_size`` samples; an infeasible
    request (``n_clients * min_size > n_samples``) or a pathological draw
    streak (small alpha concentrates whole classes on single clients)
    raises instead of spinning forever."""
    n_samples = len(labels)
    if n_clients * min_size > n_samples:
        raise ValueError(
            f"infeasible partition: {n_clients} clients x min_size="
            f"{min_size} needs {n_clients * min_size} samples, got "
            f"{n_samples}")
    n_classes = int(labels.max()) + 1
    for attempt in range(max_retries):
        rng = np.random.default_rng(seed + attempt)
        idx_per_client: List[List[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            # proportions of class c going to each client
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for client, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[client].extend(part.tolist())
        sizes = [len(ix) for ix in idx_per_client]
        if min(sizes) >= min_size:
            break
    else:
        raise ValueError(
            f"no Dirichlet draw in {max_retries} attempts gave every "
            f"client >= {min_size} samples (smallest shard seen: "
            f"{min(sizes)} of {n_samples} over {n_clients} clients, "
            f"alpha={alpha}) — lower min_size or raise alpha")
    return [np.asarray(sorted(ix), dtype=np.int64) for ix in idx_per_client]


def iid_partition(n_samples: int, n_clients: int, seed: int = 0
                  ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_samples)
    return [np.sort(p) for p in np.array_split(perm, n_clients)]


def client_batches(x: np.ndarray, y: np.ndarray, parts: List[np.ndarray],
                   batch_size: int, steps: int, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Pre-draw local mini-batches for every client: (N, steps, B, ...).

    Clients sample with replacement from their own shard (paper: random local
    mini-batches theta_n^{(s)}).  Returning stacked arrays lets the FL trainer
    vmap the entire client population.
    """
    rng = np.random.default_rng(seed)
    n = len(parts)
    xs = np.empty((n, steps, batch_size) + x.shape[1:], x.dtype)
    ys = np.empty((n, steps, batch_size), y.dtype)
    for ci, part in enumerate(parts):
        draw = rng.choice(part, size=(steps, batch_size), replace=True)
        xs[ci] = x[draw]
        ys[ci] = y[draw]
    return xs, ys
