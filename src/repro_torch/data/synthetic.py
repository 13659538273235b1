"""Synthetic stand-ins for the paper's datasets (offline container).

The container cannot download CIFAR-10/100 or EMNIST, so we generate
synthetic image-classification datasets with the same shapes and class
cardinalities: each class has a Gaussian prototype image and samples are
prototype + noise (+ a small shared nuisance subspace so the task is not
trivially linearly separable).  The paper's claims are *relative* orderings
of selection policies, which survive the substitution; absolute accuracies
are reported as synthetic.  See DESIGN.md §7 (data gate).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    image_shape: Tuple[int, int, int]   # (H, W, C)
    n_classes: int
    n_train: int
    n_test: int
    noise_std: float = 1.0
    prototype_scale: float = 1.0
    sparsity: float = 0.0               # >0: class signal concentrated on this
                                        # fraction of pixels (heavy-tailed
                                        # gradients, like real convnet tasks)


CIFAR10_LIKE = DatasetSpec("cifar10-like", (32, 32, 3), 10, 50_000, 10_000)
CIFAR100_LIKE = DatasetSpec("cifar100-like", (32, 32, 3), 100, 50_000, 10_000)
EMNIST_LIKE = DatasetSpec("emnist-letters-like", (28, 28, 1), 26, 124_800, 20_800)


def _make_split(rng: np.random.Generator, spec: DatasetSpec, protos: np.ndarray,
                nuisance: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    labels = rng.integers(0, spec.n_classes, size=n)
    dim = int(np.prod(spec.image_shape))
    x = protos[labels] * spec.prototype_scale
    x = x + spec.noise_std * rng.normal(size=(n, dim)).astype(np.float32)
    # shared nuisance directions (class-independent structure)
    coef = rng.normal(size=(n, nuisance.shape[0])).astype(np.float32)
    x = x + coef @ nuisance
    return x.reshape((n,) + spec.image_shape).astype(np.float32), labels.astype(np.int32)


def make_dataset(spec: DatasetSpec, seed: int = 0, n_train: int | None = None,
                 n_test: int | None = None):
    """Returns ((x_train, y_train), (x_test, y_test)) as numpy arrays."""
    rng = np.random.default_rng(seed)
    dim = int(np.prod(spec.image_shape))
    protos = rng.normal(size=(spec.n_classes, dim)).astype(np.float32)
    if spec.sparsity > 0.0:
        keep = max(1, int(spec.sparsity * dim))
        for c in range(spec.n_classes):
            off = rng.permutation(dim)[keep:]
            protos[c, off] = 0.0
    protos /= np.linalg.norm(protos, axis=1, keepdims=True) / np.sqrt(dim) * 4.0
    nuisance = 0.3 * rng.normal(size=(8, dim)).astype(np.float32)
    train = _make_split(rng, spec, protos, nuisance, n_train or spec.n_train)
    test = _make_split(rng, spec, protos, nuisance, n_test or spec.n_test)
    return train, test
