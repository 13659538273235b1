"""Data pipeline of the port: copies of the JAX package's numpy-only
synthetic datasets and federated partitioning (``repro.data``)."""

from repro_torch.data import partition, synthetic
from repro_torch.data.partition import (client_batches, dirichlet_partition,
                                        iid_partition)
from repro_torch.data.synthetic import (CIFAR10_LIKE, CIFAR100_LIKE,
                                        EMNIST_LIKE, DatasetSpec, make_dataset)

__all__ = [
    "partition", "synthetic", "client_batches", "dirichlet_partition",
    "iid_partition", "CIFAR10_LIKE", "CIFAR100_LIKE", "EMNIST_LIKE",
    "DatasetSpec", "make_dataset",
]
