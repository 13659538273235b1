"""Shared harness for the paper-figure benchmarks run through the PyTorch
port (``repro_torch``), the twin of ``benchmarks/common.py``.

The settings are those of the JAX scripts: the default ("fast") settings
are reduced versions of the paper's setups, ``--full`` is closer to paper
scale.  Every benchmark reports *relative* policy behaviour — the paper's
actual claims — on synthetic data; the port's initial weights and random
draws come from ``torch.Generator`` and differ from the JAX package's, so
only orderings compare across the two.  ``device=None`` runs on the card
(and raises without one); ``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.oac import ChannelConfig
from repro_torch.data import partition, synthetic
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl import FLConfig, train
from repro_torch.models import cnn


@dataclasses.dataclass
class FLTask:
    params0: object
    loss_fn: Callable
    eval_fn: Callable
    sample_round: Callable
    n_clients: int
    d: int
    device: torch.device


def make_task(fast: bool = True, seed: int = 0, model: str = "mlp",
              sparsity: float = 0.08, n_classes: int = 10,
              dir_alpha: float = 0.3, device: DeviceLike = None) -> FLTask:
    """Synthetic CIFAR-stand-in classification task (paper Sec. V-A setup,
    reduced): an MLP (hidden 64) or a small CNN on 16x16x1 synthetic
    images over N = 20 clients (fast), 24x24x3 over 50 (full), Dir(0.3)."""
    dev = resolve_device(device)
    n_clients = 20 if fast else 50
    img = (16, 16, 1) if fast else (24, 24, 3)
    spec = synthetic.DatasetSpec("bench", img, n_classes,
                                 8_000 if fast else 24_000, 1_000,
                                 noise_std=1.0, sparsity=sparsity)
    (xtr, ytr), (xte, yte) = synthetic.make_dataset(spec, seed=seed)
    parts = partition.dirichlet_partition(ytr, n_clients, dir_alpha,
                                          seed=seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dim = int(np.prod(img))
    if model == "cnn":
        params0 = cnn.init_prototype_cnn(gen, img, n_classes,
                                         widths=(12, 16, 24), fc_width=48,
                                         device=dev)
        apply_fn = cnn.prototype_cnn
    else:
        params0 = cnn.init_mlp_classifier(gen, dim, n_classes, hidden=(64,),
                                          device=dev)
        apply_fn = cnn.mlp_classifier

    def loss_fn(p, x, y):
        return cnn.softmax_xent(apply_fn(p, x), y)

    xte_t = torch.as_tensor(xte, device=dev)
    yte_t = torch.as_tensor(yte, device=dev)

    def eval_fn(p):
        with torch.no_grad():
            return {"acc": cnn.accuracy(apply_fn(p, xte_t), yte_t)}

    def sample_round(t, steps=5):
        return partition.client_batches(xtr, ytr, parts, 20, steps,
                                        seed=seed * 7919 + t)

    return FLTask(params0, loss_fn, eval_fn, sample_round, n_clients,
                  cnn.param_count(params0), dev)


PAPER_CHANNEL = ChannelConfig(fading="rayleigh", mean=1.0, noise_std=0.1)


def run_policy(task: FLTask, policy: str, rounds: int, *, rho: float = 0.1,
               k_m_frac: float = 0.75, local_steps: int = 5,
               lr: float = 0.05, one_bit: bool = False,
               channel: ChannelConfig = PAPER_CHANNEL,
               eval_every: int = 0, kernel_mode: Optional[str] = None
               ) -> Dict:
    """``train`` on the exact backend (the paper's setting) with a default
    ``FLConfig`` for ``policy`` on the task's device."""
    fl = FLConfig(n_clients=task.n_clients, local_steps=local_steps,
                  batch_size=20, local_lr=lr, global_lr=lr, rounds=rounds,
                  policy=policy, compression_ratio=rho, k_m_frac=k_m_frac,
                  channel=channel, one_bit=one_bit)
    return train(fl, task.params0, task.loss_fn,
                 lambda t: task.sample_round(t, steps=local_steps),
                 eval_fn=task.eval_fn, eval_every=eval_every or rounds,
                 device=task.device, kernel_mode=kernel_mode)


def timed(fn: Callable, *args, repeats: int = 3, **kw
          ) -> Tuple[float, object]:
    """Mean µs per call after one warm-up call; the card is synchronised
    before the clock stops."""
    out = fn(*args, **kw)
    sync = torch.cuda.synchronize if torch.cuda.is_available() else None
    if sync:
        sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args, **kw)
    if sync:
        sync()
    return (time.perf_counter() - t0) / repeats * 1e6, out


def csv_row(name: str, us: float, derived: str) -> str:
    return f"{name},{us:.1f},{derived}"
