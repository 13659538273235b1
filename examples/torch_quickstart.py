"""Quickstart through the PyTorch port (the twin of
``examples/quickstart.py``): OAC-FL with FAIR-k against Top-k.

Trains a small classifier federated across 16 clients over a simulated
Rayleigh-fading multiple-access channel, comparing FAIR-k with Top-k —
the paper's headline effect (Fig. 4): magnitude-only selection starves
coordinates and stalls; FAIR-k's age stage keeps every coordinate fresh
and converges.  The data and the Dir(0.3) partition are the reference's
(numpy, the same seeds); the initial weights and the channel draws come
from ``torch.Generator`` and differ from the reference's.  On the card
every exact round's state update is one ``aou_merge`` kernel launch.

  PYTHONPATH=src python examples/torch_quickstart.py          # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core.oac import ChannelConfig  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.device import DeviceLike, resolve_device  # noqa: E402
from repro_torch.fl import FLConfig, train  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

N_CLIENTS = 16
POLICIES = ("fairk", "topk")


def make_data():
    """(xtr, ytr, xte, yte, parts): the reference's synthetic dataset and
    Dir(0.3) partition over 16 clients."""
    spec = synthetic.DatasetSpec("quickstart", (16, 16, 1), 10, 8000, 1000,
                                 noise_std=1.0, sparsity=0.08)
    (xtr, ytr), (xte, yte) = synthetic.make_dataset(spec, seed=0)
    parts = partition.dirichlet_partition(ytr, N_CLIENTS, alpha=0.3, seed=0)
    return xtr, ytr, xte, yte, parts


def make_task(device: DeviceLike = None):
    """(params0, loss_fn, eval_fn, sample_round) on ``device``: the MLP
    (hidden 64) from a generator seeded 0, the test accuracy, and round
    t's client batches (20 samples, 5 local steps)."""
    dev = resolve_device(device)
    xtr, ytr, xte, yte, parts = make_data()
    gen = torch.Generator(device=dev).manual_seed(0)
    params0 = cnn.init_mlp_classifier(gen, 256, 10, hidden=(64,),
                                      device=dev)
    xte_t = torch.as_tensor(xte, device=dev)
    yte_t = torch.as_tensor(yte, device=dev)

    def loss_fn(p, x, y):
        return cnn.softmax_xent(cnn.mlp_classifier(p, x), y)

    def eval_fn(p):
        with torch.no_grad():
            return {"acc": cnn.accuracy(cnn.mlp_classifier(p, xte_t),
                                        yte_t)}

    def sample_round(t):
        return partition.client_batches(xtr, ytr, parts, 20, 5, seed=t)

    return params0, loss_fn, eval_fn, sample_round


def fl_config(policy: str, rounds: int = 100) -> FLConfig:
    """The reference's round: 16 clients, H 5, B 20, ρ 0.1, Rayleigh
    fading with noise 0.2, the exact backend."""
    return FLConfig(n_clients=N_CLIENTS, local_steps=5, batch_size=20,
                    local_lr=0.05, global_lr=0.05, rounds=rounds,
                    policy=policy, compression_ratio=0.1,
                    channel=ChannelConfig(fading="rayleigh", mean=1.0,
                                          noise_std=0.2))


def main(argv=None) -> dict:
    """Runs both policies; returns each one's ``train`` history."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--policies", default=",".join(POLICIES))
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params0, loss_fn, eval_fn, sample_round = make_task(dev)
    print(f"model d={cnn.param_count(params0)} parameters, "
          f"{N_CLIENTS} clients, Dir(0.3), rho=10% waveform budget\n")
    out = {}
    for policy in args.policies.split(","):
        print(f"=== policy: {policy}")
        h = train(fl_config(policy, args.rounds), params0, loss_fn,
                  sample_round, eval_fn=eval_fn,
                  eval_every=max(1, min(25, args.rounds)), verbose=True,
                  device=dev)
        print(f"    final acc {h['acc'][-1]:.3f}, "
              f"mean AoU {h['mean_aou'][-1]:.1f}, "
              f"entries never updated: "
              f"{(h['sel_count'] == 0).mean()*100:.0f}%\n")
        out[policy] = h
    return out


if __name__ == "__main__":
    main()
