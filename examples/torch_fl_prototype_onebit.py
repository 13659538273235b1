"""Prototype demonstration through the PyTorch port (the twin of
``examples/fl_prototype_onebit.py``; paper Sec. V-B): one-bit FSK
majority-vote OAC.

The hardware prototype quantizes the selected gradient entries to signs,
transmits via FSK, and the server majority-votes — simulated end to end
with the paper's CNN on the EMNIST-like synthetic dataset at rho = 20%
(``--full-cnn``: the 109,210-parameter CNN on 28x28 images).  On the card
each round folds the clients' votes with one ``sign_mv`` launch
(``ops.vote_fold``), detects the majority with one ``sign_from_energy``
launch and merges with one ``aou_merge`` launch.

  PYTHONPATH=src python examples/torch_fl_prototype_onebit.py --rounds 100
      [--full-cnn] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core.oac import ChannelConfig  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.fl import FLConfig, train  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

POLICIES = ("fairk", "topk", "toprand")


def main(argv=None) -> dict:
    """Runs each policy; returns its ``train`` history."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients", type=int, default=2,
                    help="prototype uses N=2 SDR clients")
    ap.add_argument("--full-cnn", action="store_true",
                    help="use the full 28x28 EMNIST-like task + 109k CNN")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.full_cnn:
        img, n_classes = (28, 28, 1), 26
        widths, fc = (24, 32, 48), 192        # d = 109,210 (paper: 109,402)
        n_train = 24_000
    else:
        img, n_classes = (16, 16, 1), 26
        widths, fc = (12, 16, 24), 64
        n_train = 8_000
    spec = synthetic.DatasetSpec("emnist-like", img, n_classes, n_train,
                                 2_000, noise_std=1.0, sparsity=0.1)
    (xtr, ytr), (xte, yte) = synthetic.make_dataset(spec, seed=0)
    parts = partition.dirichlet_partition(ytr, args.clients, 1.0, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    params0 = cnn.init_prototype_cnn(gen, img, n_classes, widths=widths,
                                     fc_width=fc, device=dev)
    print(f"prototype CNN d = {cnn.param_count(params0)}, N = {args.clients} "
          f"clients, one-bit FSK-MV uplink, rho = 20%")

    def loss_fn(p, x, y):
        return cnn.softmax_xent(cnn.prototype_cnn(p, x), y)

    xte_t = torch.as_tensor(xte, device=dev)
    yte_t = torch.as_tensor(yte, device=dev)

    def eval_fn(p):
        with torch.no_grad():
            return {"acc": cnn.accuracy(cnn.prototype_cnn(p, xte_t), yte_t)}

    def sample_round(t):
        return partition.client_batches(xtr, ytr, parts, 32, 5, seed=t)

    out = {}
    for policy in POLICIES:
        fl = FLConfig(n_clients=args.clients, local_steps=5, batch_size=32,
                      local_lr=0.05, global_lr=0.003, rounds=args.rounds,
                      policy=policy, compression_ratio=0.2, one_bit=True,
                      channel=ChannelConfig(fading="none", mean=1.0,
                                            noise_std=1.0))
        h = train(fl, params0, loss_fn, sample_round, eval_fn=eval_fn,
                  eval_every=max(args.rounds // 4, 1), device=dev)
        print(f"  {policy:10s} acc curve: "
              f"{['%.3f' % a for a in h['acc']]}")
        out[policy] = h
    return out


if __name__ == "__main__":
    main()
