"""Paper Sec. V-A simulation driver through the PyTorch port (the twin of
``examples/fl_cifar_sim.py``; Fig. 4/5/6 style experiments).

Synthetic CIFAR stand-in (the reference's numpy data and partition), CNN
model, N clients with symmetric-Dirichlet heterogeneity, Rayleigh fading
+ AWGN, on the exact backend: on the card each round's state update is
one ``aou_merge`` kernel launch.  The initial weights and the channel
draws come from ``torch.Generator`` and differ from the reference's.

  PYTHONPATH=src python examples/torch_fl_cifar_sim.py \\
      --policies fairk,topk,toprand --rounds 200 --dir 0.3 --rho 0.1 \\
      [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.oac import ChannelConfig  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.fl import FLConfig, train  # noqa: E402
from repro_torch.models import cnn  # noqa: E402


def main(argv=None) -> dict:
    """Runs each policy; returns the reference's ``results`` dict."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policies", default="fairk,topk,agetopk,toprand")
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--dir", type=float, default=0.3, dest="dir_alpha")
    ap.add_argument("--rho", type=float, default=0.1)
    ap.add_argument("--km-frac", type=float, default=0.75)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--noise", type=float, default=0.2)
    ap.add_argument("--model", choices=("mlp", "cnn"), default="cnn")
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = synthetic.DatasetSpec("cifar-like", (16, 16, 3), 10, 12000, 1500,
                                 noise_std=1.0, sparsity=0.08)
    (xtr, ytr), (xte, yte) = synthetic.make_dataset(spec, seed=0)
    if args.iid:
        parts = partition.iid_partition(len(ytr), args.clients, seed=0)
    else:
        parts = partition.dirichlet_partition(ytr, args.clients,
                                              args.dir_alpha, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.model == "cnn":
        params0 = cnn.init_prototype_cnn(gen, (16, 16, 3), 10,
                                         widths=(12, 16, 24), fc_width=48,
                                         device=dev)
        apply_fn = cnn.prototype_cnn
    else:
        params0 = cnn.init_mlp_classifier(gen, 768, 10, hidden=(64,),
                                          device=dev)
        apply_fn = cnn.mlp_classifier
    print(f"d = {cnn.param_count(params0)} params, N = {args.clients}, "
          f"Dir = {'iid' if args.iid else args.dir_alpha}, rho = {args.rho}")

    def loss_fn(p, x, y):
        return cnn.softmax_xent(apply_fn(p, x), y)

    xte_t = torch.as_tensor(xte, device=dev)
    yte_t = torch.as_tensor(yte, device=dev)

    def eval_fn(p):
        with torch.no_grad():
            return {"acc": cnn.accuracy(apply_fn(p, xte_t), yte_t)}

    def sample_round(t):
        return partition.client_batches(xtr, ytr, parts, 20,
                                        args.local_steps, seed=1000 + t)

    results = {}
    for policy in args.policies.split(","):
        fl = FLConfig(n_clients=args.clients, local_steps=args.local_steps,
                      batch_size=20, local_lr=0.05, global_lr=0.05,
                      rounds=args.rounds, policy=policy,
                      compression_ratio=args.rho, k_m_frac=args.km_frac,
                      channel=ChannelConfig(fading="rayleigh", mean=1.0,
                                            noise_std=args.noise))
        print(f"=== {policy}")
        h = train(fl, params0, loss_fn, sample_round, eval_fn=eval_fn,
                  eval_every=max(args.rounds // 6, 1), verbose=True,
                  device=dev)
        results[policy] = {"round": h["round"], "acc": h["acc"],
                           "mean_aou": h["mean_aou"],
                           "never_frac": float((h["sel_count"] == 0).mean()),
                           "round_ms": h["round_ms"]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print("wrote", args.out)
    print("\nsummary:")
    for p, r in results.items():
        print(f"  {p:10s} acc={r['acc'][-1]:.3f} "
              f"meanAoU={np.mean(r['mean_aou'][args.rounds//2:]):.1f} "
              f"never={r['never_frac']*100:.0f}%")
    return results


if __name__ == "__main__":
    main()
