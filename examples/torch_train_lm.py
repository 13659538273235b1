"""End-to-end LM training driver through the PyTorch port (the twin of
``examples/train_lm.py``): an assigned architecture's family variant
trained through the port's single-card train step
(``repro_torch.launch.steps.make_train_step``) — the packed OAC-FAIR-k
server phase (one ``fairk_update`` kernel launch per step on the card),
AdamW, checkpoints, the loss curve.

Default is the reduced ~15M-parameter qwen-family variant; ``--size
100m`` builds the ~100M variant (the same code path).  The reference's
mesh flags have no meaning on one card and are not taken.

A VLM's patch prefix and an encoder-decoder's audio frames are fed as
seeded normals at the token embedding's scale (0.02,
``repro_torch.launch.train.make_batch``).  The reference's example feeds
zeros there, and a LayerNorm or RMSNorm of exact zeros has the Jacobian
1/√eps: at full depth the gradients overflow to NaN (internvl2-1b's 24
layers) or reach 2.3e22 (whisper-base), in both packages.

``--ckpt-dir`` saves the parameter tree in the port's own checkpoint
format (``repro_torch.checkpoint.save``: one ``.npz`` per step, every 50
steps and at the end), not the reference's.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 200 \\
      --arch qwen2.5-32b [--device cpu]
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import checkpoint  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.device import resolve_device, set_numerics  # noqa: E402
from repro_torch.launch.steps import (OacServerConfig,  # noqa: E402
                                      init_server_state, make_train_step)
from repro_torch.launch.train import make_batch  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402


def sized_config(arch: str, size: str):
    cfg = get_config(arch, reduced_variant=True)
    if size == "100m":
        cfg = dataclasses.replace(
            cfg, name=cfg.name + "-100m", n_layers=8 * cfg.scan_block,
            d_model=512, n_heads=8 if cfg.n_heads else 0,
            n_kv_heads=2 if cfg.n_heads else 0,
            head_dim=64 if cfg.n_heads else 0,
            d_ff=2048 if cfg.d_ff else 0, vocab=32768)
    return cfg


def main(argv=None) -> dict:
    """Trains; returns the ``losses`` (floats), the final ``params``,
    ``opt`` and ``server`` state, the ``config`` and the final checkpoint's
    path (``ckpt``, None without ``--ckpt-dir``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2.5-32b")
    ap.add_argument("--size", choices=("small", "100m"), default="small")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256,
                    help="tokens per sequence (a VLM's patch prefix is "
                         "part of them)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--rho", type=float, default=0.1)
    ap.add_argument("--noise", type=float, default=0.0,
                    help="channel noise sigma_z (scaled by 1/N_clients)")
    ap.add_argument("--no-oac", dest="oac", action="store_false",
                    default=True)
    ap.add_argument("--ckpt-dir", default="",
                    help="save the parameters here (the port's .npz "
                         "format, repro_torch.checkpoint; not the "
                         "reference's)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_numerics(dev)

    cfg = sized_config(args.arch, args.size)
    text = args.seq - (cfg.n_patches if cfg.family == "vlm" else 0)
    shape = InputShape("custom", args.seq, args.batch, "train")
    oac = (OacServerConfig(rho=args.rho, noise_std=args.noise)
           if args.oac else None)
    bundle = make_train_step(cfg, shape, n_micro=1, oac=oac,
                             opt_name="adamw", lr=args.lr, device=dev)
    params = tr.init_lm_seeded(cfg, 0, dev)
    n_params = sum(x.numel() for _, x in tree_util.leaves(params))
    opt = make_optimizer("adamw", args.lr)
    opt_state = opt.init(params)
    server = init_server_state(params, oac=oac)
    print(f"[train_lm] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}, "
          f"OAC-FAIR-k {'on (rho=%.2f)' % args.rho if args.oac else 'off'}")

    losses = []
    t_start = time.time()
    for t in range(args.steps):
        batch = make_batch(cfg, 0, t, args.batch, text, 1, dev)
        params, opt_state, server, loss = bundle.fn(params, opt_state,
                                                    server, batch, t)
        losses.append(loss)
        if t % 10 == 0 or t == args.steps - 1:
            print(f"  step {t:4d}  loss {float(loss):.4f}  "
                  f"({(time.time()-t_start)/(t+1):.2f}s/step)", flush=True)
        if args.ckpt_dir and (t + 1) % 50 == 0:
            checkpoint.save(args.ckpt_dir, params, step=t + 1)
    path = None
    if args.ckpt_dir:
        path = checkpoint.save(args.ckpt_dir, params, step=args.steps)
        print(f"[train_lm] final checkpoint: {path}")
    print("[train_lm] done")
    return {"losses": [float(x) for x in losses], "params": params,
            "opt": opt_state, "server": server, "config": cfg,
            "ckpt": path}


if __name__ == "__main__":
    main()
