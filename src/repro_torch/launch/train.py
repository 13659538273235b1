"""Training launcher of the port (``repro.launch.train``): real steps of
the launch path's train step on one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b \\
      --steps 20                       # the reduced config, on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b \\
      --full --steps 3 --seq 256       # full width and depth
  ... --device cpu                     # on the CPU (reduced configs)

The flags are the reference's.  ``--ckpt-every N`` saves the persisted
packed server state (``checkpoint.save_server_state``) and the
parameters and optimizer state (``checkpoint.save``) every N steps; a
SIGTERM finishes the step in flight, saves once and stops; ``--resume``
restores the newest checkpoint of ``--ckpt-dir`` that passes its
checksums (walking back past corrupt or torn ones) and continues at the
following step.  The step updates the parameters, the optimizer state
and the server state in place.
"""

from __future__ import annotations

import argparse
import os
import signal
import time
import zipfile
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import checkpoint
from repro_torch import tree as tree_util
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import InputShape
from repro_torch.data.tokens import lm_batch
from repro_torch.device import resolve_device, set_numerics
from repro_torch.launch.steps import (OacServerConfig, init_server_state,
                                      make_train_step, server_layout)
from repro_torch.models import transformer as tr
from repro_torch.optim import make_optimizer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2.5-32b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128,
                    help="text tokens per sequence (a VLM's patch prefix "
                         "comes in front of them; an encoder-decoder's "
                         "frames go to its encoder)")
    ap.add_argument("--oac", action="store_true", default=True,
                    help="enable the FAIR-k OAC server phase")
    ap.add_argument("--no-oac", dest="oac", action="store_false")
    ap.add_argument("--rho", type=float, default=0.1)
    ap.add_argument("--per-leaf-server", action="store_true",
                    help="historical per-leaf OAC server phase")
    ap.add_argument("--ef", action="store_true",
                    help="error feedback (packed server phase only)")
    ap.add_argument("--one-bit", action="store_true",
                    help="one-bit server uplink: merge sign_mv-detected "
                         "signs (packed server phase only)")
    ap.add_argument("--legacy-stats", action="store_true",
                    help="disable the in-kernel selection statistics")
    ap.add_argument("--async-agg", action="store_true",
                    help="asynchronous double-buffered server rounds")
    ap.add_argument("--straggler-frac", type=float, default=0.25)
    ap.add_argument("--adaptive-km", action="store_true",
                    help="adapt the k_M/k split inside the step")
    ap.add_argument("--sanitize", action="store_true",
                    help="mask non-finite gradient coordinates out of the "
                         "fused selection")
    ap.add_argument("--fade", type=float, default=0.0,
                    help="per-round deep-fade erasure probability (needs "
                         "--sanitize)")
    ap.add_argument("--fade-block", type=int, default=128)
    ap.add_argument("--population", type=int, default=0,
                    help="virtual client-population size (0 = off; needs "
                         "--sanitize)")
    ap.add_argument("--cohorts", type=int, default=4096)
    ap.add_argument("--participants", type=int, default=16)
    ap.add_argument("--avail", type=float, default=0.9)
    ap.add_argument("--diurnal", action="store_true")
    ap.add_argument("--diurnal-period", type=int, default=96)
    ap.add_argument("--diurnal-depth", type=float, default=0.1)
    ap.add_argument("--channel", action="store_true",
                    help="per-block wireless channel (needs --sanitize)")
    ap.add_argument("--pmax", type=float, default=10.0)
    ap.add_argument("--gmin", type=float, default=0.05)
    ap.add_argument("--csi-err", type=float, default=0.0)
    ap.add_argument("--fading-corr", type=float, default=0.5)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save the server state and params/opt every N "
                         "steps (0 = off)")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest valid checkpoint of "
                         "--ckpt-dir")
    ap.add_argument("--client-chunk", type=int, default=0,
                    help="split the global batch into this many client "
                         "microbatches, accumulated chunk by chunk")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def oac_config(args) -> Optional[OacServerConfig]:
    """The ``OacServerConfig`` the flags describe (None with --no-oac)."""
    if not args.oac:
        return None
    population = wireless = None
    if args.population > 0:
        from repro_torch.core.population import PopulationConfig
        population = PopulationConfig(
            n_clients=args.population, cohort_size=args.cohorts,
            participants=args.participants, avail=args.avail,
            mode="diurnal" if args.diurnal else "iid",
            period=args.diurnal_period, depth=args.diurnal_depth,
            slow_frac=(args.straggler_frac if args.async_agg else 0.0))
    if args.channel:
        from repro_torch.core.channel import ChannelConfig
        wireless = ChannelConfig(pmax=args.pmax, gmin=args.gmin,
                                 csi_err=args.csi_err,
                                 rho_f=args.fading_corr,
                                 block=args.fade_block)
    return OacServerConfig(
        rho=args.rho, packed=not args.per_leaf_server,
        error_feedback=args.ef, one_bit=args.one_bit,
        fused_stats=not args.legacy_stats, adaptive_km=args.adaptive_km,
        async_agg=args.async_agg, straggler_frac=args.straggler_frac,
        sanitize=args.sanitize, fade=args.fade, fade_block=args.fade_block,
        population=population, wireless=wireless)


def make_batch(cfg, seed: int, t: int, batch: int, seq: int, n_micro: int,
               device) -> Dict[str, torch.Tensor]:
    """Step ``t``'s batch: ``lm_batch`` text of ``seq`` tokens, as the
    reference's launcher makes it, and the stub front end's embeddings —
    a VLM's patches in front of the text, an encoder-decoder's
    ``encoder_seq`` audio frames — as normals at the token embedding's
    scale (0.02) from a CPU generator seeded ``seed·1000 + t``.  The
    reference's launcher feeds zeros there; at ``internvl2-1b``'s depth
    that makes the gradients overflow in both packages (an RMSNorm of
    exact zeros has the Jacobian 1/√eps, and the prefix positions' gradient
    grows by orders of magnitude per layer: NaN at 24 layers)."""
    toks, labels = lm_batch(seed * 1000 + t, batch, seq, cfg.vocab)
    mb = batch // n_micro
    out = {"tokens": torch.from_numpy(toks).reshape(n_micro, mb, seq),
           "labels": torch.from_numpy(labels).reshape(n_micro, mb, seq)}
    prefix = {"vlm": ("embeds", cfg.n_patches),
              "audio": ("frames", cfg.encoder_seq)}.get(cfg.family)
    if prefix is not None:
        gen = torch.Generator().manual_seed(seed * 1000 + t)
        out[prefix[0]] = (0.02 * torch.randn(
            (n_micro, mb, prefix[1], cfg.d_model), generator=gen)).to(
                getattr(torch, cfg.compute_dtype))
    return {k: v.to(device) for k, v in out.items()}


def _resume(args, layout, params, opt_state, server):
    """(params, opt_state, server, start) from the newest checkpoint that
    passes validation, walking back past corrupt or torn ones."""
    candidates = checkpoint.server_steps(args.ckpt_dir)
    if not candidates:
        print(f"[train] --resume: no server checkpoint under "
              f"{args.ckpt_dir!r} — starting fresh at step 0", flush=True)
        return params, opt_state, server, 0
    dev = server["g"].device
    for last in candidates:
        srv_path = os.path.join(args.ckpt_dir, f"server_{last:08d}.npz")
        step_path = os.path.join(args.ckpt_dir, f"step_{last:08d}.npz")
        try:
            srv, _ = checkpoint.restore_server_state(srv_path, layout=layout,
                                                     device=dev)
            if not os.path.exists(step_path):
                raise checkpoint.CorruptCheckpointError(
                    f"{srv_path} has no matching step_{last:08d}.npz "
                    "(params/optimizer) — torn save")
            tree = checkpoint.restore(step_path, like={"params": params,
                                                       "opt": opt_state},
                                      device=dev)
        except (checkpoint.CorruptCheckpointError, zipfile.BadZipFile,
                OSError) as err:
            print(f"[train] --resume: checkpoint step {last} failed "
                  f"validation ({err}); falling back to the previous "
                  "checkpoint", flush=True)
            continue
        # a field-set mismatch raises: a wrong flag is not fixed by
        # falling back
        srv = checkpoint.migrate_server_state(srv, like=server)
        print(f"[train] resumed server + params/opt state from step {last} "
              f"({args.ckpt_dir})", flush=True)
        return tree["params"], tree["opt"], srv, last
    raise ValueError(f"--resume: every checkpoint under {args.ckpt_dir!r} "
                     f"failed validation (tried steps {candidates}) — "
                     "refusing to silently restart the trajectory from "
                     "scratch")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the launcher; returns the final ``params``, ``opt``,
    ``server``, the per-step ``losses`` and the first step ``start``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    set_numerics(dev)
    cfg = get_config(args.arch, reduced_variant=args.reduced)
    shape = InputShape("custom", args.seq, args.batch, "train")
    oac = oac_config(args)
    n_micro = args.client_chunk or 1
    if args.batch % n_micro:
        raise ValueError(f"--client-chunk {args.client_chunk} must divide "
                         f"--batch {args.batch}")
    bundle = make_train_step(cfg, shape, n_micro=n_micro,
                             client_chunk=(args.client_chunk or None),
                             oac=oac, lr=1e-3, device=dev)
    params = tr.init_lm_seeded(cfg, args.seed, dev)
    opt = make_optimizer(bundle.meta["optimizer"], bundle.meta["lr"])
    opt_state = opt.init(params)
    server = init_server_state(params, oac=oac)

    ckpt_on = args.ckpt_every > 0 or args.resume
    if ckpt_on and (oac is None or not oac.packed):
        raise ValueError("--ckpt-every/--resume checkpoint the PACKED "
                         "server buffers — they need --oac and are "
                         "incompatible with --per-leaf-server")
    layout = server_layout(params) if ckpt_on else None
    start = 0
    if args.resume:
        params, opt_state, server, start = _resume(args, layout, params,
                                                   opt_state, server)

    stop = {"sig": False}

    def _on_term(signum, frame):
        stop["sig"] = True

    previous = signal.signal(signal.SIGTERM, _on_term)

    def save(step):
        path = checkpoint.save_server_state(args.ckpt_dir, server,
                                            layout=layout, step=step)
        checkpoint.save(args.ckpt_dir, {"params": params, "opt": opt_state},
                        step=step)
        print(f"  [ckpt] saved {path} (+ step_{step:08d}.npz)", flush=True)

    n_params = sum(leaf.numel() for _, leaf in tree_util.leaves(params))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M parameters, "
          f"{args.steps} steps, oac={'on' if oac else 'off'}, on {dev}",
          flush=True)
    losses = []
    try:
        for t in range(start, start + args.steps):
            batch = make_batch(cfg, args.seed, t, args.batch, args.seq,
                               n_micro, dev)
            t0 = time.time()
            params, opt_state, server, loss = bundle.fn(
                params, opt_state, server, batch, t)
            losses.append(float(loss))
            print(f"  step {t:3d} loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.2f}s)", flush=True)
            if ckpt_on and args.ckpt_every > 0 and (
                    (t + 1 - start) % args.ckpt_every == 0):
                save(t + 1)
            if stop["sig"]:
                if ckpt_on:
                    save(t + 1)
                print("[train] SIGTERM — state saved, exiting", flush=True)
                break
    finally:
        signal.signal(signal.SIGTERM, previous)
    print("[train] done", flush=True)
    return {"params": params, "opt": opt_state, "server": server,
            "losses": losses, "start": start}


if __name__ == "__main__":
    main()
