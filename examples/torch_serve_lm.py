"""Batched serving through the PyTorch port (the twin of
``examples/serve_lm.py``): prefill a batch of prompts with the port's
``make_prefill_step``, then greedy-decode new tokens step by step from the
KV / SSM caches with ``make_serve_step``.

The next token and its position stay on the device between decode steps
(no host sync per token); the times come from CUDA events on the card
(the host clock on the CPU).  A VLM's patch prefix and an
encoder-decoder's audio frames are fed as seeded normals at the token
embedding's scale (0.02), as the port's launcher feeds them (the
reference's example feeds a VLM none and has no encoder-decoder input).
Serving runs none of the port's kernels.

  PYTHONPATH=src python examples/torch_serve_lm.py --arch mamba2-370m \\
      --tokens 32 [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.data.tokens import lm_batch  # noqa: E402
from repro_torch.device import resolve_device, set_numerics  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import transformer as tr  # noqa: E402


class _Clock:
    """Elapsed seconds between two marks: CUDA events on the card, the
    host clock elsewhere."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds(self, a, b):
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        return b - a


def main(argv=None) -> dict:
    """Prefills and decodes; returns the generated tokens (``gen``, (B,
    tokens)), ``prefill_s``, ``decode_s``, and ``warm_step``: a thunk that
    decodes one more token from the final caches (for sync counting)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2.5-32b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_numerics(dev)

    cfg = get_config(args.arch, reduced_variant=True)
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    prompt = args.prompt_len + prefix
    capacity = prompt + args.tokens
    params = tr.init_lm_seeded(cfg, 0, dev)
    toks, _ = lm_batch(0, args.batch, args.prompt_len, cfg.vocab)
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    gen = torch.Generator().manual_seed(0)
    cdt = getattr(torch, cfg.compute_dtype)
    if prefix:
        batch["embeds"] = (0.02 * torch.randn(
            args.batch, prefix, cfg.d_model, generator=gen)).to(cdt).to(dev)
    if cfg.is_encdec:
        batch["frames"] = (0.02 * torch.randn(
            args.batch, cfg.encoder_seq, cfg.d_model, generator=gen)
                           ).to(cdt).to(dev)

    pre = make_prefill_step(cfg, InputShape("prefill", prompt, args.batch,
                                            "prefill"))
    serve = make_serve_step(cfg, InputShape("serve", capacity, args.batch,
                                            "decode"))
    clock = _Clock(dev)
    with torch.no_grad():
        caches = tr.init_caches(cfg, args.batch, capacity, device=dev)
        t0 = clock.mark()
        logits, caches = pre.fn(params, caches, batch)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        t1 = clock.mark()
        prefill_s = clock.seconds(t0, t1)
        print(f"[serve_lm] {cfg.name}: prefill {args.batch}x"
              f"{args.prompt_len} in {prefill_s:.2f}s")
        out_tokens = [tok]
        pos = torch.full((), prompt, dtype=torch.int32, device=dev)
        t0 = clock.mark()
        for _ in range(args.tokens - 1):
            logits, caches = serve.fn(params, caches, tok, pos)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            out_tokens.append(tok)
            pos.add_(1)
        t1 = clock.mark()
        dt = clock.seconds(t0, t1)
        gen_toks = torch.cat(out_tokens, dim=1).cpu()
    print(f"[serve_lm] decoded {args.tokens} tokens/seq in {dt:.2f}s "
          f"({args.batch*args.tokens/dt:.1f} tok/s aggregate)")
    for b in range(min(args.batch, 2)):
        print(f"  seq {b}: {gen_toks[b][:16].tolist()} ...")

    def warm_step():
        with torch.no_grad():
            return serve.fn(params, caches, tok, pos)

    return {"gen": gen_toks, "prefill_s": prefill_s, "decode_s": dt,
            "config": cfg, "capacity": capacity, "warm_step": warm_step}


if __name__ == "__main__":
    main()
