"""A decoder-only transformer in float32 (Qwen2's shape, which
InternVL2's language model has [arXiv:2404.16821]): RMSNorm, grouped-query
attention with biased q/k/v projections and rotate-half RoPE, causal
softmax over the whole sequence, a SwiGLU MLP, an untied or tied output
head and the mean next-token cross-entropy.  A VLM's projected patch
embeddings come before the text tokens; the loss covers the text
positions only.  Each layer is recomputed in the backward pass, so one
sequence of 4,096 positions fits beside its float32 scores.

``param_spec`` is the parameter tree the benchmark draws and hands to the
port and to this reference alike: the port's layout (layers stacked on a
leading axis, ``blocks`` a list of one layer dict)."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.precision import matmul, rounded

Tensor = torch.Tensor


def head_dim(m: Dict[str, Any]) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def param_spec(m: Dict[str, Any]) -> List:
    """(path, shape, init) of every leaf: ``("normal", std)``, ``("ones",)``
    or ``("zeros",)``; weights at 1/sqrt(fan-in), the output projections
    at half that, the embedding at 0.02."""
    n, d, f, v = m["n_layers"], m["d_model"], m["d_ff"], m["vocab"]
    hd = head_dim(m)
    q, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    blk = ("blocks", 0)
    spec = [(("embed",), (v, d), ("normal", 0.02)),
            (("final_norm", "scale"), (d,), ("ones",))]
    if not m.get("tie_embeddings"):
        spec.append((("head", "w"), (d, v), ("normal", d ** -0.5)))
    for name, d_out in (("wq", q), ("wk", kv), ("wv", kv)):
        spec.append((blk + ("mixer", name, "w"), (n, d, d_out),
                     ("normal", d ** -0.5)))
        if m.get("qkv_bias"):
            spec.append((blk + ("mixer", name, "b"), (n, d_out), ("zeros",)))
    spec += [(blk + ("mixer", "wo", "w"), (n, q, d), ("normal", 0.5 * q ** -0.5)),
             (blk + ("norm1", "scale"), (n, d), ("ones",)),
             (blk + ("norm2", "scale"), (n, d), ("ones",)),
             (blk + ("ffn", "wg", "w"), (n, d, f), ("normal", d ** -0.5)),
             (blk + ("ffn", "wu", "w"), (n, d, f), ("normal", d ** -0.5)),
             (blk + ("ffn", "wd", "w"), (n, f, d), ("normal", 0.5 * f ** -0.5))]
    return spec


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x: Tensor, pos: Tensor, theta: float) -> Tensor:
    """x (S, heads, hd): rotate-half RoPE at positions ``pos``."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _linear(x: Tensor, p: Dict[str, Tensor], i: int, prec: str) -> Tensor:
    y = matmul(x, p["w"][i], prec)
    return y + p["b"][i] if "b" in p else y


def _layer(x: Tensor, blk: Dict, i: int, m: Dict, pos: Tensor,
           prec: str) -> Tensor:
    s = x.shape[0]
    hd, h, kvh = head_dim(m), m["n_heads"], m["n_kv_heads"]
    eps = m.get("norm_eps", 1e-5)
    a = rms_norm(x, blk["norm1"]["scale"][i], eps)
    mix = blk["mixer"]
    q = rope(_linear(a, mix["wq"], i, prec).view(s, h, hd), pos,
             m["rope_theta"])
    k = rope(_linear(a, mix["wk"], i, prec).view(s, kvh, hd), pos,
             m["rope_theta"])
    v = _linear(a, mix["wv"], i, prec).view(s, kvh, hd)
    k = k.repeat_interleave(h // kvh, dim=1)
    v = v.repeat_interleave(h // kvh, dim=1)
    scores = torch.einsum("shd,thd->hst", rounded(q, prec),
                          rounded(k, prec)) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    att = torch.einsum("hst,thd->shd", rounded(probs, prec),
                       rounded(v, prec)).reshape(s, h * hd)
    x = x + matmul(att, mix["wo"]["w"][i], prec)
    b = rms_norm(x, blk["norm2"]["scale"][i], eps)
    ffn = blk["ffn"]
    hid = (F.silu(matmul(b, ffn["wg"]["w"][i], prec))
           * matmul(b, ffn["wu"]["w"][i], prec))
    return x + matmul(hid, ffn["wd"]["w"][i], prec)


def sequence_loss(params: Dict, m: Dict[str, Any], tokens: Tensor,
                  labels: Tensor, embeds: Optional[Tensor],
                  prec: str = "float32") -> Tensor:
    """The mean cross-entropy of one sequence: ``tokens`` / ``labels``
    (S_text,), ``embeds`` (P, D) or None."""
    x = params["embed"][tokens.long()]
    n_prefix = 0
    if embeds is not None:
        x = torch.cat([embeds.to(torch.float32), x])
        n_prefix = embeds.shape[0]
    pos = torch.arange(x.shape[0], device=x.device)
    blk = params["blocks"][0]
    for i in range(m["n_layers"]):
        x = checkpoint(_layer, x, blk, i, m, pos, prec, use_reentrant=False)
    x = rms_norm(x, params["final_norm"]["scale"], m.get("norm_eps", 1e-5))
    x = x[n_prefix:]
    head = (params["embed"].t() if m.get("tie_embeddings")
            else params["head"]["w"])
    logits = matmul(x, head, prec)
    return F.cross_entropy(logits, labels.long())
