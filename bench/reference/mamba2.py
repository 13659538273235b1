"""Mamba-2 in float32 [arXiv:2405.21060]: per layer an RMSNorm, the
input projections to z, x, B/C and dt, depthwise causal convolutions
(kernel ``ssm_conv``, SiLU) over x and over B/C, the SSD mixer with a
per-head scalar decay ``A = -exp(a_log)``, ``dt = softplus(dt + dt_bias)``
and the skip ``D``, the gated RMSNorm of ``y · silu(z)`` and the output
projection; tied embeddings.  The SSD is the paper's chunked form
(its Listing 1: intra-chunk products, chunk states linked by the
segment-sum of the chunk decays), not a loop over chunks.  A layer
without an FFN still carries its unused ``norm2`` scale, as the port's
tree does (its gradient is zero).

``param_spec`` is the parameter tree the benchmark draws and hands to the
port and to this reference alike."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.decoder import rms_norm
from bench.reference.precision import matmul, rounded

Tensor = torch.Tensor


def _dims(m: Dict[str, Any]):
    d_in = m["ssm_expand"] * m["d_model"]
    gn = m["ssm_groups"] * m["ssm_state"]
    return d_in, gn, d_in // m["ssm_head_dim"]


def param_spec(m: Dict[str, Any]) -> List:
    """(path, shape, init) of every leaf (see ``decoder.param_spec``);
    ``("alog",)`` is log(linspace(1, 16, heads)) in every layer."""
    n, d, v, k = m["n_layers"], m["d_model"], m["vocab"], m["ssm_conv"]
    d_in, gn, h = _dims(m)
    blk = ("blocks", 0, "mixer")
    spec = [(("embed",), (v, d), ("normal", 0.02)),
            (("final_norm", "scale"), (d,), ("ones",)),
            (("blocks", 0, "norm1", "scale"), (n, d), ("ones",)),
            (("blocks", 0, "norm2", "scale"), (n, d), ("ones",))]
    for name, d_out in (("wz", d_in), ("wx", d_in), ("wbc", 2 * gn),
                        ("wdt", h)):
        spec.append((blk + (name, "w"), (n, d, d_out), ("normal", d ** -0.5)))
    spec += [(blk + ("conv_x_w",), (n, k, d_in), ("normal", 0.1)),
             (blk + ("conv_x_b",), (n, d_in), ("zeros",)),
             (blk + ("conv_bc_w",), (n, k, 2 * gn), ("normal", 0.1)),
             (blk + ("conv_bc_b",), (n, 2 * gn), ("zeros",)),
             (blk + ("a_log",), (n, h), ("alog",)),
             (blk + ("d_skip",), (n, h), ("ones",)),
             (blk + ("dt_bias",), (n, h), ("zeros",)),
             (blk + ("norm", "scale"), (n, d_in), ("ones",)),
             (blk + ("out_proj", "w"), (n, d_in, d),
              ("normal", 0.5 * d_in ** -0.5))]
    if not m.get("tie_embeddings"):
        spec.append((("head", "w"), (d, v), ("normal", d ** -0.5)))
    return spec


def causal_conv(x: Tensor, w: Tensor, b: Tensor, prec: str) -> Tensor:
    """Depthwise causal convolution, x (S, C), w (K, C): y[t] = Σ_i w[i]
    x[t − K + 1 + i] + b, then SiLU."""
    k = w.shape[0]
    y = F.conv1d(rounded(x, prec).t()[None], rounded(w, prec).t()[:, None],
                 padding=k - 1, groups=x.shape[1])[0, :, :x.shape[0]]
    return F.silu(y.t() + b)


def segsum(a: Tensor) -> Tensor:
    """(..., T) -> (..., T, T): out[i, j] = a[j+1] + ... + a[i] for j <= i,
    -inf above the diagonal."""
    t = a.shape[-1]
    cs = torch.cumsum(a, -1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(t, t, dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def ssd(x: Tensor, a: Tensor, b: Tensor, c: Tensor, q: int) -> Tensor:
    """The chunked SSD of one sequence.  x (S, H, P) = input · dt; a (S, H)
    = A · dt; b, c (S, N) shared by every head; chunks of ``q``."""
    s, h, p = x.shape
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    nc = s // q
    xc = x.reshape(nc, q, h, p)
    ac = a.reshape(nc, q, h).permute(2, 0, 1)                 # (H, C, Q)
    bc, cc = b.reshape(nc, q, -1), c.reshape(nc, q, -1)
    a_cs = torch.cumsum(ac, -1)
    cb = torch.einsum("cln,csn->cls", cc, bc)
    y_diag = torch.einsum("hcls,cshp->clhp",
                          cb[None] * torch.exp(segsum(ac)), xc)
    decay = torch.exp(a_cs[..., -1:] - a_cs)                  # (H, C, Q)
    states = torch.einsum("csn,hcs,cshp->chpn", bc, decay, xc)
    states = torch.cat([torch.zeros_like(states[:1]), states])
    chunk_decay = torch.exp(segsum(F.pad(a_cs[..., -1], (1, 0))))
    states = torch.einsum("hzc,chpn->zhpn", chunk_decay, states)[:-1]
    y_off = torch.einsum("cln,chpn,hcl->clhp", cc, states, torch.exp(a_cs))
    return (y_diag + y_off).reshape(s, h, p)


def _layer(x: Tensor, blk: Dict, i: int, m: Dict, prec: str) -> Tensor:
    s = x.shape[0]
    d_in, gn, h = _dims(m)
    eps = m.get("norm_eps", 1e-5)
    mx = blk["mixer"]
    u = rms_norm(x, blk["norm1"]["scale"][i], eps)
    z = matmul(u, mx["wz"]["w"][i], prec)
    xs = causal_conv(matmul(u, mx["wx"]["w"][i], prec), mx["conv_x_w"][i],
                     mx["conv_x_b"][i], prec)
    bcs = causal_conv(matmul(u, mx["wbc"]["w"][i], prec),
                      mx["conv_bc_w"][i], mx["conv_bc_b"][i], prec)
    dt = F.softplus(matmul(u, mx["wdt"]["w"][i], prec)
                    + mx["dt_bias"][i])                         # (S, H)
    a = -torch.exp(mx["a_log"][i])
    xh = xs.view(s, h, m["ssm_head_dim"])
    y = ssd(rounded(xh * dt[..., None], prec), dt * a,
            rounded(bcs[:, :gn], prec), rounded(bcs[:, gn:], prec),
            m["ssm_chunk"])
    y = (y + mx["d_skip"][i][:, None] * xh).reshape(s, d_in)
    y = rms_norm(y * F.silu(z), mx["norm"]["scale"][i], eps)
    return x + matmul(y, mx["out_proj"]["w"][i], prec)


def sequence_loss(params: Dict, m: Dict[str, Any], tokens: Tensor,
                  labels: Tensor, embeds: Optional[Tensor] = None,
                  prec: str = "float32") -> Tensor:
    """The mean next-token cross-entropy of one sequence (S,)."""
    if m["ssm_groups"] != 1:
        raise ValueError("the reference shares B and C over all heads "
                         "(ssm_groups 1)")
    x = params["embed"][tokens.long()]
    blk = params["blocks"][0]
    for i in range(m["n_layers"]):
        x = checkpoint(_layer, x, blk, i, m, prec, use_reentrant=False)
    x = rms_norm(x, params["final_norm"]["scale"], m.get("norm_eps", 1e-5))
    head = (params["embed"].t() if m.get("tie_embeddings")
            else params["head"]["w"])
    return F.cross_entropy(matmul(x, head, prec), labels.long())
