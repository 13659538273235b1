"""Grouped-query attention for training (``repro.models.attention``):
single-tile masked attention and the chunked online-softmax form.

Scores are the reference's ``einsum(..., preferred_element_type=float32)``
of compute-dtype operands: here float32 products of the upcast values (a
product of two bf16 values is exact in float32), the ``NEG_INF`` mask and
the online-softmax rescale as the reference writes them.  Plain matrix
products, not ``scaled_dot_product_attention``: its rounding differs.
The KV caches and single-token decoding belong to the serving path
(ROADMAP item 11c).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.layers import dense_init

Tensor = torch.Tensor
NEG_INF = -1e30


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, dtype,
                   qkv_bias: bool = False, lead=()) -> Dict:
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype,
                         bias=qkv_bias, lead=lead),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, dtype,
                         bias=qkv_bias, lead=lead),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, dtype,
                         bias=qkv_bias, lead=lead),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, scale=0.5,
                         lead=lead),
    }


def _chunk_attend(q, k, v, qpos, kpos, *, causal: bool, window: int,
                  scale: float):
    """One (q-chunk, kv-chunk) tile with explicit position masking.

    q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd); positions (Sq,), (Sk,).
    Returns the un-normalized float32 (out, row_max, row_sum)."""
    s = torch.einsum("bskgd,btkd->bkgst", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    m = torch.amax(s, dim=-1)                                 # (B,KV,G,Sq)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd",
                       p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out, m, l


def _normalize(out: Tensor, l: Tensor) -> Tensor:
    return out / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]


def plain_attention(q: Tensor, k: Tensor, v: Tensor, qpos: Tensor,
                    kpos: Tensor, *, causal: bool = True, window: int = 0
                    ) -> Tensor:
    """Single-tile masked attention. q: (B,S,H,hd); k,v: (B,T,KV,hd)."""
    b, s_len, n_heads, hd = q.shape
    n_kv = k.shape[2]
    g = n_heads // n_kv
    scale = 1.0 / (hd ** 0.5)
    qh = q.reshape(b, s_len, n_kv, g, hd)
    out, _, l = _chunk_attend(qh, k, v, qpos, kpos, causal=causal,
                              window=window, scale=scale)
    return _normalize(out, l).reshape(b, s_len, n_heads, hd).to(q.dtype)


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, qpos: Tensor,
                      kpos: Tensor, *, causal: bool = True, window: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      causal_skip: bool = False) -> Tensor:
    """Flash-style attention. q: (B,S,H,hd); k,v: (B,T,KV,hd) ->
    (B,S,H,hd).  Ragged sizes take the single tile; ``causal_skip``
    visits only the kv blocks at or below each q block."""
    b, s_len, n_heads, hd = q.shape
    t_len, n_kv = k.shape[1], k.shape[2]
    g = n_heads // n_kv
    scale = 1.0 / (hd ** 0.5)
    q = q.reshape(b, s_len, n_kv, g, hd)

    q_chunk = min(q_chunk, s_len)
    kv_chunk = min(kv_chunk, t_len)
    if s_len % q_chunk or t_len % kv_chunk:
        out, _, l = _chunk_attend(q, k, v, qpos, kpos, causal=causal,
                                  window=window, scale=scale)
        return _normalize(out, l).reshape(b, s_len, n_heads, hd).to(q.dtype)

    nq, nk = s_len // q_chunk, t_len // kv_chunk

    def one_q_block(iq: int, n_kv_blocks: int) -> Tensor:
        qs = slice(iq * q_chunk, (iq + 1) * q_chunk)
        qi, qpi = q[:, qs], qpos[qs]
        acc = torch.zeros((b, q_chunk, n_kv, g, hd), dtype=torch.float32,
                          device=q.device)
        m_run = torch.full((b, n_kv, g, q_chunk), NEG_INF,
                           dtype=torch.float32, device=q.device)
        l_run = torch.zeros((b, n_kv, g, q_chunk), dtype=torch.float32,
                            device=q.device)
        for j in range(n_kv_blocks):
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            out, m, l = _chunk_attend(qi, k[:, ks], v[:, ks], qpi, kpos[ks],
                                      causal=causal, window=window,
                                      scale=scale)
            m_new = torch.maximum(m_run, m)
            alpha = torch.exp(m_run - m_new)               # rescale old
            beta = torch.exp(m - m_new)                    # rescale new
            l_run = l_run * alpha + l * beta
            acc = (acc * alpha.permute(0, 3, 1, 2)[..., None]
                   + out * beta.permute(0, 3, 1, 2)[..., None])
            m_run = m_new
        return _normalize(acc, l_run).to(q.dtype)

    visit_all = not (causal_skip and causal and s_len == t_len and not window)
    outs = [one_q_block(iq, nk if visit_all else iq + 1) for iq in range(nq)]
    out = torch.stack(outs, dim=1)                 # (b, nq, q_chunk, kv, g, hd)
    return out.reshape(b, s_len, n_heads, hd)
