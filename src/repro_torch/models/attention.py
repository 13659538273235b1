"""Grouped-query attention (``repro.models.attention``): single-tile
masked attention, the chunked online-softmax form, and the KV caches of
the serving path with single-token decoding.

Scores are the reference's ``einsum(..., preferred_element_type=float32)``
of compute-dtype operands: here float32 products of the upcast values (a
product of two bf16 values is exact in float32), the ``NEG_INF`` mask and
the online-softmax rescale as the reference writes them.  Plain matrix
products, not ``scaled_dot_product_attention``: its rounding differs.

A cache is ``{"k", "v"}`` (B, capacity, KV, hd) in the cache dtype,
``pos`` (capacity,) int32 with -1 where empty, ``idx`` an int32 scalar
(the next write offset) and ``ring`` a bool scalar.  ``cache_write`` and
``cache_fill`` update the cache IN PLACE and return it (the reference
returns a new one): a decoded token's slot is computed on the device
(``where(ring, idx % cap, min(idx, cap - 1))``: once full, a non-ring
cache overwrites its last slot) and written with ``index_copy_``, so a
step makes no host sync.
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


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def init_cache(batch: int, capacity: int, n_kv: int, head_dim: int, dtype,
               ring: bool = False, device=None) -> Dict:
    """An empty cache; ``ring=True`` is a sliding-window ring buffer of
    size ``capacity``."""
    kv = (batch, capacity, n_kv, head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "pos": torch.full((capacity,), -1, dtype=torch.int32, device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
        "ring": torch.tensor(bool(ring), device=device),
    }


def cache_spec(batch: int, capacity: int, n_kv: int, head_dim: int, dtype,
               ring: bool = False) -> Dict:
    """``init_cache``'s shapes and dtypes as ``meta`` tensors."""
    return init_cache(batch, capacity, n_kv, head_dim, dtype, ring,
                      device="meta")


def cache_write(cache: Dict, k_new: Tensor, v_new: Tensor,
                position: Tensor) -> Dict:
    """Append one decode step in place (k_new / v_new: (B, 1, KV, hd),
    roped already; ``position`` a 0-d tensor)."""
    cap = cache["k"].shape[1]
    slot = torch.where(cache["ring"], cache["idx"] % cap,
                       torch.clamp(cache["idx"], max=cap - 1))
    slot = slot.reshape(1).to(torch.int64)
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    cache["pos"].index_copy_(0, slot,
                             position.reshape(1).to(torch.int32))
    cache["idx"].add_(1)
    return cache


def cache_fill(cache: Dict, k_all: Tensor, v_all: Tensor,
               positions: Tensor) -> Dict:
    """Prefill in place: the whole sequence, or its trailing ``capacity``
    positions, from slot 0; the rest of the cache emptied."""
    cap = cache["k"].shape[1]
    s = k_all.shape[1]
    keep = min(s, cap)
    for name, val in (("k", k_all), ("v", v_all)):
        cache[name][:, :keep].copy_(val[:, s - keep:])
        cache[name][:, keep:].zero_()
    cache["pos"][:keep].copy_(positions[s - keep:])
    cache["pos"][keep:].fill_(-1)
    cache["idx"].add_(s)
    return cache


def decode_attend(q: Tensor, cache: Dict, qpos: Tensor, *,
                  window: int = 0) -> Tensor:
    """Single-token attention against the cache: float32 scores and
    softmax, ``p`` cast to the value dtype.  q: (B, 1, H, hd) -> (B, 1, H,
    hd)."""
    b, _, n_heads, hd = q.shape
    n_kv = cache["k"].shape[2]
    g = n_heads // n_kv
    qh = q.reshape(b, 1, n_kv, g, hd)
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bskgd,btkd->bkgst", qh.to(torch.float32),
                     cache["k"].to(torch.float32)) * scale
    pos = cache["pos"]
    valid = (pos >= 0) & (pos <= qpos)
    if window:
        valid = valid & (pos > qpos - window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd",
                       p.to(cache["v"].dtype).to(torch.float32),
                       cache["v"].to(torch.float32))
    return out.reshape(b, 1, n_heads, hd).to(q.dtype)
