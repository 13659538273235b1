"""Decoder-only and encoder-decoder transformer assembly
(``repro.models.transformer``).

Layers are stacked into homogeneous *scan blocks* (``cfg.scan_block``
layers per block: 1 for uniform stacks, 8 for jamba's attention / Mamba
super-block): ``params["blocks"]`` is a list of ``scan_block`` layer
dicts whose leaves carry a leading ``n_scan_blocks`` axis, the reference's
layout, so the packed layout, the checkpoint keys and carried weights
match one for one (``enc_blocks`` likewise, with ``encoder_layers``
blocks).  The reference's ``lax.scan`` over the blocks is a loop over the
stacked leaves (``unbind``: views), and ``jax.checkpoint`` is
``torch.utils.checkpoint`` (non-reentrant): per block under
``cfg.remat``, and per layer inside a multi-layer block, in training
only.

A layer is a mixer (attention or Mamba-2), for an encoder-decoder a
cross-attention over the encoder's output, and an FFN (dense, MoE, or
MoE beside a dense branch); the MoE layers' Switch aux losses are summed
per block and over the stack, and ``loss_fn`` adds ``AUX_LOSS_WEIGHT``
times the sum.

Caches mirror the block structure: a list of ``scan_block`` layer caches
(``attn``, ``mamba``, ``cross``) whose leaves carry a leading
``n_scan_blocks`` axis.  ``prefill`` and ``decode_step`` update them IN
PLACE, block by block through views of the stacked buffers (nothing is
re-stacked per token), and return them.

Public entry points:
  init_lm / init_lm_seeded / init_caches / cache_specs
  forward_train(params, cfg, tokens, embeds/frames) -> (logits, aux)
  loss_fn(params, cfg, batch) -> (loss, metrics)
  prefill(params, cfg, tokens, caches, ...) -> (last_logits, caches)
  decode_step(params, cfg, token, pos, caches, ...) -> (logits, caches)
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2
from repro_torch.models.layers import (apply_rope, dense, dense_init,
                                       embed_init, gen_device, layernorm,
                                       layernorm_init, rmsnorm, rmsnorm_init)
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.moe import init_moe, moe_ffn

Tensor = torch.Tensor
AUX_LOSS_WEIGHT = 0.01


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _norm_init(cfg: ModelConfig, dtype, device, lead=()):
    return (layernorm_init(cfg.d_model, dtype, device, lead)
            if cfg.norm_type == "layernorm"
            else rmsnorm_init(cfg.d_model, dtype, device, lead))


def _norm(cfg: ModelConfig, p, x):
    return (layernorm(p, x, cfg.norm_eps) if cfg.norm_type == "layernorm"
            else rmsnorm(p, x, cfg.norm_eps))


def _add_aux(total: Optional[Tensor], aux: Optional[Tensor]):
    """The reference's ``0 + aux_0 + aux_1 + ...``; None is a zero."""
    if aux is None:
        return total
    return aux if total is None else total + aux


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg: ModelConfig, i: int, dtype, lead,
                cross: bool = False) -> Dict:
    dev = gen_device(gen)
    p: Dict[str, Any] = {"norm1": _norm_init(cfg, dtype, dev, lead)}
    if cfg.layer_kind(i) == "attn":
        p["mixer"] = attn_lib.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            dtype, cfg.qkv_bias, lead=lead)
    else:
        p["mixer"] = mamba2.init_mamba(gen, cfg, dtype, lead)
    if cross:
        # built without qkv_bias, as the reference's is
        p["norm_x"] = _norm_init(cfg, dtype, dev, lead)
        p["cross"] = attn_lib.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            dtype, lead=lead)
    p["norm2"] = _norm_init(cfg, dtype, dev, lead)
    if cfg.layer_is_moe(i):
        p["ffn"] = init_moe(gen, cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
                            cfg.mlp_type, dtype, lead)
        if cfg.dense_residual:
            p["dense_ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff,
                                      cfg.mlp_type, dtype, lead=lead)
    elif cfg.d_ff:
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype,
                            lead=lead)
    return p


def init_lm(gen: Optional[torch.Generator], cfg: ModelConfig) -> Dict:
    """The reference's parameter tree, drawn from ``gen`` on its device:
    ``embed``, ``blocks`` (a list of ``scan_block`` layer dicts, leaves
    with a leading ``n_scan_blocks`` axis), ``final_norm``, untied
    ``head``, and for an encoder-decoder ``enc_blocks`` / ``enc_norm``.
    ``gen`` None gives the shapes and dtypes only (``meta`` tensors)."""
    dtype = _dtype(cfg.param_dtype)
    dev = gen_device(gen)
    lead = (cfg.n_scan_blocks,)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
        "blocks": [_init_layer(gen, cfg, j, dtype, lead, cross=cfg.is_encdec)
                   for j in range(cfg.scan_block)],
        "final_norm": _norm_init(cfg, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab, dtype)
    if cfg.is_encdec:
        params["enc_blocks"] = [_init_layer(gen, cfg, j, dtype,
                                            (cfg.encoder_layers,))
                                for j in range(cfg.scan_block)]
        params["enc_norm"] = _norm_init(cfg, dtype, dev)
    return params


def init_lm_seeded(cfg: ModelConfig, seed: int = 0,
                   device: DeviceLike = None) -> Dict:
    """``init_lm`` from a generator seeded ``seed`` on ``device`` (the
    card unless asked otherwise)."""
    dev = resolve_device(device)
    return init_lm(torch.Generator(device=dev).manual_seed(seed), cfg)


# ---------------------------------------------------------------------------
# mixers
# ---------------------------------------------------------------------------

def _attn_mixer(p: Dict, x: Tensor, cfg: ModelConfig, *, mode: str,
                cache: Optional[Dict], pos: Tensor, window: int,
                causal: bool = True) -> Tensor:
    """Self-attention; ``mode`` "train" / "prefill" take the positions
    (S,), "decode" the 0-d position of its one token (the cache written
    in place)."""
    cdt = _dtype(cfg.compute_dtype)
    b, s, _ = x.shape
    q = dense(p["wq"], x, cdt).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = dense(p["wk"], x, cdt).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = dense(p["wv"], x, cdt).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if mode == "decode":
        q = apply_rope(q, pos[None, None], cfg.rope_theta)
        k = apply_rope(k, pos[None, None], cfg.rope_theta)
        attn_lib.cache_write(cache, k, v, pos)
        out = attn_lib.decode_attend(q, cache, pos, window=window)
    else:
        q = apply_rope(q, pos[None], cfg.rope_theta)
        k = apply_rope(k, pos[None], cfg.rope_theta)
        if mode == "train" and s <= 8192:
            out = attn_lib.plain_attention(q, k, v, pos, pos, causal=causal,
                                           window=window)
        else:
            out = attn_lib.chunked_attention(q, k, v, pos, pos,
                                             causal=causal, window=window,
                                             causal_skip=cfg.causal_skip)
        if cache is not None:
            attn_lib.cache_fill(cache, k, v, pos)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return dense(p["wo"], out, cdt).to(x.dtype)


def _cross_mixer(p: Dict, x: Tensor, cfg: ModelConfig, *,
                 enc_out: Optional[Tensor], cross_cache: Optional[Dict]
                 ) -> Tensor:
    """Cross-attention over the encoder's output, or over its cached
    projection when there is no output (decoding); a given output fills
    the cache in place."""
    cdt = _dtype(cfg.compute_dtype)
    b, s, _ = x.shape
    q = dense(p["wq"], x, cdt).reshape(b, s, cfg.n_heads, cfg.head_dim)
    if cross_cache is not None and enc_out is None:
        k, v = cross_cache["k"], cross_cache["v"]
    else:
        t = enc_out.shape[1]
        k = dense(p["wk"], enc_out, cdt).reshape(b, t, cfg.n_kv_heads,
                                                 cfg.head_dim)
        v = dense(p["wv"], enc_out, cdt).reshape(b, t, cfg.n_kv_heads,
                                                 cfg.head_dim)
        if cross_cache is not None:
            cross_cache["k"].copy_(k)
            cross_cache["v"].copy_(v)
    # no mask: every query position sees every frame
    qpos = torch.zeros(s, dtype=torch.int32, device=x.device)
    kpos = torch.zeros(k.shape[1], dtype=torch.int32, device=x.device)
    out = attn_lib.chunked_attention(q, k, v, qpos, kpos, causal=False)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return dense(p["wo"], out, cdt).to(x.dtype)


# ---------------------------------------------------------------------------
# one layer / one scan block / the stack
# ---------------------------------------------------------------------------

def _apply_layer(p: Dict, x: Tensor, cfg: ModelConfig, i: int, mode: str,
                 cache: Optional[Dict], pos: Tensor, window: int,
                 enc_out: Optional[Tensor], causal: bool = True
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """(x, the MoE aux loss or None); ``cache`` is updated in place."""
    aux = None
    h = _norm(cfg, p["norm1"], x)
    if cfg.layer_kind(i) == "attn":
        mix = _attn_mixer(p["mixer"], h, cfg, mode=mode,
                          cache=cache.get("attn") if cache else None,
                          pos=pos, window=window, causal=causal)
    else:
        m_cache = cache.get("mamba") if cache else None
        mix, new_m = mamba2.mamba_layer(p["mixer"], h, cfg, cache=m_cache,
                                        decode=(mode == "decode"))
        if m_cache is not None:
            for key, val in new_m.items():
                m_cache[key].copy_(val)
    x = x + mix
    if "cross" in p and (enc_out is not None
                         or (cache is not None and "cross" in cache)):
        hc = _norm(cfg, p["norm_x"], x)
        x = x + _cross_mixer(p["cross"], hc, cfg, enc_out=enc_out,
                             cross_cache=cache.get("cross") if cache
                             else None)
    if "ffn" in p:
        cdt = _dtype(cfg.compute_dtype)
        h2 = _norm(cfg, p["norm2"], x)
        if cfg.layer_is_moe(i):
            f, aux = moe_ffn(p["ffn"], h2, top_k=cfg.experts_per_token,
                             capacity_factor=cfg.capacity_factor,
                             mlp_type=cfg.mlp_type, compute_dtype=cdt,
                             decode_mode=(mode == "decode"))
            if cfg.dense_residual:
                f = f + mlp(p["dense_ffn"], h2, cfg.mlp_type, cdt)
        else:
            f = mlp(p["ffn"], h2, cfg.mlp_type, cdt)
        x = x + f
    return x, aux


def _apply_block(block_params: list, x: Tensor, cfg: ModelConfig, mode: str,
                 block_cache, pos: Tensor, window: int, enc_out,
                 causal: bool = True):
    """One scan block (``cfg.scan_block`` layers, unrolled) -> (x, aux);
    in training each layer of a multi-layer block is checkpointed on its
    own under ``cfg.remat``, so the block's recompute peaks at one
    layer's intermediates."""
    nest = cfg.remat and mode == "train" and cfg.scan_block > 1
    aux_total = None
    for j in range(cfg.scan_block):
        args = (block_params[j], x, cfg, j, mode,
                block_cache[j] if block_cache is not None else None, pos,
                window, enc_out, causal)
        if nest:
            x, aux = checkpoint(_apply_layer, *args, use_reentrant=False)
        else:
            x, aux = _apply_layer(*args)
        aux_total = _add_aux(aux_total, aux)
    return x, aux_total


def _unbind(tree: Any, n: int) -> list:
    """A tree whose leaves have a leading ``n`` axis -> ``n`` trees of the
    slices (views)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, list):
        parts = [_unbind(v, n) for v in tree]
        return [[p[i] for p in parts] for i in range(n)]
    return list(tree.unbind(0))


def _run_stack(blocks, x: Tensor, cfg: ModelConfig, *, mode: str, caches,
               pos: Tensor, window: int = 0, enc_out=None,
               causal: bool = True, remat: Optional[bool] = None):
    """The loop over the stacked blocks -> (x, the aux sum or None);
    ``caches`` (None, or stacked like the blocks) are updated in place."""
    use_remat = (cfg.remat if remat is None else remat) and mode == "train"
    n = tree_util.leaves(blocks)[0][1].shape[0]
    block_caches = (_unbind(caches, n) if caches is not None
                    else [None] * n)
    aux_total = None
    for bp, bc in zip(_unbind(blocks, n), block_caches):
        args = (bp, x, cfg, mode, bc, pos, window, enc_out, causal)
        if use_remat:
            x, aux = checkpoint(_apply_block, *args, use_reentrant=False)
        else:
            x, aux = _apply_block(*args)
        aux_total = _add_aux(aux_total, aux)
    return x, aux_total


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _layer_cache(cfg: ModelConfig, i: int, batch: int, capacity: int,
                 dtype, ring: bool, device) -> Dict:
    c: Dict[str, Any] = {}
    if cfg.layer_kind(i) == "attn":
        c["attn"] = attn_lib.init_cache(batch, capacity, cfg.n_kv_heads,
                                        cfg.head_dim, dtype, ring, device)
    else:
        c["mamba"] = mamba2.mamba_cache_init(batch, cfg, dtype, device)
    if cfg.is_encdec:
        kv = (batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        c["cross"] = {"k": torch.zeros(kv, dtype=dtype, device=device),
                      "v": torch.zeros(kv, dtype=dtype, device=device)}
    return c


def _build_caches(cfg: ModelConfig, batch: int, capacity: int, dtype,
                  ring: bool, device):
    """Stacked caches: per-scan-block list of layer caches, leading
    ``n_scan_blocks``."""
    n = cfg.n_scan_blocks
    per_block = [_layer_cache(cfg, j, batch, capacity, dtype, ring, device)
                 for j in range(cfg.scan_block)]
    return tree_util.tree_map(
        lambda t: t.expand((n,) + tuple(t.shape)).contiguous(), per_block)


def init_caches(cfg: ModelConfig, batch: int, capacity: int, dtype=None,
                ring: bool = False, device: DeviceLike = None):
    """Empty caches on ``device`` (the card unless asked otherwise), in
    the compute dtype unless ``dtype`` is given."""
    dtype = _dtype(cfg.compute_dtype) if dtype is None else dtype
    return _build_caches(cfg, batch, capacity, dtype, ring,
                         resolve_device(device))


def cache_specs(cfg: ModelConfig, batch: int, capacity: int, dtype=None,
                ring: bool = False):
    """``init_caches``' shapes and dtypes as ``meta`` tensors."""
    dtype = _dtype(cfg.compute_dtype) if dtype is None else dtype
    return _build_caches(cfg, batch, capacity, dtype, ring,
                         torch.device("meta"))


# ---------------------------------------------------------------------------
# embedding / head / encoder
# ---------------------------------------------------------------------------

def _embed(params, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    cdt = _dtype(cfg.compute_dtype)
    if cfg.embed_mode == "onehot":
        oh = F.one_hot(tokens.long(), params["embed"].shape[0]).to(cdt)
        return torch.einsum("bsv,vd->bsd", oh, params["embed"].to(cdt))
    return params["embed"][tokens.long()].to(cdt)


def _logits(params, cfg: ModelConfig, x: Tensor) -> Tensor:
    cdt = _dtype(cfg.compute_dtype)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x.to(cdt),
                            params["embed"].to(cdt))
    return dense(params["head"], x, cdt)


def _encode(params, cfg: ModelConfig, frames: Tensor) -> Tensor:
    """The encoder over the stub frame embeddings (B, T, D): non-causal,
    in training mode whatever the caller's mode (RoPE applied, as the
    reference's attention mixer always does)."""
    x = frames.to(_dtype(cfg.compute_dtype))
    pos = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_stack(params["enc_blocks"], x, cfg, mode="train",
                      caches=None, pos=pos, window=0, causal=False)
    return _norm(cfg, params["enc_norm"], x)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward_train(params, cfg: ModelConfig, tokens: Tensor,
                  embeds: Optional[Tensor] = None,
                  frames: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Teacher-forced forward. tokens: (B, S_text); ``embeds``: VLM patch
    embeddings (B, P, D) prepended; ``frames``: the audio encoder's input
    (B, T, D).  Returns (logits over the text positions, the aux loss)."""
    x = _embed(params, cfg, tokens)
    n_prefix = 0
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
        n_prefix = embeds.shape[1]
    enc_out = _encode(params, cfg, frames) if frames is not None else None
    pos = torch.arange(x.shape[1], device=x.device)
    x, aux = _run_stack(params["blocks"], x, cfg, mode="train", caches=None,
                        pos=pos, enc_out=enc_out)
    x = _norm(cfg, params["final_norm"], x)
    if n_prefix:
        x = x[:, n_prefix:]
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch: Dict) -> Tuple[Tensor, Dict]:
    logits, aux = forward_train(params, cfg, batch["tokens"],
                                embeds=batch.get("embeds"),
                                frames=batch.get("frames"))
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    loss = nll.mean() + AUX_LOSS_WEIGHT * aux
    return loss, {"nll": nll.mean(), "aux": aux}


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: Tensor, caches,
            embeds: Optional[Tensor] = None,
            frames: Optional[Tensor] = None, window: int = 0):
    """Run the prompt through the stack, filling ``caches`` in place.
    Returns (the last position's logits (B, 1, V), caches)."""
    x = _embed(params, cfg, tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    enc_out = _encode(params, cfg, frames) if frames is not None else None
    pos = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_stack(params["blocks"], x, cfg, mode="prefill",
                      caches=caches, pos=pos, window=window, enc_out=enc_out)
    x = _norm(cfg, params["final_norm"], x[:, -1:])
    return _logits(params, cfg, x), caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token: Tensor, pos, caches,
                window: int = 0):
    """One-token decode, ``caches`` updated in place. token: (B, 1);
    ``pos``: the global position, a 0-d int32 tensor on the device (an
    int is copied there).  Returns (logits (B, 1, V), caches)."""
    x = _embed(params, cfg, token)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    x, _ = _run_stack(params["blocks"], x, cfg, mode="decode",
                      caches=caches, pos=pos, window=window)
    x = _norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, x), caches
