"""Decoder-only transformer assembly for training (``repro.models.
transformer``): ``init_lm``, ``forward_train`` and ``loss_fn``.

Layers are stacked into homogeneous *scan blocks* (``cfg.scan_block``
layers per block): ``params["blocks"]`` is a list of ``scan_block`` layer
dicts whose leaves carry a leading ``n_scan_blocks`` axis, the reference's
layout, so the packed layout, the checkpoint keys and carried weights
match one for one.  The reference's ``lax.scan`` over the blocks is a
loop over the stacked leaves (``unbind``: one gradient buffer per leaf),
and ``jax.checkpoint`` is ``torch.utils.checkpoint`` (non-reentrant): per
block under ``cfg.remat``, and per layer inside a multi-layer block.

Attention layers with a dense FFN, the ``vlm`` patch prefix, the one-hot
embedding and tied embeddings are ported.  MoE and Mamba layers and the
encoder-decoder stack raise ``NotImplementedError`` (ROADMAP item 11b);
prefill and decoding with KV caches are item 11c.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (apply_rope, dense, dense_init,
                                       embed_init, gen_device, layernorm,
                                       layernorm_init, rmsnorm, rmsnorm_init)
from repro_torch.models.mlp import init_mlp, mlp

Tensor = torch.Tensor
AUX_LOSS_WEIGHT = 0.01

_ITEM_11B = "not ported yet (ROADMAP Queue 1 item 11b)"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families whose layers are not ported yet."""
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder stack is "
                                  + _ITEM_11B)
    for i in range(cfg.scan_block):
        if cfg.layer_kind(i) != "attn":
            raise NotImplementedError(f"{cfg.name}: Mamba layers are "
                                      + _ITEM_11B)
        if cfg.layer_is_moe(i):
            raise NotImplementedError(f"{cfg.name}: MoE layers are "
                                      + _ITEM_11B)


def _norm_init(cfg: ModelConfig, dtype, device, lead=()):
    return (layernorm_init(cfg.d_model, dtype, device, lead)
            if cfg.norm_type == "layernorm"
            else rmsnorm_init(cfg.d_model, dtype, device, lead))


def _norm(cfg: ModelConfig, p, x):
    return (layernorm(p, x, cfg.norm_eps) if cfg.norm_type == "layernorm"
            else rmsnorm(p, x, cfg.norm_eps))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg: ModelConfig, dtype, lead) -> Dict:
    dev = gen_device(gen)
    p: Dict[str, Any] = {"norm1": _norm_init(cfg, dtype, dev, lead)}
    p["mixer"] = attn_lib.init_attention(
        gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dtype,
        cfg.qkv_bias, lead=lead)
    p["norm2"] = _norm_init(cfg, dtype, dev, lead)
    if cfg.d_ff:
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype,
                            lead=lead)
    return p


def init_lm(gen: Optional[torch.Generator], cfg: ModelConfig) -> Dict:
    """The reference's parameter tree, drawn from ``gen`` on its device:
    ``embed``, ``blocks`` (a list of ``scan_block`` layer dicts, leaves
    with a leading ``n_scan_blocks`` axis), ``final_norm`` and, untied,
    ``head``.  ``gen`` None gives the shapes and dtypes only (``meta``
    tensors)."""
    check_supported(cfg)
    dtype = _dtype(cfg.param_dtype)
    lead = (cfg.n_scan_blocks,)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
        "blocks": [_init_layer(gen, cfg, dtype, lead)
                   for _ in range(cfg.scan_block)],
        "final_norm": _norm_init(cfg, dtype, gen_device(gen)),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab, dtype)
    return params


def init_lm_seeded(cfg: ModelConfig, seed: int = 0,
                   device: DeviceLike = None) -> Dict:
    """``init_lm`` from a generator seeded ``seed`` on ``device`` (the
    card unless asked otherwise)."""
    dev = resolve_device(device)
    return init_lm(torch.Generator(device=dev).manual_seed(seed), cfg)


# ---------------------------------------------------------------------------
# one layer / one scan block / the stack
# ---------------------------------------------------------------------------

def _attn_mixer(p: Dict, x: Tensor, cfg: ModelConfig, pos: Tensor,
                window: int, causal: bool = True) -> Tensor:
    cdt = _dtype(cfg.compute_dtype)
    b, s, _ = x.shape
    q = dense(p["wq"], x, cdt).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = dense(p["wk"], x, cdt).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = dense(p["wv"], x, cdt).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, pos[None], cfg.rope_theta)
    k = apply_rope(k, pos[None], cfg.rope_theta)
    if s <= 8192:
        out = attn_lib.plain_attention(q, k, v, pos, pos, causal=causal,
                                       window=window)
    else:
        out = attn_lib.chunked_attention(q, k, v, pos, pos, causal=causal,
                                         window=window,
                                         causal_skip=cfg.causal_skip)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return dense(p["wo"], out, cdt).to(x.dtype)


def _apply_layer(p: Dict, x: Tensor, cfg: ModelConfig, pos: Tensor,
                 window: int) -> Tensor:
    h = _norm(cfg, p["norm1"], x)
    x = x + _attn_mixer(p["mixer"], h, cfg, pos, window)
    if "ffn" in p:
        h2 = _norm(cfg, p["norm2"], x)
        x = x + mlp(p["ffn"], h2, cfg.mlp_type, _dtype(cfg.compute_dtype))
    return x


def _apply_block(block_params: list, x: Tensor, cfg: ModelConfig,
                 pos: Tensor, window: int) -> Tensor:
    """One scan block (``cfg.scan_block`` layers, unrolled); each layer of
    a multi-layer block is checkpointed on its own under ``cfg.remat``."""
    nest = cfg.remat and cfg.scan_block > 1
    for j in range(cfg.scan_block):
        if nest:
            x = checkpoint(_apply_layer, block_params[j], x, cfg, pos,
                           window, use_reentrant=False)
        else:
            x = _apply_layer(block_params[j], x, cfg, pos, window)
    return x


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


def _run_stack(blocks, x: Tensor, cfg: ModelConfig, pos: Tensor,
               window: int = 0, remat: Optional[bool] = None) -> Tensor:
    """The loop over the stacked blocks (training mode)."""
    use_remat = cfg.remat if remat is None else remat
    for bp in _unbind(blocks, cfg.n_scan_blocks):
        if use_remat:
            x = checkpoint(_apply_block, bp, x, cfg, pos, window,
                           use_reentrant=False)
        else:
            x = _apply_block(bp, x, cfg, pos, window)
    return x


# ---------------------------------------------------------------------------
# embedding / head / entry points
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


def forward_train(params, cfg: ModelConfig, tokens: Tensor,
                  embeds: Optional[Tensor] = None,
                  frames: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Teacher-forced forward. tokens: (B, S_text); ``embeds``: VLM patch
    embeddings (B, P, D) prepended.  Returns (logits over the text
    positions, aux_loss)."""
    check_supported(cfg)
    if frames is not None:
        raise NotImplementedError("audio frames (the encoder) are "
                                  + _ITEM_11B)
    x = _embed(params, cfg, tokens)
    n_prefix = 0
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
        n_prefix = embeds.shape[1]
    pos = torch.arange(x.shape[1], device=x.device)
    x = _run_stack(params["blocks"], x, cfg, pos)
    x = _norm(cfg, params["final_norm"], x)
    if n_prefix:
        x = x[:, n_prefix:]
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
