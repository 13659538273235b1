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

On a mesh every entry point takes ``par`` (``models.parallel.Parallel``):
the rank runs its batch rows, each block's parameters are gathered from
the rank's blocks inside the (checkpointed) block function, the residual
is the rank's slice of the sequence under sequence parallelism (each
sub-layer gathers it on entry and leaves its slice on exit), and the
caches hold the rank's blocks.  The parts that split over ``model``
(``par.split``) compute the rank's part, in training and serving alike:
attention its whole heads wherever the spec splits ``wq`` (``wq`` by
columns, ``wo`` by rows, ``wk`` / ``wv`` replicated and cut to the kv
groups the rank's heads read), the MLP its hidden units, and the
vocabulary its block — a masked embedding lookup summed over ``model``,
local logits and, in training, a vocab-parallel cross-entropy (float32
all-reduces of the maximum, the sum of exponentials and the target
logit); serving gathers the logits' blocks over ``model`` at the end.
Heads that do not split evenly over ``model`` (40, 56, 14, 24 or 8 heads
on 16 ranks) split as uneven runs of whole heads
(``parallel.head_range``: ⌊H/m⌋ or ⌈H/m⌉ a rank, none on some where
H < m): ``wq`` / ``wo`` are gathered over ``model`` in the layer and
narrowed to the rank's heads, and each head reads its own kv head (a run
may start or end inside a kv group); the reference's GSPMD re-tiles
half heads instead.  A vocabulary that does not divide stays whole on
every rank.  ``par`` None is the one-card path, unchanged.

Serving keeps the reference's cache layout under a split "attn": a
cache holds every kv head for the rank's block of its capacity (the
reference's "kv never divides the model axis").  Prefill projects every
kv head with the whole ``wk`` / ``wv`` (replicated by the spec), fills
the rank's capacity block from them and attends with the rank's heads
over their kv groups; decoding writes the new token's every kv head,
all-gathers the rank's heads' queries over ``model`` to every head
((B, 1, H, hd)), attends over the rank's capacity block with the
log-sum-exp combine over the cache's axes, keeps the rank's heads of the
output and runs the row-parallel ``wo`` (uneven runs are padded to
⌈H/m⌉ heads for the gather).  Cross-attention fills its
cache (frames split) from the whole ``wk`` / ``wv`` and, decoding,
gathers the frames and narrows them to the rank's kv groups.

Public entry points:
  init_lm / init_lm_seeded / init_caches / cache_specs
  forward_train(params, cfg, tokens, embeds/frames) -> (logits, aux)
  loss_fn(params, cfg, batch) -> (loss, metrics)
  prefill(params, cfg, tokens, caches, ...) -> (last_logits, caches)
  decode_step(params, cfg, token, pos, caches, ...) -> (logits, caches)
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.core import collectives
from repro_torch.models.parallel import (enter, gather_dim, gather_seq,
                                         head_range, heads_split, leave,
                                         narrow_block, reduce_from,
                                         row_parallel, slice_dim, splits)
from repro_torch.tracing import span

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
                causal: bool = True, par=None) -> Tensor:
    """Self-attention; ``mode`` "train" / "prefill" take the positions
    (S,), "decode" the 0-d position of its one token (the cache written
    in place)."""
    cdt = _dtype(cfg.compute_dtype)
    dt_out = x.dtype
    x = enter(par, x, "attn")
    b, s, _ = x.shape
    # serving's caches hold every kv head: the projections stay whole
    whole_kv = cache is not None and splits(par, "attn")
    p, heads = _heads_of(p, cfg, par, whole_kv)
    q = dense(p["wq"], x, cdt).reshape(b, s, heads.n, cfg.head_dim)
    k = dense(p["wk"], x, cdt).reshape(b, s, heads.n_kv_in, cfg.head_dim)
    v = dense(p["wv"], x, cdt).reshape(b, s, heads.n_kv_in, cfg.head_dim)
    mesh, kv = (par.mesh, par.kv) if par is not None else (None, ())
    if mode == "decode":
        q = apply_rope(q, pos[None, None], cfg.rope_theta)
        k = apply_rope(k, pos[None, None], cfg.rope_theta)
        attn_lib.cache_write(cache, k, v, pos, mesh, kv)
        if whole_kv:
            # every head's query against the rank's capacity block, then
            # the rank's heads of the combined output
            q = heads.gather(q, par)
        with span("model.attention"):
            out = attn_lib.decode_attend(q, cache, pos, window=window,
                                         mesh=mesh, axes=kv)
        if whole_kv:
            out = heads.mine(out)
    else:
        q = apply_rope(q, pos[None], cfg.rope_theta)
        k = apply_rope(k, pos[None], cfg.rope_theta)
        if cache is not None:
            attn_lib.cache_fill(cache, k, v, pos, mesh, kv)
        k, v = heads.cut(k), heads.cut(v)
        with span("model.attention"):
            if mode == "train":
                out = attn_lib.train_attention(
                    q, k, v, pos, causal=causal, window=window,
                    causal_skip=cfg.causal_skip)
            else:
                out = attn_lib.chunked_attention(
                    q, k, v, pos, pos, causal=causal, window=window,
                    causal_skip=cfg.causal_skip)
    out = out.reshape(b, s, heads.n * cfg.head_dim)
    return row_parallel(par, p["wo"], out, "attn", cdt).to(dt_out)


def _cross_mixer(p: Dict, x: Tensor, cfg: ModelConfig, *,
                 enc_out: Optional[Tensor], cross_cache: Optional[Dict],
                 par=None) -> Tensor:
    """Cross-attention over the encoder's output, or over its cached
    projection when there is no output (decoding); a given output fills
    the cache in place."""
    cdt = _dtype(cfg.compute_dtype)
    dt_out = x.dtype
    x = enter(par, x, "attn")
    b, s, _ = x.shape
    split = splits(par, "attn")
    # a cross cache holds every kv head: the projections stay whole
    whole_kv = cross_cache is not None and split
    p, heads = _heads_of(p, cfg, par, whole_kv)
    q = dense(p["wq"], x, cdt).reshape(b, s, heads.n, cfg.head_dim)
    axes = par.cross if par is not None else ()
    if cross_cache is not None and enc_out is None:
        k, v = cross_cache["k"], cross_cache["v"]
        if axes:
            # the frames split over ``axes``: gathered whole to attend
            k = gather_dim(k, par.mesh, axes, 1)
            v = gather_dim(v, par.mesh, axes, 1)
    else:
        t = enc_out.shape[1]
        # the encoder's output enters the region: the rank's heads give
        # it a partial gradient
        enc = par.partial(enc_out) if split else enc_out
        k = dense(p["wk"], enc, cdt).reshape(b, t, heads.n_kv_in,
                                             cfg.head_dim)
        v = dense(p["wv"], enc, cdt).reshape(b, t, heads.n_kv_in,
                                             cfg.head_dim)
        if cross_cache is not None:
            mesh = par.mesh if par is not None else None
            cross_cache["k"].copy_(narrow_block(k, mesh, axes, 1))
            cross_cache["v"].copy_(narrow_block(v, mesh, axes, 1))
    k, v = heads.cut(k), heads.cut(v)
    # no mask: every query position sees every frame
    qpos = torch.zeros(s, dtype=torch.int32, device=x.device)
    kpos = torch.zeros(k.shape[1], dtype=torch.int32, device=x.device)
    out = attn_lib.chunked_attention(q, k, v, qpos, kpos, causal=False)
    out = out.reshape(b, s, heads.n * cfg.head_dim)
    return row_parallel(par, p["wo"], out, "attn", cdt).to(dt_out)


@dataclasses.dataclass(frozen=True)
class _Heads:
    """The heads a rank computes: ``n`` of ``total`` from head ``h0``
    (groups of ``group`` heads a kv head), reading kv heads ``[kv0, kv0 +
    n_kv)``; the kv projections give ``n_kv_in`` heads (every kv head
    with ``whole_kv``).  ``even``: the heads split evenly over ``model``
    with whole kv groups (``heads_split``) or not at all, and attention
    reads the groups as one card's GQA reshape does; else each head's kv
    head is picked out for it (an uneven run can start or end inside a
    group)."""
    n: int
    total: int
    group: int
    n_kv_in: int
    h0: int = 0
    kv0: int = 0
    n_kv: int = 0
    whole_kv: bool = False
    even: bool = True

    def cut(self, k: Tensor) -> Tensor:
        """(B, T, ``n_kv_in``, hd) -> the kv heads the rank's heads read:
        its groups, or (uneven) one kv head per head."""
        if self.whole_kv:
            k = k.narrow(2, self.kv0, self.n_kv)
        if self.even:
            return k
        idx = (torch.arange(self.h0, self.h0 + self.n, device=k.device)
               // self.group - self.kv0)
        return k.index_select(2, idx)

    def gather(self, q: Tensor, par) -> Tensor:
        """Decoding: the rank's heads' queries (B, 1, n, hd) gathered over
        ``model`` to every head (B, 1, total, hd); uneven runs are padded
        to ⌈total/m⌉ heads for the gather and the padding dropped."""
        if self.even:
            return collectives.all_gather_dim(q, par.mesh, par.tp, 2)
        _, m = par.tp_index()
        per = -(-self.total // m)
        q = F.pad(q, (0, 0, 0, per - self.n))
        q = collectives.all_gather_dim(q, par.mesh, par.tp, 2)
        keep = []
        for i in range(m):
            h0, h1 = head_range(self.total, i, m)
            keep += range(i * per, i * per + h1 - h0)
        return q[:, :, keep]

    def mine(self, out: Tensor) -> Tensor:
        """Every head's output (B, 1, total, hd) -> the rank's heads."""
        return out.narrow(2, self.h0, self.n)


def _heads_of(p: Dict, cfg: ModelConfig, par, whole_kv: bool = False
              ) -> Tuple[Dict, _Heads]:
    """(the projections, the heads) the rank computes: all of them, or
    under a split "attn" its whole heads.  Evenly (``heads_split``)
    ``wq`` / ``wo`` arrive as its columns / rows; else they arrive as the
    spec's even blocks, are gathered over ``model`` here (inside the
    layer's checkpointed function) and narrowed to the rank's
    ``head_range`` — the gather's backward reduce-scatters the ranks'
    partial gradients, so each block's gradient lands on its rank.
    ``wq``'s replicated bias is cut to the rank's heads and the
    replicated ``wk`` / ``wv`` to the kv groups its heads read, their
    gradients summed over ``model``; with ``whole_kv`` (serving, whose
    caches hold every kv head) they stay whole and ``_Heads.cut`` cuts
    the groups from their outputs."""
    n_heads, n_kv_all = cfg.n_heads, cfg.n_kv_heads
    group = n_heads // n_kv_all
    if not splits(par, "attn"):
        return p, _Heads(n_heads, n_heads, group, n_kv_all)
    r, m = par.tp_index()
    hd = cfg.head_dim
    out = dict(p)
    even = heads_split(n_heads, n_kv_all, m)
    if even:
        n_h = n_heads // m
        h0 = r * n_h
        n_kv = max(1, n_h // group)
        kv0 = h0 // group
        if "b" in p["wq"]:
            out["wq"] = {"w": p["wq"]["w"],
                         "b": slice_dim(p["wq"]["b"], par.mesh, par.tp, 0)}
    else:
        h0, h1 = head_range(n_heads, r, m)
        n_h = h1 - h0
        kv0 = h0 // group
        n_kv = (h1 - 1) // group + 1 - kv0 if n_h else 0
        cols = (h0 * hd, n_h * hd)
        out["wq"] = {"w": gather_seq(p["wq"]["w"], par.mesh, par.tp, 1)
                     .narrow(1, *cols)}
        if "b" in p["wq"]:
            out["wq"]["b"] = par.partial(p["wq"]["b"]).narrow(0, *cols)
        out["wo"] = dict(p["wo"], w=gather_seq(p["wo"]["w"], par.mesh,
                                               par.tp, 0).narrow(0, *cols))
    if not whole_kv:
        for name in ("wk", "wv"):
            out[name] = {key: par.partial(t).narrow(
                -1, kv0 * hd, n_kv * hd) for key, t in p[name].items()}
    return out, _Heads(n_h, n_heads, group,
                       n_kv_all if whole_kv else n_kv, h0, kv0, n_kv,
                       whole_kv, even)


# ---------------------------------------------------------------------------
# one layer / one scan block / the stack
# ---------------------------------------------------------------------------

def _apply_layer(p: Dict, x: Tensor, cfg: ModelConfig, i: int, mode: str,
                 cache: Optional[Dict], pos: Tensor, window: int,
                 enc_out: Optional[Tensor], causal: bool = True, par=None,
                 where=None) -> Tuple[Tensor, Optional[Tensor]]:
    """(x, the MoE aux loss or None); ``cache`` is updated in place.
    ``where`` (stack, block): ``p`` is the rank's blocks of the layer's
    parameters, gathered here — inside the layer's own checkpointed
    function, so that no checkpoint keeps a gathered weight as its
    input."""
    if where is not None:
        p = par.block_params(p, *where, (i,))
    aux = None
    h = _norm(cfg, _on_slice(par, p["norm1"]), x)
    if cfg.layer_kind(i) == "attn":
        mix = _attn_mixer(p["mixer"], h, cfg, mode=mode,
                          cache=cache.get("attn") if cache else None,
                          pos=pos, window=window, causal=causal, par=par)
    else:
        m_cache = cache.get("mamba") if cache else None
        mix, new_m = mamba2.mamba_layer(p["mixer"], h, cfg, cache=m_cache,
                                        decode=(mode == "decode"), par=par)
        if m_cache is not None:
            for key, val in new_m.items():
                m_cache[key].copy_(val)
    x = x + mix
    if "cross" in p and (enc_out is not None
                         or (cache is not None and "cross" in cache)):
        hc = _norm(cfg, _on_slice(par, p["norm_x"]), x)
        x = x + _cross_mixer(p["cross"], hc, cfg, enc_out=enc_out,
                             cross_cache=cache.get("cross") if cache
                             else None, par=par)
    if "ffn" in p:
        cdt = _dtype(cfg.compute_dtype)
        h2 = _norm(cfg, _on_slice(par, p["norm2"]), x)
        if cfg.layer_is_moe(i):
            route_all = (par is not None and par.rows and mode == "decode"
                         and h2.shape[1] == 1)
            # single-token decoding routes the whole batch as one group;
            # routing (per row) sees the whole sequence
            hm = par.gather_rows(h2) if route_all else enter(par, h2, None)
            f, aux = moe_ffn(p["ffn"], hm, top_k=cfg.experts_per_token,
                             capacity_factor=cfg.capacity_factor,
                             mlp_type=cfg.mlp_type, compute_dtype=cdt,
                             decode_mode=(mode == "decode"), par=par)
            f = par.my_rows(f) if route_all else leave(par, f, None)
            if cfg.dense_residual:
                f = f + mlp(p["dense_ffn"], h2, cfg.mlp_type, cdt, par)
        else:
            f = mlp(p["ffn"], h2, cfg.mlp_type, cdt, par)
        x = x + f
    return x, aux


def _on_slice(par, norm: Dict) -> Dict:
    """A norm's parameters as the residual's slice of the sequence uses
    them (their gradients summed over the sequence's ranks)."""
    if par is None or not par.seq:
        return norm
    return {k: par.on_slice(t) for k, t in norm.items()}


def _apply_block(block_params: list, x: Tensor, cfg: ModelConfig, mode: str,
                 block_cache, pos: Tensor, window: int, enc_out,
                 causal: bool = True, par=None, where=None):
    """One scan block (``cfg.scan_block`` layers, unrolled) -> (x, aux);
    in training each layer of a multi-layer block is checkpointed on its
    own under ``cfg.remat``, so the block's recompute peaks at one
    layer's intermediates.  On a rank (``where``: (stack, block)) each
    layer gathers its parameters itself."""
    nest = cfg.remat and mode == "train" and cfg.scan_block > 1
    aux_total = None
    for j in range(cfg.scan_block):
        args = (block_params[j], x, cfg, j, mode,
                block_cache[j] if block_cache is not None else None, pos,
                window, enc_out, causal, par, where)
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
               causal: bool = True, remat: Optional[bool] = None, par=None,
               stack: str = "blocks"):
    """The loop over the stacked blocks -> (x, the aux sum or None);
    ``caches`` (None, or stacked like the blocks) are updated in place.
    With ``par`` the residual between the decoder's blocks in training is
    the rank's slice of the sequence over ``par.seq``."""
    use_remat = (cfg.remat if remat is None else remat) and mode == "train"
    n = tree_util.leaves(blocks)[0][1].shape[0]
    block_caches = (_unbind(caches, n) if caches is not None
                    else [None] * n)
    seq = (par.seq if par is not None and stack == "blocks"
           and mode == "train" else ())
    if par is not None and par.seq != seq:
        par = dataclasses.replace(par, seq=seq)
    if seq:
        x = slice_dim(x, par.mesh, seq, 1)
    aux_total = None
    for i, (bp, bc) in enumerate(zip(_unbind(blocks, n), block_caches)):
        args = (bp, x, cfg, mode, bc, pos, window, enc_out, causal, par,
                None if par is None else (stack, i))
        if use_remat:
            x, aux = checkpoint(_apply_block, *args, use_reentrant=False)
        else:
            x, aux = _apply_block(*args)
        aux_total = _add_aux(aux_total, aux)
    if seq:
        x = gather_dim(x, par.mesh, seq, 1)
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

def _embed(params, cfg: ModelConfig, tokens: Tensor, par=None) -> Tensor:
    """The token embeddings; under a split "vocab" the rank looks up its
    block's rows, zero elsewhere, and the blocks are summed over
    ``model``."""
    cdt = _dtype(cfg.compute_dtype)
    v = params["embed"].shape[0]
    ids, inside = tokens.long(), None
    if splits(par, "vocab"):
        ids, inside = _vocab_block(v, ids, par)
    if cfg.embed_mode == "onehot":
        oh = F.one_hot(ids, v).to(cdt)
        x = torch.einsum("bsv,vd->bsd", oh, params["embed"].to(cdt))
    else:
        x = params["embed"][ids].to(cdt)
    if inside is None:
        return x
    return reduce_from(torch.where(inside[..., None], x, 0.0), par.mesh,
                       par.tp)


def _vocab_block(v_local: int, ids: Tensor, par) -> Tuple[Tensor, Tensor]:
    """(``ids`` as rows of the rank's vocabulary block, 0 outside it;
    whether each lies inside)."""
    r, _ = par.tp_index()
    local = ids.long() - r * v_local
    inside = (local >= 0) & (local < v_local)
    return torch.where(inside, local, 0), inside


def _logits(params, cfg: ModelConfig, x: Tensor, par=None) -> Tensor:
    """The logits, or under a split "vocab" the rank's block of them."""
    cdt = _dtype(cfg.compute_dtype)
    if splits(par, "vocab"):
        x = par.partial(x)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x.to(cdt),
                            params["embed"].to(cdt))
    return dense(params["head"], x, cdt)


def _whole_logits(params, cfg: ModelConfig, x: Tensor, par=None) -> Tensor:
    """Serving's logits over the whole vocabulary: under a split "vocab"
    the ranks' blocks gathered over ``model``."""
    logits = _logits(params, cfg, x, par)
    if splits(par, "vocab"):
        logits = collectives.all_gather_dim(logits, par.mesh, par.tp, -1)
    return logits


def _encode(params, cfg: ModelConfig, frames: Tensor, par=None) -> Tensor:
    """The encoder over the stub frame embeddings (B, T, D): non-causal,
    in training mode whatever the caller's mode (RoPE applied, as the
    reference's attention mixer always does)."""
    x = frames.to(_dtype(cfg.compute_dtype))
    pos = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_stack(params["enc_blocks"], x, cfg, mode="train",
                      caches=None, pos=pos, window=0, causal=False, par=par,
                      stack="enc_blocks")
    return _norm(cfg, params["enc_norm"], x)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward_train(params, cfg: ModelConfig, tokens: Tensor,
                  embeds: Optional[Tensor] = None,
                  frames: Optional[Tensor] = None,
                  par=None) -> Tuple[Tensor, Tensor]:
    """Teacher-forced forward. tokens: (B, S_text); ``embeds``: VLM patch
    embeddings (B, P, D) prepended; ``frames``: the audio encoder's input
    (B, T, D).  Returns (logits over the text positions, the aux loss)."""
    x = _embed(params, cfg, tokens, par)
    n_prefix = 0
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
        n_prefix = embeds.shape[1]
    enc_out = (_encode(params, cfg, frames, par) if frames is not None
               else None)
    pos = torch.arange(x.shape[1], device=x.device)
    x, aux = _run_stack(params["blocks"], x, cfg, mode="train", caches=None,
                        pos=pos, enc_out=enc_out, par=par)
    x = _norm(cfg, params["final_norm"], x)
    if n_prefix:
        x = x[:, n_prefix:]
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    with span("model.logits"):
        return _logits(params, cfg, x, par), aux


def loss_fn(params, cfg: ModelConfig, batch: Dict,
            par=None) -> Tuple[Tensor, Dict]:
    logits, aux = forward_train(params, cfg, batch["tokens"],
                                embeds=batch.get("embeds"),
                                frames=batch.get("frames"), par=par)
    with span("model.loss"):
        if splits(par, "vocab"):
            nll = _vocab_parallel_nll(logits, batch["labels"], par)
        else:
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            nll = -torch.gather(logp, -1,
                                batch["labels"].long()[..., None])[..., 0]
        loss = nll.mean() + AUX_LOSS_WEIGHT * aux
    return loss, {"nll": nll.mean(), "aux": aux}


def _vocab_parallel_nll(logits: Tensor, labels: Tensor, par) -> Tensor:
    """The cross-entropy of the rank's block of the logits: float32
    all-reduces over ``model`` of the maximum, the sum of exponentials
    and the target logit (``logsumexp - target``)."""
    lg = logits.to(torch.float32)
    top = lg.detach().amax(-1, keepdim=True).contiguous()
    collectives.pmax(top, par.mesh, par.tp)
    total = reduce_from(torch.exp(lg - top).sum(-1), par.mesh, par.tp)
    ids, inside = _vocab_block(lg.shape[-1], labels, par)
    target = torch.gather(lg, -1, ids[..., None])[..., 0]
    target = reduce_from(torch.where(inside, target, 0.0), par.mesh, par.tp)
    return top[..., 0] + torch.log(total) - target


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: Tensor, caches,
            embeds: Optional[Tensor] = None,
            frames: Optional[Tensor] = None, window: int = 0, par=None):
    """Run the prompt through the stack, filling ``caches`` in place.
    Returns (the last position's logits (B, 1, V), caches)."""
    x = _embed(params, cfg, tokens, par)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    enc_out = (_encode(params, cfg, frames, par) if frames is not None
               else None)
    pos = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_stack(params["blocks"], x, cfg, mode="prefill",
                      caches=caches, pos=pos, window=window, enc_out=enc_out,
                      par=par)
    x = _norm(cfg, params["final_norm"], x[:, -1:])
    return _whole_logits(params, cfg, x, par), caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token: Tensor, pos, caches,
                window: int = 0, par=None):
    """One-token decode, ``caches`` updated in place. token: (B, 1);
    ``pos``: the global position, a 0-d int32 tensor on the device (an
    int is copied there).  Returns (logits (B, 1, V), caches)."""
    x = _embed(params, cfg, token, par)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    x, _ = _run_stack(params["blocks"], x, cfg, mode="decode",
                      caches=caches, pos=pos, window=window, par=par)
    x = _norm(cfg, params["final_norm"], x)
    return _whole_logits(params, cfg, x, par), caches
