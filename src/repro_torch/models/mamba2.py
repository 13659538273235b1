"""Mamba-2 (SSD, state-space duality) mixer layer (``repro.models.mamba2``)
[arXiv:2405.21060].

The chunked SSD scan: within a chunk the recurrence is dense products
(quadratic only in the chunk length), and chunks are linked by a small
``(H, P, N)`` float32 state, carried here by a loop over the chunks (the
reference's ``lax.scan``).  Decoding is the exact recurrent step on the
same state.

Layer layout: ``wz``, ``wx``, ``wbc`` and ``wdt`` project D to z
(d_inner), x (d_inner), B and C (2·G·N) and dt (H); a causal depthwise
convolution (kernel ``ssm_conv``) runs over x and over B, C; the SSD core
has a per-head scalar decay A, the skip D and ``softplus(dt + dt_bias)``
(``jax.nn.softplus`` is ``logaddexp(x, 0)``; torch's ``softplus`` turns
into the identity above its threshold); then the gated RMSNorm of
``y · silu(z)`` and ``out_proj``.  ``a_log``, ``d_skip`` and ``dt_bias``
are float32 in every tree.

Dtypes follow the reference: z, x, B, C in the compute dtype; dt, the
decays and the state in float32 (``x · dt`` promotes); the convolution's
products summed in float32 and rounded once (XLA keeps float32 inside the
fusion); a cache's new ``ssm`` state rounded to the cache's dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (_normal, dense, dense_init, gen_device,
                                       rmsnorm, rmsnorm_init)

Tensor = torch.Tensor


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_mamba(gen, cfg: ModelConfig, dtype, lead=()) -> Dict:
    """The split projections (z / x / bc / dt), the two depthwise
    convolutions, the float32 ``a_log``, ``d_skip`` and ``dt_bias``, the
    gated norm and ``out_proj``; ``lead`` prepends stacking axes."""
    lead = tuple(lead)
    dev = gen_device(gen)
    h = cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=dev))
    return {
        "wz": dense_init(gen, cfg.d_model, cfg.d_inner, dtype, lead=lead),
        "wx": dense_init(gen, cfg.d_model, cfg.d_inner, dtype, lead=lead),
        "wbc": dense_init(gen, cfg.d_model, 2 * gn, dtype, lead=lead),
        "wdt": dense_init(gen, cfg.d_model, h, dtype, lead=lead),
        "conv_x_w": (0.1 * _normal(gen, lead + (cfg.ssm_conv, cfg.d_inner))
                     ).to(dtype),
        "conv_x_b": torch.zeros(lead + (cfg.d_inner,), dtype=dtype,
                                device=dev),
        "conv_bc_w": (0.1 * _normal(gen, lead + (cfg.ssm_conv, 2 * gn))
                      ).to(dtype),
        "conv_bc_b": torch.zeros(lead + (2 * gn,), dtype=dtype, device=dev),
        "a_log": a_log.expand(lead + (h,)).clone(),
        "d_skip": torch.ones(lead + (h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(lead + (h,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(cfg.d_inner, dtype, dev, lead),
        "out_proj": dense_init(gen, cfg.d_inner, cfg.d_model, dtype,
                               scale=0.5, lead=lead),
    }


def _expand_groups(t: Tensor, n_heads: int) -> Tensor:
    """(..., G, N) -> (..., H, N) by repeating each group."""
    return torch.repeat_interleave(t, n_heads // t.shape[-2], dim=-2)


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv.  x: (B, S, C); w: (K, C).  Returns (y,
    new_state), the state being the trailing K-1 inputs (the decode
    carry)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    w32 = w.to(torch.float32)
    y = xp[:, 0:s].to(torch.float32) * w32[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s].to(torch.float32) * w32[i]
    y = F.silu(y + b.to(torch.float32)).to(x.dtype)
    return y, xp[:, xp.shape[1] - (k - 1):]


def _segsum(a: Tensor) -> Tensor:
    """a: (..., Q, H) -> (..., H, Q, Q) with out[i, j] = sum_{j<k<=i} a_k
    (``-inf`` above the diagonal)."""
    q = a.shape[-2]
    cs = torch.cumsum(a, dim=-2).movedim(-1, -2)               # (..., H, Q)
    diff = cs[..., :, None] - cs[..., None, :]                 # (..., H, Q, Q)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x: Tensor, dt: Tensor, a: Tensor, b: Tensor, c: Tensor,
                chunk: int, init_state: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) float32 (softplus applied); a: (H,)
    negative; b, c: (B, S, H, N).  S is padded to a chunk multiple with
    dt = 0 (no state contribution).  Returns (y (B, S, H, P) float32,
    final_state (B, H, P, N) float32)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk

    da = dt * a                                                 # (B, S, H)
    xdt = x.to(torch.float32) * dt[..., None]

    def rs(t):
        return t.reshape((bsz, nc, chunk) + t.shape[2:])
    da_c, xdt_c, b_c, c_c = rs(da), rs(xdt), rs(b), rs(c)

    da_cs = torch.cumsum(da_c, dim=2)                           # (B,C,Q,H)
    # intra-chunk (quadratic in Q, dense products)
    l_mat = torch.exp(_segsum(da_c))                            # (B,C,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", c_c, b_c)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp",
                          scores.to(torch.float32) * l_mat, xdt_c)

    # per-chunk input state contribution
    decay_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)          # (B,C,Q,H)
    chunk_states = torch.einsum("bckhn,bckhp->bchpn",
                                b_c.to(torch.float32) * decay_end[..., None],
                                xdt_c)
    chunk_decay = torch.exp(da_cs[:, :, -1, :])                 # (B,C,H)

    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.to(torch.float32))
    entering = []
    for ci in range(nc):
        entering.append(state)
        state = (state * chunk_decay[:, ci, :, None, None]
                 + chunk_states[:, ci])
    entering = torch.stack(entering, dim=1)                     # (B,C,H,P,N)

    # inter-chunk contribution
    in_decay = torch.exp(da_cs)                                 # (B,C,Q,H)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp",
                         c_c.to(torch.float32) * in_decay[..., None],
                         entering)
    y = (y_diag + y_off).reshape(bsz, s, h, p)[:, :s_orig]
    return y, state


def ssd_step(state: Tensor, x: Tensor, dt: Tensor, a: Tensor, b: Tensor,
             c: Tensor) -> Tuple[Tensor, Tensor]:
    """The exact recurrent decode step.  state: (B, H, P, N); x: (B, H, P);
    dt: (B, H) float32; b, c: (B, H, N).  Returns float32 (y, state)."""
    da = torch.exp(dt * a)                                      # (B, H)
    state = (state.to(torch.float32) * da[..., None, None]
             + (x.to(torch.float32) * dt[..., None])[..., None]
             * b.to(torch.float32)[..., None, :])
    y = torch.einsum("bhn,bhpn->bhp", c.to(torch.float32), state)
    return y, state


def _cache_shapes(batch: int, cfg: ModelConfig) -> Dict[str, Tuple]:
    gn2 = 2 * cfg.ssm_groups * cfg.ssm_state
    return {"ssm": (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            "conv_x": (batch, cfg.ssm_conv - 1, cfg.d_inner),
            "conv_bc": (batch, cfg.ssm_conv - 1, gn2)}


def mamba_cache_init(batch: int, cfg: ModelConfig, dtype,
                     device=None) -> Dict:
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, shape in _cache_shapes(batch, cfg).items()}


def mamba_cache_spec(batch: int, cfg: ModelConfig, dtype) -> Dict:
    """``mamba_cache_init``'s shapes and dtypes as ``meta`` tensors."""
    return mamba_cache_init(batch, cfg, dtype, device="meta")


def mamba_layer(p: Dict, x: Tensor, cfg: ModelConfig, *,
                cache: Optional[Dict] = None, decode: bool = False
                ) -> Tuple[Tensor, Optional[Dict]]:
    """The full mixer.  x: (B, S, D) -> (B, S, D); ``decode`` means S == 1
    with ``cache``.  Returns (out, the new cache: None without a cache and
    outside decoding)."""
    cdt = _dtype(cfg.compute_dtype)
    g_, n_ = cfg.ssm_groups, cfg.ssm_state
    z = dense(p["wz"], x, cdt)
    xc = dense(p["wx"], x, cdt)
    bc = dense(p["wbc"], x, cdt)
    dt = dense(p["wdt"], x, cdt)
    dt = torch.logaddexp(dt.to(torch.float32) + p["dt_bias"],
                         torch.zeros((), dtype=torch.float32,
                                     device=x.device))           # (B,S,H)
    a = -torch.exp(p["a_log"])                                  # (H,)

    xc, new_conv_x = _causal_conv(
        xc, p["conv_x_w"].to(cdt), p["conv_x_b"].to(cdt),
        cache["conv_x"] if cache is not None else None)
    bc, new_conv_bc = _causal_conv(
        bc, p["conv_bc_w"].to(cdt), p["conv_bc_b"].to(cdt),
        cache["conv_bc"] if cache is not None else None)
    xh = xc.reshape(xc.shape[:-1] + (cfg.ssm_heads, cfg.ssm_head_dim))
    b = _expand_groups(bc[..., :g_ * n_].reshape(bc.shape[:-1] + (g_, n_)),
                       cfg.ssm_heads)
    c = _expand_groups(bc[..., g_ * n_:].reshape(bc.shape[:-1] + (g_, n_)),
                       cfg.ssm_heads)

    if decode:
        y1, new_ssm = ssd_step(cache["ssm"], xh[:, 0], dt[:, 0], a,
                               b[:, 0], c[:, 0])
        y = y1[:, None]
    else:
        y, new_ssm = ssd_chunked(xh, dt, a, b, c, cfg.ssm_chunk,
                                 cache["ssm"] if cache is not None else None)

    y = y + p["d_skip"][:, None] * xh.to(torch.float32)
    y = y.reshape(x.shape[0], x.shape[1], cfg.d_inner)
    y = rmsnorm(p["norm"], y * F.silu(z.to(torch.float32)), cfg.norm_eps)
    out = dense(p["out_proj"], y, cdt)
    new_cache = None
    if cache is not None or decode:
        ssm_dtype = x.dtype if cache is None else cache["ssm"].dtype
        new_cache = {"ssm": new_ssm.to(ssm_dtype), "conv_x": new_conv_x,
                     "conv_bc": new_conv_bc}
    return out.to(x.dtype), new_cache
