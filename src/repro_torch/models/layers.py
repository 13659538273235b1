"""Shared neural-net building blocks (``repro.models.layers``): plain
functions on tensors, parameters in nested dicts of the reference's
layout, random draws from an explicit ``torch.Generator``."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def gen_device(gen) -> torch.device:
    """The device a draw from ``gen`` lands on; ``gen`` None draws
    nothing: shapes only, on the ``meta`` device."""
    return torch.device("meta") if gen is None else gen.device


def _normal(gen, shape) -> Tensor:
    """Standard normals of float32 on the generator's device."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 1.0, bias: bool = False, lead=()):
    """``{"w": (d_in, d_out)[, "b": (d_out,)]}`` with ``w`` drawn as
    ``scale / sqrt(d_in) · N(0, 1)``; ``lead`` prepends stacking axes."""
    w = (scale / (d_in ** 0.5)) * _normal(gen, tuple(lead) + (d_in, d_out))
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d_out,), dtype=dtype,
                             device=gen_device(gen))
    return p


def dense(p, x: Tensor, compute_dtype) -> Tensor:
    """``x @ w (+ b)`` in ``compute_dtype``."""
    y = torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype))
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
               lead=()) -> Tensor:
    return (0.02 * _normal(gen, tuple(lead) + (vocab, d_model))).to(dtype)


def rmsnorm_init(d: int, dtype, device=None, lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rmsnorm(p, x: Tensor, eps: float) -> Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(dt)


def layernorm_init(d: int, dtype, device=None, lead=()):
    shape = tuple(lead) + (d,)
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def layernorm(p, x: Tensor, eps: float) -> Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(dt)


# --- rotary position embedding ------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    """``1 / theta ** (2i / head_dim)`` in float32, on ``device`` (the
    base is a kernel argument: no host-to-device copy)."""
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(theta, expo)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to
    (..., S).  Angles, ``cos`` and ``sin`` in float32 (the reference's XLA
    ``sin``/``cos`` may differ from torch's in the last place)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
