"""Feed-forward blocks (``repro.models.mlp``): SwiGLU (llama family) and
GeLU (whisper / bigcode; ``jax.nn.gelu``'s default, the tanh form)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, dense_init

Tensor = torch.Tensor


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str,
             dtype, lead=()) -> Dict:
    if mlp_type == "swiglu":
        return {
            "wg": dense_init(gen, d_model, d_ff, dtype, lead=lead),
            "wu": dense_init(gen, d_model, d_ff, dtype, lead=lead),
            "wd": dense_init(gen, d_ff, d_model, dtype, scale=0.5,
                             lead=lead),
        }
    if mlp_type == "gelu":
        return {
            "wu": dense_init(gen, d_model, d_ff, dtype, bias=True,
                             lead=lead),
            "wd": dense_init(gen, d_ff, d_model, dtype, scale=0.5,
                             bias=True, lead=lead),
        }
    raise ValueError(f"unknown mlp_type {mlp_type!r}")


def mlp(p: Dict, x: Tensor, mlp_type: str, compute_dtype) -> Tensor:
    if mlp_type == "swiglu":
        gate = F.silu(dense(p["wg"], x, compute_dtype))
        up = dense(p["wu"], x, compute_dtype)
        return dense(p["wd"], gate * up, compute_dtype)
    up = F.gelu(dense(p["wu"], x, compute_dtype), approximate="tanh")
    return dense(p["wd"], up, compute_dtype)
