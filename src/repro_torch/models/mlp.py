"""Feed-forward blocks (``repro.models.mlp``): SwiGLU (llama family) and
GeLU (whisper / bigcode; ``jax.nn.gelu``'s default, the tanh form).

On a mesh (``par``) the block takes the residual's layout and gives it
back (``models.parallel``); where "ffn" splits over ``model`` the rank
holds its hidden units — ``wg`` / ``wu`` by columns (their bias sliced),
``wd`` by rows, its output summed over ``model`` before ``wd``'s bias."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense, dense_init
from repro_torch.models.parallel import (enter, row_parallel, slice_dim,
                                         splits)

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


def mlp(p: Dict, x: Tensor, mlp_type: str, compute_dtype, par=None
        ) -> Tensor:
    split = splits(par, "ffn")
    x = enter(par, x, "ffn")
    bias_d = None
    if split:
        p = dict(p)
        if "b" in p["wu"]:
            p["wu"] = {"w": p["wu"]["w"],
                       "b": slice_dim(p["wu"]["b"], par.mesh, par.tp, 0)}
        if "b" in p["wd"]:
            bias_d = par.on_slice(p["wd"]["b"])
            p["wd"] = {"w": p["wd"]["w"]}
    if mlp_type == "swiglu":
        gate = F.silu(dense(p["wg"], x, compute_dtype))
        up = dense(p["wu"], x, compute_dtype)
        h = gate * up
    else:
        h = F.gelu(dense(p["wu"], x, compute_dtype), approximate="tanh")
    y = row_parallel(par, p["wd"], h, "ffn", compute_dtype)
    if bias_d is not None:
        y = y + bias_d.to(compute_dtype)
    return y
