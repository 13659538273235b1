"""Fused causal / windowed grouped-query attention for the train step,
forward and backward (``flash_attention``), over the CUDA C++ kernels of
``csrc/flash_attention.cu``.

Replaces no Pallas kernel: the reference's ``plain_attention``
(``src/repro/models/attention.py``) is ``jnp`` left to XLA.  Added
because the port's plain version writes and re-reads a float32 score
tensor of (B, H, S, S) per layer in the forward pass, the checkpoint's
recompute and the backward pass (7.5 GB a layer at 8 x 4,096 positions
and 14 heads), and runs its products as float32 einsums on the CUDA
cores: it took 88% of a train round on internvl2-1b.

Bound on the H100: tensor-core FLOPs.  Causal QK^T and PV are
2 * 2 * B * H * pairs * hd FLOPs a forward pass (2.4e11 at 8 x 4,096,
14 heads of 64: 0.243 ms at 989 TFLOP/s).  The function's backward needs
``BWD_PRODUCTS`` = 7 such products (QK^T and dO V^T recomputed, P^T dO,
dS K and dS^T Q; 0.85 ms), and the FLOP formula the dry run reads counts
those.  In bf16 the kernels run ``BWD_PRODUCTS_RUN`` = 10: P and dS enter
their products as bf16 hi / lo pairs (hi = bf16(x), lo = bf16(x - hi)),
so that neither is rounded once to bf16 where the plain version keeps it
in float32 (with one rounding of the normalised P, dV's error measured
1.08-1.30x the plain bf16 path's; with the pair 0.74-0.88x).  The bytes
(q, k, v, o and the gradients, once each) are three orders of magnitude
below the FLOPs at the card's 295 FLOP/byte.

Design (FlashAttention-2's shape on ``mma.sync``; the source's header has
it in full): the forward runs a block per (q block, batch x head), the
longest q blocks first, K / V tiles double-buffered through shared memory
with ``cp.async``, an online softmax in float32 with ``exp2`` and the
scale times log2(e) folded into one multiplier, ``p`` rounded to bf16
against the running max before PV (as ``chunked_attention`` rounds it);
it writes the output in q's dtype, the same output in float32 (the
backward's D reads it) and the base-2 log-sum-exp.  The backward runs D
= rowsum(dO * O32), then a block per (kv block, batch x kv head) that
loops over its g query heads and the q blocks that see it, summing dK /
dV in registers, then a block per (q block, batch x head) for dQ.  Only
tiles that cross a boundary (diagonal, window edge, ragged end) test each
pair.  No atomics: two runs give the same bits.

q is (B, S, H, hd), k and v (B, S, KV, hd) with H a multiple of KV
(query head h reads kv head h // (H / KV)), each read in place through
its strides (the last one 1).  Positions are the indices 0 .. S - 1, the
``arange`` the train step builds; ``causal`` keeps key j <= query i,
``window`` (0: none) keeps j > i - window, as ``_chunk_attend`` masks.
Types: bf16 (tensor-core products, float32 accumulation) and float32
(IEEE float32 products on the CUDA cores, no rounding of ``p``, P or
``dS``); head dims 16, 32, 64 and 128.  Anything else raises
``ValueError``, and so does a bf16 q, k or v whose rows do not start on
16 bytes (a launch checks; the train step's views all do).

Each launch group is a ``torch.library`` operator
(``repro_torch::flash_attn_fwd``, ``repro_torch::flash_attn_bwd``) with
a fake implementation, so a step traces under ``FakeTensorMode``;
``flash_attention`` ties them together in a ``torch.autograd.Function``.
``ATTENTION_FWD_LAUNCHES`` counts forward kernel launches (one a call),
``ATTENTION_BWD_LAUNCHES`` backward kernel launches (three a call).  The
kernels build with the port's others (``build.py``) at the first launch.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.fairk_update import LIB

Tensor = torch.Tensor

ATTENTION_FWD_LAUNCHES = 0
ATTENTION_BWD_LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.bfloat16, torch.float32)
BWD_PRODUCTS = 7              # the backward function's products
BWD_PRODUCTS_RUN = 10         # the bf16 kernels' (P and dS as hi / lo)


# ---------------------------------------------------------------------------
# checks and launches
# ---------------------------------------------------------------------------

def check_operands(q: Tensor, k: Tensor, v: Tensor) -> None:
    """Raise ``ValueError`` on what the kernels do not take: shapes,
    types and head dims first, the device last."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, H, hd) and k, v (B, S, KV, hd) "
                         f"alike; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, n_heads, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd):
        raise ValueError(f"k / v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch, length or head dim")
    n_kv = k.shape[2]
    if (n_kv == 0) != (n_heads == 0) or (n_kv and n_heads % n_kv):
        raise ValueError(f"{n_heads} query heads do not group over {n_kv} "
                         f"kv heads")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be bfloat16 or all float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one of {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must lie on a CUDA device, got "
                             f"{t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if t.numel() and t.stride(3) != 1:
            raise ValueError(f"{name} must have a unit stride in the head "
                             f"dim, got strides {t.stride()}")


def _aligned(t: Tensor) -> bool:
    """Whether the kernels can read ``t``'s rows in place: a bf16 row
    starts on 16 bytes, as ``cp.async`` copies it (any float32 row)."""
    return t.dtype != torch.bfloat16 or (t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st in t.stride()[:3]))


def _check_aligned(q: Tensor, k: Tensor, v: Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _aligned(t):
            raise ValueError(f"{name}'s bf16 rows must start on 16 bytes "
                             f"(address {t.data_ptr()}, strides "
                             f"{t.stride()})")


def _dims(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
          out: Tensor, dout: Tensor = None, dk: Tensor = None):
    """The kernels' shape, flags and strides (``csrc/flash_attention.cu``
    ``params``), as a C array of 26 ``long long``."""
    b, s, n_heads, hd = q.shape
    vals = [b, s, n_heads, k.shape[2], hd, int(causal), int(window),
            int(q.dtype == torch.float32)]
    for t in (q, k, v, out, dout if dout is not None else out,
              dk if dk is not None else k):
        vals.extend(t.stride()[:3])
    return (ctypes.c_longlong * len(vals))(*vals)


def _fwd_launch(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                window: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The forward launch -> (out in q's dtype, out in float32, the
    base-2 log-sum-exp (B, H, S))."""
    global ATTENTION_FWD_LAUNCHES
    check_operands(q, k, v)
    _check_aligned(q, k, v)
    b, s, n_heads, _ = q.shape
    lib = build.load()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    out32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, n_heads, s), dtype=torch.float32, device=q.device)
    dims = _dims(q, k, v, causal, window, out)
    p = build.ptr
    rc = lib.repro_flash_attn_fwd(
        p(q), p(k), p(v), p(out), p(out32), p(lse),
        ctypes.cast(dims, ctypes.c_void_p),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attn_fwd")
    ATTENTION_FWD_LAUNCHES += 1
    return out, out32, lse


def _fwd_fake(q, k, v, causal, window):
    b, s, n_heads, _ = q.shape
    return (torch.empty_like(q), torch.empty_like(q, dtype=torch.float32),
            q.new_empty((b, n_heads, s), dtype=torch.float32))


def _bwd_launch(dout: Tensor, q: Tensor, k: Tensor, v: Tensor, out32: Tensor,
                lse: Tensor, causal: bool, window: int
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """The backward's three launches -> (dq, dk, dv) in q's dtype."""
    global ATTENTION_BWD_LAUNCHES
    check_operands(q, k, v)
    _check_aligned(q, k, v)
    if dout.stride(3) != 1 or not _aligned(dout):   # autograd's, not ours
        dout = dout.clone(memory_format=torch.contiguous_format)
    b, s, n_heads, _ = q.shape
    lib = build.load()
    delta = torch.empty((b, n_heads, s), dtype=torch.float32,
                        device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    # out32 and dq are both contiguous (B, S, H, hd): one set of strides
    dims = _dims(q, k, v, causal, window, dq, dout, dk)
    p = build.ptr
    rc = lib.repro_flash_attn_bwd(
        p(dout), p(q), p(k), p(v), p(out32.contiguous()), p(lse), p(delta),
        p(dq), p(dk), p(dv), ctypes.cast(dims, ctypes.c_void_p),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attn_bwd")
    ATTENTION_BWD_LAUNCHES += 3
    return dq, dk, dv


def _bwd_fake(dout, q, k, v, out32, lse, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


LIB.define("flash_attn_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
           "int window) -> (Tensor, Tensor, Tensor)")
LIB.define("flash_attn_bwd(Tensor dout, Tensor q, Tensor k, Tensor v, "
           "Tensor out32, Tensor lse, bool causal, int window) "
           "-> (Tensor, Tensor, Tensor)")
for _name, _launch, _fake in (("flash_attn_fwd", _fwd_launch, _fwd_fake),
                              ("flash_attn_bwd", _bwd_launch, _bwd_fake)):
    LIB.impl(_name, _launch, "CompositeExplicitAutograd")
    torch.library.register_fake(f"repro_torch::{_name}", _fake, lib=LIB)
flash_attn_fwd_op = torch.ops.repro_torch.flash_attn_fwd.default
flash_attn_bwd_op = torch.ops.repro_torch.flash_attn_bwd.default


def visited_pairs(s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask keeps at positions 0 .. s - 1."""
    w = min(window, s) if window > 0 else s
    if causal:
        return w * (w + 1) // 2 + (s - w) * w
    return s * s - (s - w + 1) * (s - w) // 2 if window > 0 else s * s


def _products(q, causal, window) -> int:
    """FLOPs of one (B, H, pairs, hd) product pair-by-pair."""
    b, s, n_heads, hd = q.shape
    return 2 * b * n_heads * hd * visited_pairs(s, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attn_fwd, get_raw=True)
def _fwd_flops(q, k, v, causal, window, *args, out_val=None, **kwargs):
    return 2 * _products(q, causal, window)              # QK^T, PV


@register_flop_formula(torch.ops.repro_torch.flash_attn_bwd, get_raw=True)
def _bwd_flops(dout, q, k, v, out32, lse, causal, window, *args,
               out_val=None, **kwargs):
    # the function's products (``BWD_PRODUCTS``); the bf16 kernels' hi /
    # lo halves are their own cost and not counted here
    return BWD_PRODUCTS * _products(q, causal, window)


class _FlashAttention(torch.autograd.Function):
    """The fused forward; its backward is the fused backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, out32, lse = flash_attn_fwd_op(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out32, lse = ctx.saved_tensors
        dq, dk, dv = flash_attn_bwd_op(dout, q, k, v, out32, lse,
                                       ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0) -> Tensor:
    """Attention of q (B, S, H, hd) over k, v (B, S, KV, hd) at positions
    0 .. S - 1 -> (B, S, H, hd) in q's dtype, differentiable.  Raises
    ``ValueError`` on an operand the kernels do not take (a CPU tensor
    among them); a rank with no heads gets its empty output without a
    launch."""
    check_operands(q, k, v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.shape[2] == 0 or q.shape[1] == 0 or q.shape[0] == 0:
        return q.clone()
    return _FlashAttention.apply(q, k, v, bool(causal), int(window))
