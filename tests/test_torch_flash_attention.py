"""The train step's attention on the CPU: the dispatcher's choice, the
fused kernels' operand checks, and the fused kernels' arithmetic written
out blockwise in PyTorch.

The kernels themselves (``repro_torch/kernels/flash_attention.py``) run
only on a card (``tests/test_torch_cuda.py``).  Here the forward's online
softmax (base 2, ``p`` rounded against the running max, the log-sum-exp
kept) and the backward's formulas (P from the log-sum-exp, D from the
float32 output, dS as a bf16 hi / lo pair, dK / dV summed over a kv
head's query heads) are written out block by block, over the same loop
bounds as the kernels (``_q_range`` / ``_kv_range`` below copy the
arithmetic of ``q_range`` / ``kv_range`` in ``csrc/flash_attention.cu``;
the block pairs tested include every pair the kernels use), and held
against autograd of ``plain_attention``.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention

LOG2E = 1.4426950408889634


def _draw(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _grads(fn, q, k, v, dout):
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return [out.detach(), q.grad, k.grad, v.grad]


def _plain(causal, window):
    def fn(q, k, v):
        pos = torch.arange(q.shape[1])
        return attention.plain_attention(q, k, v, pos, pos, causal=causal,
                                         window=window)
    return fn


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else \
        t.view(torch.int32)


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [64, 8192, 9216])
def test_cpu_dispatch_keeps_todays_choice_bit_for_bit(s):
    """``train_attention`` on the CPU is the plain single tile up to 8,192
    positions and the chunked form above it (9,216 = 9 chunks of 1,024),
    the forward and the gradients bit for bit."""
    rng = np.random.default_rng(s)
    q, k, v, do = (_draw(rng, (1, s, 1, 8), torch.float32)
                   for _ in range(4))
    pos = torch.arange(s)

    def today(q_, k_, v_):
        if s <= 8192:
            return attention.plain_attention(q_, k_, v_, pos, pos)
        return attention.chunked_attention(q_, k_, v_, pos, pos,
                                           causal_skip=True)
    got = _grads(lambda a, b, c: attention.train_attention(
        a, b, c, pos, causal_skip=True), q, k, v, do)
    want = _grads(today, q, k, v, do)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


def test_cpu_dispatch_takes_the_chunked_form_above_the_limit(monkeypatch):
    """Which plain version each length takes (the lengths as above)."""
    seen = []
    monkeypatch.setattr(attention, "plain_attention",
                        lambda *a, **kw: seen.append("plain"))
    monkeypatch.setattr(attention, "chunked_attention",
                        lambda *a, **kw: seen.append(
                            ("chunked", kw["causal_skip"], kw["window"])))
    for s in (attention.PLAIN_MAX_LEN, attention.PLAIN_MAX_LEN + 1):
        q = torch.zeros(1, s, 1, 8)
        attention.train_attention(q, q, q, torch.arange(s), window=3,
                                  causal_skip=True)
    assert seen == ["plain", ("chunked", True, 3)]


def test_train_mixer_runs_the_dispatcher(monkeypatch):
    """The model's train step attends through ``train_attention``; prefill
    does not."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config("internvl2-1b", reduced_variant=True)
    calls = []
    real = attention.train_attention

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(attention, "train_attention", spy)
    params = transformer.init_lm_seeded(cfg, 0, device="cpu")
    tokens = torch.zeros(2, 12, dtype=torch.int32)
    transformer.forward_train(params, cfg, tokens)
    assert len(calls) == cfg.n_layers
    assert all(kw["causal"] and kw["window"] == 0 for kw in calls)


# ---------------------------------------------------------------------------
# the fused wrapper's checks
# ---------------------------------------------------------------------------

def test_fused_wrapper_refuses_what_the_kernels_do_not_take():
    q = torch.zeros(1, 16, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention(q[..., :48], k[..., :48], k[..., :48])
    with pytest.raises(ValueError, match="bfloat16 or all float32"):
        fa.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="bfloat16 or all float32"):
        fa.flash_attention(q, k.float(), k)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="do not group"):
        fa.flash_attention(q[:, :, :3], k, k)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, k[:, :8], k[:, :8])
    # off the CPU the dispatcher takes the fused op, which raises rather
    # than fall back
    meta = q.to("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        attention.train_attention(meta, meta, meta, torch.arange(16))
    # the CUDA source instantiates every head dim the wrapper lets through
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert "flash_attention.cu" in build.SOURCES
    assert all(f"case {hd}:" in src for hd in fa.HEAD_DIMS)


def test_fused_flop_formulas_count_the_visited_pairs():
    for s, causal, window in ((10, True, 0), (10, True, 3), (10, False, 0),
                              (10, False, 3), (10, True, 20), (333, True,
                                                               100)):
        i = torch.arange(s)[:, None]
        j = torch.arange(s)[None, :]
        ok = torch.ones(s, s, dtype=torch.bool)
        if causal:
            ok &= j <= i
        if window:
            ok &= j > i - window
        assert fa.visited_pairs(s, causal, window) == int(ok.sum())
    q = torch.zeros(2, 10, 4, 16, dtype=torch.bfloat16)
    pairs = 2 * 4 * 16 * 55
    assert fa._fwd_flops(q, q, q, True, 0) == 2 * 2 * pairs
    # the backward function's seven products in either dtype; the bf16
    # kernels' three hi / lo halves are their own cost, not the function's
    assert fa._bwd_flops(q, q, q, q, None, None, True, 0) == 7 * 2 * pairs
    assert fa._bwd_flops(q.float(), q.float(), q, q, None, None, True,
                         0) == 7 * 2 * pairs
    assert (fa.BWD_PRODUCTS, fa.BWD_PRODUCTS_RUN) == (7, 10)


# ---------------------------------------------------------------------------
# the kernels' loop bounds and arithmetic, blockwise in PyTorch
# ---------------------------------------------------------------------------

def _cdiv(a, b):
    return -(-a // b)


def _q_range(m0, s, causal, window, bm, bn):
    """The forward's and the dQ pass's kv columns for q rows [m0, m0 +
    bm): (lo, full_lo, full_hi, hi), as the kernels compute them."""
    hi, full_hi = s, (s // bn) * bn
    if causal:
        hi = min(m0 + bm, s)
        full_hi = min(full_hi, ((m0 + 1) // bn) * bn)
    lo = full_lo = 0
    if window:
        lo = (max(m0 - window + 1, 0) // bn) * bn
        full_lo = _cdiv(max(m0 + bm - window, 0), bn) * bn
    full_hi = max(full_hi, lo)
    full_lo = min(max(full_lo, lo), full_hi)
    return lo, full_lo, full_hi, hi


def _kv_range(n0, s, causal, window, bm, bn):
    """The dK / dV pass's q rows for kv rows [n0, n0 + bn)."""
    lo = full_lo = 0
    if causal:
        lo = (n0 // bm) * bm
        full_lo = _cdiv(n0 + bn - 1, bm) * bm
    hi, full_hi = s, (s // bm) * bm
    if window:
        hi = min(n0 + bn - 1 + window, s)
        full_hi = min(full_hi, ((n0 + window) // bm) * bm)
    full_hi = lo if n0 + bn > s else max(full_hi, lo)
    full_lo = min(max(full_lo, lo), full_hi)
    return lo, full_lo, full_hi, hi


def _allowed(rows, cols, s, causal, window):
    ok = (rows[:, None] < s) & (cols[None, :] < s)
    if causal:
        ok &= cols[None, :] <= rows[:, None]
    if window:
        ok &= cols[None, :] > rows[:, None] - window
    return ok


@pytest.mark.parametrize("blocks", [(128, 64), (64, 128), (16, 8), (8, 16),
                                    (32, 32), (64, 64), (64, 32), (32, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 5, 100, 1000])
def test_fused_loop_bounds_visit_every_kept_pair(blocks, causal, window):
    """Every kept (query, key) pair lies in a visited tile, and a tile
    visited without the mask keeps every pair in it."""
    bm, bn = blocks
    for s in (1, 7, 64, 100, 333):
        full = torch.zeros(s, s, dtype=torch.bool)
        full_t = torch.zeros(s, s, dtype=torch.bool)
        keep = _allowed(torch.arange(s), torch.arange(s), s, causal, window)
        for m0 in range(0, s, bm):
            lo, f_lo, f_hi, hi = _q_range(m0, s, causal, window, bm, bn)
            assert lo <= f_lo <= f_hi <= hi and lo % bn == f_lo % bn == 0
            assert window or lo == f_lo == 0      # the kernels skip it
            rows = torch.arange(m0, m0 + bm)
            for n0 in range(lo, hi, bn):
                cols = torch.arange(n0, min(n0 + bn, hi))
                if f_lo <= n0 < f_hi:
                    assert _allowed(rows, cols, 1 << 30, causal,
                                    window).all() and n0 + bn <= s
                full[m0:m0 + bm, n0:n0 + bn] = True
        for n0 in range(0, s, bn):
            lo, f_lo, f_hi, hi = _kv_range(n0, s, causal, window, bm, bn)
            assert lo <= f_lo <= f_hi <= hi <= s
            assert causal or lo == f_lo == 0      # the kernel skips it
            cols = torch.arange(n0, n0 + bn)
            for m0 in range(lo, hi, bm):
                rows = torch.arange(m0, m0 + bm)
                if f_lo <= m0 < f_hi:
                    assert _allowed(rows, cols, s, causal, window).all()
                full_t[m0:m0 + bm, n0:n0 + bn] = True
        assert bool((full | ~keep).all()) and bool((full_t | ~keep).all())


def _fwd_blocks(q, k, v, causal, window, bm, bn):
    """The forward kernel's arithmetic -> (out, out in float32, the base-2
    log-sum-exp (B, H, S))."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    c = (1.0 / math.sqrt(hd)) * LOG2E
    o32 = torch.zeros(b, s, h, hd)
    lse = torch.zeros(b, h, s)
    for bi in range(b):
        for hh in range(h):
            kk, vv = k[bi, :, hh // g].float(), v[bi, :, hh // g]
            for m0 in range(0, s, bm):
                rows = torch.arange(m0, min(m0 + bm, s))
                qq = q[bi, rows, hh].float()
                m = torch.full((len(rows),), float("-inf"))
                l = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), hd)
                lo, f_lo, f_hi, hi = _q_range(m0, s, causal, window, bm, bn)
                for n0 in range(lo, hi, bn):
                    cols = torch.arange(n0, min(n0 + bn, s))
                    sc = (qq @ kk[cols].T) * c
                    if not f_lo <= n0 < f_hi:
                        sc = torch.where(_allowed(rows, cols, s, causal,
                                                  window), sc, -1e30)
                    m_new = torch.maximum(m, sc.amax(1))
                    p = torch.exp2(sc - m_new[:, None])
                    alpha = torch.exp2(m - m_new)
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + p.to(v.dtype).float() @ \
                        vv[cols].float()
                    m = m_new
                o32[bi, rows, hh] = acc / l[:, None]
                lse[bi, hh, rows] = m + torch.log2(l)
    return o32.to(q.dtype), o32, lse


def _hi_lo(ds, dtype):
    """dS as it enters the tensor cores: one float32 operand, or the bf16
    pair hi = bf16(dS), lo = bf16(dS - hi)."""
    if dtype == torch.float32:
        return [ds]
    hi = ds.to(dtype)
    return [hi.float(), (ds - hi.float()).to(dtype).float()]


def _bwd_blocks(do, q, k, v, o32, lse, causal, window, fwd_blocks,
                dkv_blocks):
    """The backward kernels' arithmetic -> (dq, dk, dv) in q's dtype."""
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    scale = 1.0 / math.sqrt(hd)
    c = scale * LOG2E
    dt = q.dtype
    delta = (do.float() * o32).sum(-1).permute(0, 2, 1)       # (b, h, s)
    dq = torch.zeros(b, s, h, hd)
    dk = torch.zeros(b, s, n_kv, hd)
    dv = torch.zeros(b, s, n_kv, hd)
    bm, bn = dkv_blocks
    for bi in range(b):
        for kvh in range(n_kv):
            for n0 in range(0, s, bn):
                cols = torch.arange(n0, min(n0 + bn, s))
                kk, vv = k[bi, cols, kvh].float(), v[bi, cols, kvh].float()
                dk_acc = torch.zeros(len(cols), hd)
                dv_acc = torch.zeros(len(cols), hd)
                lo, f_lo, f_hi, hi = _kv_range(n0, s, causal, window, bm, bn)
                for hh in range(kvh * g, kvh * g + g):
                    for m0 in range(lo, hi, bm):
                        rows = torch.arange(m0, min(m0 + bm, s))
                        qq, dd = q[bi, rows, hh].float(), do[bi, rows, hh]
                        pt = torch.exp2((kk @ qq.T) * c
                                        - lse[bi, hh, rows][None, :])
                        if not f_lo <= m0 < f_hi:
                            pt = torch.where(_allowed(rows, cols, s, causal,
                                                      window).T, pt, 0.0)
                        for part in _hi_lo(pt, dt):
                            dv_acc += part @ dd.float()
                        dst = pt * (vv @ dd.float().T
                                    - delta[bi, hh, rows][None, :])
                        for part in _hi_lo(dst, dt):
                            dk_acc += part @ qq
                dk[bi, cols, kvh] = dk_acc * scale
                dv[bi, cols, kvh] = dv_acc
    bm, bn = fwd_blocks
    for bi in range(b):
        for hh in range(h):
            kk, vv = k[bi, :, hh // g].float(), v[bi, :, hh // g].float()
            for m0 in range(0, s, bm):
                rows = torch.arange(m0, min(m0 + bm, s))
                qq, dd = q[bi, rows, hh].float(), do[bi, rows, hh].float()
                acc = torch.zeros(len(rows), hd)
                lo, f_lo, f_hi, hi = _q_range(m0, s, causal, window, bm, bn)
                for n0 in range(lo, hi, bn):
                    cols = torch.arange(n0, min(n0 + bn, s))
                    p = torch.exp2((qq @ kk[cols].T) * c
                                   - lse[bi, hh, rows][:, None])
                    if not f_lo <= n0 < f_hi:
                        p = torch.where(_allowed(rows, cols, s, causal,
                                                 window), p, 0.0)
                    ds = p * (dd @ vv[cols].T - delta[bi, hh, rows][:, None])
                    for part in _hi_lo(ds, dt):
                        acc += part @ kk[cols]
                dq[bi, rows, hh] = acc * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _blockwise(causal, window, fwd_blocks=(16, 8), dkv_blocks=(8, 16)):
    """``_fwd_blocks`` with ``_bwd_blocks`` as its backward."""
    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            out, o32, lse = _fwd_blocks(q, k, v, causal, window,
                                        *fwd_blocks)
            ctx.save_for_backward(q, k, v, o32, lse)
            return out

        @staticmethod
        def backward(ctx, do):
            return _bwd_blocks(do, *ctx.saved_tensors, causal, window,
                               fwd_blocks, dkv_blocks)
    return Fn.apply


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


_CASES = [  # (B, S, H, KV, hd, causal, window)
    (2, 45, 4, 2, 8, True, 0),
    (1, 45, 6, 2, 16, False, 0),          # the encoder's mixer
    (2, 40, 3, 1, 8, True, 11),           # a sliding window
    (1, 33, 2, 2, 8, False, 7),
]


@pytest.mark.parametrize("case", _CASES)
def test_blockwise_formulas_in_float32_equal_autograd(case):
    """No bf16 rounding: the blockwise forward (online softmax, base 2)
    and backward (P from the log-sum-exp, D from O) agree with autograd of
    ``plain_attention`` up to the order of float32 sums (1e-5 relative
    L2)."""
    b, s, h, kv, hd, causal, window = case
    rng = np.random.default_rng(s + h)
    q, k, v, do = (_draw(rng, shape, torch.float32) for shape in (
        (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd)))
    got = _grads(_blockwise(causal, window), q, k, v, do)
    want = _grads(_plain(causal, window), q, k, v, do)
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel(a, w) <= 1e-5, name


@pytest.mark.parametrize("case", _CASES)
def test_blockwise_formulas_in_bf16_keep_the_plain_precision(case):
    """bf16 operands (``p`` rounded against the running max before PV, P
    and dS as hi / lo pairs, D from the float32 output) against the plain
    version in float32: the output's error at most 1.05x the plain bf16
    version's (both round ``p`` and the output to bf16; 0.96-0.99x on
    these cases), each gradient's at most 0.95x (0.55-0.88x; rounding P
    and dS once each instead reads 0.81-1.30x, dV's worst)."""
    b, s, h, kv, hd, causal, window = case
    rng = np.random.default_rng(s * h)
    q, k, v, do = (_draw(rng, shape, torch.bfloat16) for shape in (
        (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd)))
    f32 = [t.float() for t in (q, k, v, do)]
    want = _grads(_plain(causal, window), *f32)
    got = _grads(_blockwise(causal, window), q, k, v, do)
    plain = _grads(_plain(causal, window), q, k, v, do)
    for name, a, p, w, bound in zip(("out", "dq", "dk", "dv"), got, plain,
                                    want, (1.05, 0.95, 0.95, 0.95)):
        assert a.dtype == p.dtype == torch.bfloat16
        assert _rel(a, w) <= bound * _rel(p, w), name


def test_ds_pair_carries_more_than_one_bf16_rounding():
    """hi + lo reproduces dS to about 2^-16 relative, one bf16 rounding
    only to 2^-9."""
    ds = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    hi, lo = _hi_lo(ds, torch.bfloat16)
    assert _rel(hi + lo, ds) < 2 ** -15 < 2 ** -10 < _rel(hi, ds)
