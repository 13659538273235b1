"""Packed server phase benchmark through the PyTorch port: the per-leaf loop
against ONE fused FAIR-k pass over a transformer-shaped parameter tree
(the twin of ``benchmarks/packed_bench.py``, same rows and trees).

* ``per_leaf``     — one sampled-quantile estimation and one
  ``fairk_update`` launch per leaf (the threshold backend per leaf).
* ``packed``       — pack (g, g_prev, age) into the lane-aligned buffer,
  ONE sampled-quantile estimation and ONE fused pass, unpack.
* ``packed_warm``  — packed on a steady-state carried state: the warm
  thresholds are taken (the port computes the quantile pass all the same
  and chooses with ``torch.where``: no host sync).
* ``persisted``    — g_prev (bf16), age (int8) and the EF residual live
  flat across rounds: 1 pack (the fresh grads) and 1 unpack (g_t) per
  round; the legacy two-pass round reads g 3 times (bootstrap, kernel,
  count pass).
* ``persisted_ef`` / ``persisted_warm`` — plus the residual stage / on a
  warm carried state.
* ``fused_stats``  — counts and histograms out of the kernel: ONE read of
  g per round, thresholds from the carried statistics.
* ``adaptive``     — fused_stats plus the budget controller, its state
  carried as a vector (``controller_state_to_vec``).
* ``async``        — the double-buffered round: the straggler share of the
  fresh grads defers into ``shadow``, last round's share merges with
  ``age_lag`` extra age, the optimizer reads last round's ``pending``.
* ``sanitize``     — non-finite masking armed in the fused launch.
* ``chaos``        — the fault channels on: NaN/Inf corruption of the
  packed aggregate and deep-fade block erasures, degraded through the same
  sanitized launch.
* ``channel``      — the launch path's wireless round: the carried
  per-block AR(1) fading chain advances, outage blocks erase, the CSI
  factor multiplies the buffer, one sanitized launch.

The ``chaos`` and ``channel`` rounds draw on a ``torch.Generator`` on the
tree's device, given per call (two generators of one seed replay the same
round).

The dispatchers launch the CUDA kernels on the card; ``kernel_mode=
"plain"`` runs every builder on the plain PyTorch versions.  Times are
medians of single rounds (CUDA events on the card, the host clock on the
CPU).  Writes ``benchmarks/artifacts/torch_packed_bench.json``.
``--smoke`` runs a tiny tree on the CPU, asserts the structural
counters (launches, tree copies, reads of g per round) and writes them to
``benchmarks/artifacts/torch_packed_bench_smoke.json`` under the
reference gate's names (``tools/torch_check_bench_regression.py``).

  PYTHONPATH=src python -m benchmarks.torch_packed_bench [--full | --smoke]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Any, Callable, Dict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.core import channel, controller, faults  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.engine import (EngineConfig,  # noqa: E402
                                     SelectionEngine, index_jitter)
from repro_torch.device import DeviceLike, resolve_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

FAST_TREE = (12, 192, 8192)      # 99 leaves, 8,460,544 packed coordinates
FULL_TREE = (24, 320, 32000)     # 195 leaves, 49,996,288 packed
SKIPPED: Dict[str, str] = {}      # rows listed but not run: none


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def make_transformer_tree(n_layers: int, d_model: int, vocab: int,
                          seed: int = 0, device: DeviceLike = "cpu"):
    """Per-layer transformer tree of float32 tensors, the values of
    ``benchmarks.packed_bench.make_transformer_tree`` (one numpy stream,
    the same draw order)."""
    rng = np.random.default_rng(seed)
    ff = 4 * d_model

    def arr(*shape):
        return _tensor(rng.standard_normal(shape).astype("f4"), device)

    tree = {"embed": arr(vocab, d_model), "head": arr(d_model, vocab),
            "final_norm": arr(d_model)}
    for i in range(n_layers):
        tree[f"layer_{i:02d}"] = {
            "wq": arr(d_model, d_model), "wk": arr(d_model, d_model),
            "wv": arr(d_model, d_model), "wo": arr(d_model, d_model),
            "wu": arr(d_model, ff), "wd": arr(ff, d_model),
            "norm1": arr(d_model), "norm2": arr(d_model),
        }
    return tree


def server_state(tree, seed: int = 1):
    """(g_prev tree float32, age tree int8 in [0, 40)): the reference's
    ``_server_state`` draws, leaf by leaf in flattening order."""
    rng = np.random.default_rng(seed)
    leaves = tree_util.leaves(tree)
    paths = [p for p, _ in leaves]
    device = leaves[0][1].device
    g_prev = [_tensor(rng.standard_normal(tuple(leaf.shape)).astype("f4"),
                      device) for _, leaf in leaves]
    age = [_tensor(rng.integers(0, 40, tuple(leaf.shape)).astype("i1"),
                   device) for _, leaf in leaves]
    return (tree_util.unflatten(paths, g_prev),
            tree_util.unflatten(paths, age))


def _mk_engine(backend, d_or_layout, *, warm=False, rho=0.1,
               fused_stats=False, kernel_mode=None):
    cfg = EngineConfig(policy="fairk", backend=backend, rho=rho,
                       k_m_frac=0.75, warm_start=warm,
                       fused_stats=fused_stats, kernel_mode=kernel_mode)
    if backend == "packed":
        return SelectionEngine(cfg, d_or_layout.d_packed, layout=d_or_layout)
    return SelectionEngine(cfg, d_or_layout)


def _tree_map(fn, tree):
    leaves = tree_util.leaves(tree)
    return tree_util.unflatten([p for p, _ in leaves],
                               [fn(x) for _, x in leaves])


def build_per_leaf_fn(tree, kernel_mode=None):
    """One threshold engine per leaf: a quantile estimation and a fused
    launch each."""
    leaves = [leaf for _, leaf in tree_util.leaves(tree)]
    engines = [_mk_engine("threshold", leaf.numel(),
                          kernel_mode=kernel_mode) for leaf in leaves]
    paths = [p for p, _ in tree_util.leaves(tree)]

    def per_leaf(g_tree, gp_tree, age_tree):
        gs, gps, ages = ([x for _, x in tree_util.leaves(t)]
                         for t in (g_tree, gp_tree, age_tree))
        out_g, out_age = [], []
        for eng, g, gp, ag in zip(engines, gs, gps, ages):
            g_t, age_next, _ = eng.select_and_merge(
                g.reshape(-1), gp.reshape(-1).to(torch.float32),
                ag.reshape(-1).to(torch.float32))
            out_g.append(g_t.view(g.shape))
            out_age.append(age_next.view(g.shape).to(torch.int8))
        return (tree_util.unflatten(paths, out_g),
                tree_util.unflatten(paths, out_age))

    return per_leaf, len(leaves)


def build_packed_fn(tree, *, warm, kernel_mode=None):
    """Re-pack the state trees every round: 3 packs, 2 unpacks."""
    layout = packing.PackedLayout.from_tree(tree)
    eng = _mk_engine("packed", layout, warm=warm, kernel_mode=kernel_mode)

    def packed(g_tree, gp_tree, age_tree, tstate):
        g_t, age_tree_out, stats = eng.select_and_merge_tree(
            g_tree, gp_tree, age_tree, tstate=tstate)
        return (g_t, _tree_map(lambda x: x.to(torch.int8), age_tree_out),
                stats["tstate"])

    return packed, layout, eng


def build_persisted_fn(tree, *, warm, error_feedback=False,
                       fused_stats=False, kernel_mode=None):
    """Flat carried state (g_prev bf16, age int8, the EF residual f32):
    only the fresh grads are packed, only g_t is unpacked."""
    layout = packing.PackedLayout.from_tree(tree)
    eng = _mk_engine("packed", layout, warm=warm, fused_stats=fused_stats,
                     kernel_mode=kernel_mode)

    def persisted(g_tree, gp_flat, age_flat, res_flat, tstate):
        g_flat = layout.pack(g_tree)           # the only pack per round
        g_t, age_next, stats = eng.select_and_merge(
            g_flat, gp_flat, age_flat, tstate=tstate, residual=res_flat)
        g_t_tree = layout.unpack(g_t, cast=False)   # optimizer-facing tree
        return (g_t_tree, g_t.to(torch.bfloat16), age_next.to(torch.int8),
                stats.get("residual"), stats["tstate"])

    def flat_state(gp_tree, age_tree):
        gp = layout.pack(gp_tree).to(torch.bfloat16)
        ag = layout.pack_age(age_tree).to(torch.int8)
        res = (torch.zeros(layout.d_packed, dtype=torch.float32,
                           device=gp.device) if error_feedback else None)
        return gp, ag, res

    return persisted, flat_state, layout


def build_adaptive_fn(tree, *, rho=0.1, kernel_mode=None):
    """The persisted fused-stats round plus the budget controller, whose
    state is carried as one vector."""
    layout = packing.PackedLayout.from_tree(tree)
    eng = _mk_engine("packed", layout, warm=True, rho=rho, fused_stats=True,
                     kernel_mode=kernel_mode)
    bc = controller.BudgetController(rho=rho)

    def adaptive(g_tree, gp_flat, age_flat, tstate, cvec):
        cs = controller.controller_state_from_vec(cvec)
        g_flat = layout.pack(g_tree)
        g_t, age_next, stats = eng.select_and_merge(
            g_flat, gp_flat, age_flat, tstate=tstate,
            k_m_frac=cs["k_m_frac"])
        cs = bc.update(cs, stats["age_hist"], stats["mag_hist"])
        g_t_tree = layout.unpack(g_t, cast=False)
        return (g_t_tree, g_t.to(torch.bfloat16), age_next.to(torch.int8),
                stats["tstate"], controller.controller_state_to_vec(cs))

    return adaptive, layout


def build_async_fn(tree, *, rho=0.1, straggler_frac=0.25, straggler_lag=1,
                   kernel_mode=None):
    """The double-buffered round: the optimizer-facing unpack reads the
    carried ``pending`` buffer only (``critical_path``)."""
    layout = packing.PackedLayout.from_tree(tree)
    eng = _mk_engine("packed", layout, warm=True, rho=rho, fused_stats=True,
                     kernel_mode=kernel_mode)
    device = tree_util.leaves(tree)[0][1].device
    # the straggler share is fixed per coordinate: built once
    strag = (index_jitter(layout.d_packed, device=device)
             < straggler_frac).to(torch.float32)

    def async_round(g_tree, gp_flat, age_flat, tstate, shadow, pending):
        g_flat = layout.pack(g_tree)
        new_shadow = (g_flat * strag).to(torch.bfloat16)
        g_flat = g_flat * (1.0 - strag) + shadow.to(torch.float32)
        g_t, age_next, stats = eng.select_and_merge(
            g_flat, gp_flat, age_flat, tstate=tstate, age_lag=straggler_lag)
        out_tree = layout.unpack(pending.to(torch.float32), cast=False)
        return (out_tree, g_t.to(torch.bfloat16), age_next.to(torch.int8),
                stats["tstate"], new_shadow, g_t.to(torch.bfloat16),
                stats["sel_mask"])

    def critical_path(pending):
        return layout.unpack(pending.to(torch.float32), cast=False)

    return async_round, critical_path, layout


def build_sanitize_fn(tree, *, rho=0.1, kernel_mode=None):
    """The fused round with non-finite masking armed, no faults
    injected."""
    layout = packing.PackedLayout.from_tree(tree)
    eng = _mk_engine("packed", layout, warm=True, rho=rho, fused_stats=True,
                     kernel_mode=kernel_mode)

    def sanitize_round(g_tree, gp_flat, age_flat, tstate):
        g_flat = layout.pack(g_tree)
        g_t, age_next, stats = eng.select_and_merge(
            g_flat, gp_flat, age_flat, tstate=tstate, sanitize=True)
        g_t_tree = layout.unpack(g_t, cast=False)
        return (g_t_tree, g_t.to(torch.bfloat16), age_next.to(torch.int8),
                stats["tstate"])

    return sanitize_round, layout


def build_chaos_fn(tree, *, rho=0.1, fade=0.05, nan_rate=1e-4,
                   kernel_mode=None):
    """The fused round with the fault channels on: ``faults.corrupt`` on
    the packed aggregate and ``faults.fade_mask`` erasures, degraded
    through the sanitized launch — elementwise work, no extra read of g,
    no extra tree copy."""
    layout = packing.PackedLayout.from_tree(tree)
    eng = _mk_engine("packed", layout, warm=True, rho=rho, fused_stats=True,
                     kernel_mode=kernel_mode)
    fcfg = faults.FaultConfig(fade=fade, nan_rate=nan_rate)
    d = layout.d_packed
    nb = -(-d // fcfg.fade_block)

    def chaos_round(g_tree, gp_flat, age_flat, tstate, gen):
        g_flat = layout.pack(g_tree)           # the only pack per round
        dev = g_flat.device
        u_c = torch.rand(d, generator=gen, device=dev)
        u_f = torch.rand(nb, generator=gen, device=dev)
        g_flat = faults.corrupt(g_flat, u_c, fcfg)
        erase = faults.fade_mask(u_f, d, fcfg)
        g_t, age_next, stats = eng.select_and_merge(
            g_flat, gp_flat, age_flat, tstate=tstate, erase=erase,
            sanitize=True)
        g_t_tree = layout.unpack(g_t, cast=False)
        return (g_t_tree, g_t.to(torch.bfloat16), age_next.to(torch.int8),
                stats["tstate"])

    return chaos_round, layout


def build_channel_fn(tree, *, rho=0.1, pmax=10.0, gmin=0.3, csi_err=0.05,
                     kernel_mode=None):
    """The fused round with the wireless layer on: the carried (2 nb,)
    per-block fading chain advances (``channel.block_outage``), outage
    blocks erase through the sanitized launch and the CSI factor
    (``channel.csi_block_factor``) multiplies the packed buffer.  Returns
    ``(channel_round, fad0, layout)``, ``fad0`` the cold start
    ``channel.init_block_fading``."""
    layout = packing.PackedLayout.from_tree(tree)
    eng = _mk_engine("packed", layout, warm=True, rho=rho, fused_stats=True,
                     kernel_mode=kernel_mode)
    ccfg = channel.ChannelConfig(n_clients=16, pmax=pmax, gmin=gmin,
                                 csi_err=csi_err, rho_f=0.5)
    d = layout.d_packed
    nb = channel.n_blocks(d, ccfg)

    def channel_round(g_tree, gp_flat, age_flat, tstate, fad, gen):
        g_flat = layout.pack(g_tree)           # the only pack per round
        dev = g_flat.device
        w = torch.randn(nb, 2, generator=gen, device=dev)
        e = torch.randn(nb, generator=gen, device=dev)
        new_fad, erase = channel.block_outage(fad, w, d, ccfg)
        g_flat = g_flat * channel.csi_block_factor(e, d, ccfg)
        g_t, age_next, stats = eng.select_and_merge(
            g_flat, gp_flat, age_flat, tstate=tstate, erase=erase,
            sanitize=True)
        g_t_tree = layout.unpack(g_t, cast=False)
        return (g_t_tree, g_t.to(torch.bfloat16), age_next.to(torch.int8),
                stats["tstate"], new_fad)

    device = tree_util.leaves(tree)[0][1].device
    return channel_round, channel.init_block_fading(nb, device), layout


def counted(fn: Callable, *args):
    """(output, (fused launches, packs, unpacks, reads of g)) of one call:
    the structural counters' increments."""
    before = (ops.FAIRK_UPDATE_CALLS, packing.PACK_CALLS,
              packing.UNPACK_CALLS, packing.G_READS)
    out = fn(*args)
    after = (ops.FAIRK_UPDATE_CALLS, packing.PACK_CALLS,
             packing.UNPACK_CALLS, packing.G_READS)
    return out, tuple(a - b for a, b in zip(after, before))


def timed_med(fn: Callable, repeats: int = 5):
    """(median µs of one call, last output) after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    out = fn()
    ts = []
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    for _ in range(max(repeats, 1)):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b) * 1e3)
        else:
            t0 = time.perf_counter()
            out = fn()
            ts.append((time.perf_counter() - t0) * 1e6)
    return float(statistics.median(ts)), out


def warm_state(ts: Dict[str, torch.Tensor], k: int) -> Dict[str, Any]:
    """A steady-state carried state: counts on the budget, the prediction
    streak established (the reference bench's ``ts_warm``)."""
    dev = ts["theta_m"].device

    def f(v):
        return torch.full((), float(v), dtype=torch.float32, device=dev)
    return dict(ts, n_sel=f(k), n_sel_m=f(round(0.75 * k)), init=f(1.0),
                streak=f(10.0))


def bench_tree(n_layers, d_model, vocab, repeats=5, device: DeviceLike = None):
    """Structural counters of every row and its median round time."""
    dev = resolve_device(device)
    tree = make_transformer_tree(n_layers, d_model, vocab, device=dev)
    g_prev, age = server_state(tree)
    layout = packing.PackedLayout.from_tree(tree)
    k = _mk_engine("packed", layout).budgets()[0]
    ts0 = packing.init_threshold_state(dev)
    res = {"n_leaves": layout.n_leaves, "d_valid": layout.d_valid,
           "d_packed": layout.d_packed, "k": k,
           "skipped": dict(SKIPPED)}
    persisted_fn, flat_state, _ = build_persisted_fn(tree, warm=False)
    gp_flat, age_flat, _ = flat_state(g_prev, age)
    res_flat = torch.zeros(layout.d_packed, dtype=torch.float32, device=dev)

    def row(name, fn, *args):
        (out, cnt) = counted(fn, *args)
        res[f"counts_{name}"] = dict(zip(("fused_calls", "packs", "unpacks",
                                          "g_reads"), cnt))
        us, out = timed_med(lambda: fn(*args), repeats)
        res[f"{name}_us"] = us
        return out

    per_leaf_fn, _ = build_per_leaf_fn(tree)
    row("per_leaf", per_leaf_fn, tree, g_prev, age)
    packed_fn, _, _ = build_packed_fn(tree, warm=False)
    _, _, ts1 = row("packed", packed_fn, tree, g_prev, age, ts0)
    warm_fn, _, _ = build_packed_fn(tree, warm=True)
    row("packed_warm", warm_fn, tree, g_prev, age, warm_state(ts1, k))
    row("persisted", persisted_fn, tree, gp_flat, age_flat, None, ts0)
    warm_p, _, _ = build_persisted_fn(tree, warm=True)
    _, _, _, _, ts_p = persisted_fn(tree, gp_flat, age_flat, None, ts0)
    row("persisted_warm", warm_p, tree, gp_flat, age_flat, None,
        warm_state(ts_p, k))
    ef_fn, _, _ = build_persisted_fn(tree, warm=False, error_feedback=True)
    row("persisted_ef", ef_fn, tree, gp_flat, age_flat, res_flat, ts0)
    fused_fn, _, _ = build_persisted_fn(tree, warm=True, fused_stats=True)
    _, _, _, _, ts_f = fused_fn(tree, gp_flat, age_flat, None, ts0)
    ts_fused = warm_state(ts_f, k)
    row("fused_stats", fused_fn, tree, gp_flat, age_flat, None, ts_fused)
    adaptive_fn, _ = build_adaptive_fn(tree)
    cvec = controller.controller_state_to_vec(
        controller.init_controller_state(0.75, dev))
    for frac in (0.25, 0.5, 0.9):
        cvec = adaptive_fn(tree, gp_flat, age_flat, ts0,
                           controller.controller_state_to_vec(
                               controller.init_controller_state(
                                   frac, dev)))[4]
    row("adaptive", adaptive_fn, tree, gp_flat, age_flat, ts_fused, cvec)
    async_fn, crit_fn, _ = build_async_fn(tree)
    row("async", async_fn, tree, gp_flat, age_flat, ts_fused, gp_flat,
        gp_flat)
    res["async_critical_path_us"], _ = timed_med(lambda: crit_fn(gp_flat),
                                                 repeats)
    res["overlap_ratio"] = 1.0 - (res["async_critical_path_us"]
                                  / res["async_us"])
    san_fn, _ = build_sanitize_fn(tree)
    row("sanitize", san_fn, tree, gp_flat, age_flat, ts_fused)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    chaos_fn, _ = build_chaos_fn(tree)
    row("chaos", chaos_fn, tree, gp_flat, age_flat, ts_fused, gen)
    channel_fn, fad0, _ = build_channel_fn(tree)
    row("channel", channel_fn, tree, gp_flat, age_flat, ts_fused, fad0, gen)
    for a, b, name in (("per_leaf", "packed", "speedup_packed"),
                       ("persisted", "fused_stats", "speedup_fused_stats"),
                       ("packed", "persisted", "persisted_vs_repack"),
                       ("fused_stats", "adaptive", "adaptive_vs_fused"),
                       ("fused_stats", "sanitize", "sanitize_vs_fused"),
                       ("sanitize", "chaos", "chaos_vs_sanitize"),
                       ("sanitize", "channel", "channel_vs_sanitize"),
                       ("fused_stats", "async", "async_vs_fused")):
        res[name] = res[f"{a}_us"] / res[f"{b}_us"]
    return res


ROWS = ("per_leaf", "packed", "packed_warm", "persisted", "persisted_warm",
        "persisted_ef", "fused_stats", "adaptive", "async", "sanitize",
        "chaos", "channel")


def run(fast: bool = True, device: DeviceLike = None, repeats: int = 5):
    """CSV rows ``(name, µs, derived)`` and the detail payload for the fast
    tree (12, 192, 8192) or, with ``fast=False``, the ``--full`` tree (24,
    320, 32000)."""
    shape = FAST_TREE if fast else FULL_TREE
    res = bench_tree(*shape, repeats=repeats, device=device)
    rows = []
    for name in ROWS:
        c = res[f"counts_{name}"]
        rows.append((f"torch_packed/{name}", res[f"{name}_us"],
                     f"launches={c['fused_calls']} packs={c['packs']} "
                     f"unpacks={c['unpacks']} reads={c['g_reads']}"))
    for name, why in SKIPPED.items():
        rows.append((f"torch_packed/{name}", float("nan"),
                     f"skipped: needs {why}"))
    detail = {"tree": dict(zip(("n_layers", "d_model", "vocab"), shape)),
              **res,
              "note": "medians of single rounds; packed_warm and "
                      "persisted_warm compute the quantile pass and choose "
                      "the warm thresholds with torch.where (no host "
                      "sync), so they read g as often as the cold rounds"}
    out_dir = os.path.join(os.path.dirname(__file__), "artifacts")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "torch_packed_bench.json"), "w") as f:
        json.dump(detail, f, indent=1)
    return rows, detail


SMOKE_COUNTS = {
    "packed": (1, 3, 2, 3), "packed_warm": (1, 3, 2, 3),
    "persisted": (1, 1, 1, 3), "persisted_warm": (1, 1, 1, 3),
    "persisted_ef": (1, 1, 1, 3), "fused_stats": (1, 1, 1, 1),
    "adaptive": (1, 1, 1, 1), "async": (1, 1, 1, 1),
    "sanitize": (1, 1, 1, 1), "chaos": (1, 1, 1, 1),
    "channel": (1, 1, 1, 1)}


def gate_counters(res: dict) -> dict:
    """The structural counters under the names of the reference's gate
    (``tools/check_bench_regression.py``): reads of g, fused launches and
    ``[packs, unpacks]`` per row."""
    out = {"g_reads_persisted": res["counts_persisted"]["g_reads"],
           "copies_persisted": [res["counts_persisted"]["packs"],
                                res["counts_persisted"]["unpacks"]],
           "fused_calls_packed": res["counts_packed"]["fused_calls"]}
    for name in ("fused_stats", "adaptive", "async", "sanitize", "chaos",
                 "channel"):
        c = res[f"counts_{name}"]
        out[f"g_reads_{name}"] = c["g_reads"]
        out[f"copies_{name}"] = [c["packs"], c["unpacks"]]
        out[f"fused_calls_{name}"] = c["fused_calls"]
    return out


def smoke(device: DeviceLike = None) -> dict:
    """The structural claims on a tiny tree (2, 32, 256): the packed round
    launches ONE fused update against one per leaf; a persisted round
    makes 1 pack and 1 unpack (the re-pack round 3 and 2); the fused-stats
    round reads g once against 3 on the legacy round; the adaptive, async,
    sanitize, chaos and channel rounds keep all of these; the async
    critical path is a strict part of the round."""
    res = bench_tree(2, 32, 256, repeats=1, device=device)
    c = res["counts_per_leaf"]
    assert c["fused_calls"] == res["n_leaves"] == c["g_reads"] // 2, res
    for name, want in SMOKE_COUNTS.items():
        got = tuple(res[f"counts_{name}"][key] for key in
                    ("fused_calls", "packs", "unpacks", "g_reads"))
        assert got == want, (name, got, want)
    assert 0.0 < res["overlap_ratio"] < 1.0, res
    res.update(gate_counters(res))
    out_dir = os.path.join(os.path.dirname(__file__), "artifacts")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "torch_packed_bench_smoke.json"),
              "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    print(f"[torch_packed_bench --smoke] OK: 1 fused call vs "
          f"{res['n_leaves']} per leaf; persisted round 1 pack + 1 unpack; "
          f"fused-stats round 1 read of g vs 3; adaptive, async, "
          f"sanitize, chaos and channel rounds likewise; overlap_ratio "
          f"{res['overlap_ratio']:.3f}")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.smoke:
        smoke(args.device)
        return
    rows, detail = run(fast=not args.full, device=args.device)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
