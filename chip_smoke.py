#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU (an H100) and hold
its CUDA kernels against their plain PyTorch versions.

Run from the root of a checkout:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # card, build and kernel checks only

Phases (any failed check exits non-zero; no phase catches its own
failure):

1. card: ``nvidia-smi`` name and power limit, torch's device name, count;
2. build: the five kernels' four sources from
   ``src/repro_torch/kernels/csrc`` for ``sm_90a``, compiled in parallel,
   with the build time and the ``-Xptxas -v`` report;
3. kernels against their plain versions at the shapes their paths give
   them (d = 109,210 and the exact one-bit row of k = 21,842; the sweep's
   80 × 2,048 block for ``aou_merge``'s mask form; fig 9's fold of 50 ×
   112,346 at 22,469 and its detection at 22,469; 2^24 for
   ``fairk_update``, ``aou_merge`` and ``block_topk``, ties included, and
   ``block_topk`` on NaN, ±inf, blocks of one value and m = block_size;
   the one-bit chunk fold ``ops.vote_fold`` dense, gathered and weighted
   per client (the wireless route: zero, negative and NaN weights), the
   detection fed the draw ``z`` with and without the packed path's
   score, and the exact path's state updates, ``aou_merge``'s index form
   for the trainer and the engine at k = 10,921 and 21,842): merged
   values, masks and counts bit for bit, ages, counts, histograms, signs,
   energies, folded accumulators, scores and top-k indices exactly; timed
   with CUDA events beside the launch floor (one graph-replayed
   one-element ``add_``) and, for the top-k, ``torch.topk``; a warm
   ``fairk_update`` call, a warm fold (dense, gathered, weighted), the exact
   path's detection, the packed path's detection with its score and
   each index-form state update must each make exactly one device
   operation (the plain composition's count is recorded): one kernel
   node in a CUDA
   graph captured around the call, and one kernel of the right name in
   ``torch.profiler``, whose sessions now and then record nothing; the
   no-residual ``ops.fairk_update`` at 109,210, and ``fairk_update``
   [stats], [res], no-residual and [stats+sanitize] on the ``--full``
   transformer tree's padded buffer (49,996,288 coordinates, pads after
   each of 195 leaves);
   ``engine.quantile`` on the card equal to the CPU's on the same
   samples;
4. the packed path at full width: the FL round on the 109,210-parameter
   prototype CNN over 50 EMNIST-shaped synthetic clients — (a) 5 coherent
   rounds, (b) 5 one-bit rounds, (c) 3 coherent rounds with error
   feedback — with exact launch counts, finite weights and losses and the
   round-0 full refresh;
5. the exact path at the same width (the backend every paper figure
   runs): FAIR-k coherent 3 rounds, each other policy 2 rounds, one-bit
   3 rounds, coherent with error feedback 2 rounds — exact launch counts
   (one ``aou_merge`` per round: 18), k coordinates refreshed every
   round, finite weights and losses;
6. the exact engine path: 20 rounds of ``select_and_merge`` at
   d = 109,210 and 3 more with ``sanitize``, with the kernel and with the
   plain versions — identical outputs, 23 ``aou_merge`` launches (20 of
   the index form, 3 of the mask form);
7. the two-stage top-k entry point (``ops.two_stage_topk``, d = 2^24,
   k = d/100): one ``block_topk`` launch, equal to the stable-sort top-k;
8. the adaptive split: ``fairk_auto`` as (a) on the exact and the packed
   backend, 8 rounds each — one ``aou_merge`` launch per exact round, one
   ``fairk_update`` per packed round, ``km_frac`` inside the controller's
   range, kernel and plain trajectories identical (``km_frac`` and the
   controller state included), and no host sync in a warm round (sync
   debug mode) on the adaptive routes and on the static (a) and exact
   FAIR-k;
9. the figures: figs 4, 5, 7 and 9 through
   ``benchmarks.torch_common.run_policy`` at their ``--full`` MLP width
   (d = 111,306; fig 9 112,346), 3 rounds per policy — one ``aou_merge``
   per round, fig 9's one-bit fold and detection once per round; each
   run again with the plain versions: identical trajectories;
10. the sweep: fig 6's grid (80 lanes × d = 2,048, N = 16), 20 rounds —
   one mask-form ``aou_merge`` launch per round, kernel and plain grids
   identical, k coordinates refreshed per lane per round;
11. the threshold trainer: (a), (b) and (c) on ``backend="threshold"``, 3
   rounds each — one ``fairk_update`` per round (and the one-bit route's
   folds and detections), ``n_selected`` within 10% of k, kernel and
   plain trajectories identical;
12. async rounds (``async_lag = 2``): exact FAIR-k, threshold (a) and
   packed (a) 3 rounds each and ``fairk_auto`` on packed 8 — every
   selected coordinate at age 2 after its round, the synchronous launch
   counts, kernel and plain identical; then ``scan_rounds = 3`` on packed
   (a), 6 rounds, equal to the per-round loop bit for bit;
13. the scenario layers at full width (faults and the watchdog, a
   population of 10^6 virtual clients, the wireless channel): chaos on
   (a) packed, (c) threshold and exact FAIR-k; ``fairk_auto`` with chaos
   and the watchdog; Gilbert–Elliott (packed) and diurnal (exact)
   populations; the channel on (a), (b) and exact one-bit (the weighted
   fold); all three composed — the stated launches, no erased or
   non-finite coordinate selected, finite weights and losses, steady round
   ms, kernel and plain trajectories identical (fault state included), 0
   host syncs per warm round; total-outage rounds (``gmin = 1e9``) that
   merge nothing on every backend; the sweep's 80 lanes with fault,
   population and wireless lanes, kernel and plain grids identical; the
   population scan at 10^6 clients × 64 rounds in client-rounds per s;
14. the multi-leaf server phase on the ``--full`` tree through
   ``benchmarks.torch_packed_bench``'s builders (packed, persisted,
   persisted_ef, fused_stats after 5 carried rounds, adaptive, async,
   sanitize, chaos, channel): one launch per round, 1 pack and 1 unpack
   per persisted round, 1 read of g on the fused rounds and 3 on the
   legacy ones, pads never selected, every output equal to its plain
   rerun, each row timed;
   the threshold engine at d = 10^8 equal to plain, and ``exact_theta``
   selecting exact FAIR-k's set at 109,210;
15. the launch path's train step (``repro_torch.launch.steps``) on
   ``internvl2-1b`` at full width and depth (629,619,968 parameters,
   629,664,256 packed coordinates), batch 4 as two microbatches of the
   256-patch prefix and 256 text tokens, AdamW, ρ 0.1: (i) the persisted
   fused-stats route 3 steps, (ii) one-bit with error feedback 2, (iii)
   adaptive + async + sanitize + fades + the wireless channel 2 — one
   ``fairk_update`` launch per step (and one ``sign_mv`` in (ii)), 1 pack,
   1 unpack and 1 read of g per step, finite losses and weights, pads
   never selected, the kernel and plain update phases identical from one
   state and one recorded gradient tree, 0 host syncs in a warm step of
   (i) and (iii), the server state's checkpoint round trip bit for bit,
   ``--ckpt-every`` / ``--resume`` of the launcher at the reduced config
   continuing one trajectory bit for bit (deterministic algorithms); the
   two kernels at the path's 629,664,256 coordinates against their plain
   versions; steady step ms, the server phase's share, tokens per second,
   a profile of one step and the peak allocated memory;
16. the other layer families' train steps, batch 4 as two microbatches,
   ρ 0.1, each configuration's optimizer, with the checks of 15:
   ``mamba2-370m`` whole (48 layers, 512 tokens; (i) 3 steps and the
   one-bit + EF route 2), ``whisper-base`` whole (6 + 6 layers, 256 text
   tokens and 1,500 seeded frames), ``granite-moe-3b-a800m`` at full
   width with 8 of its 32 layers (512 tokens; no kernel-against-plain
   comparison: its cloned state would not fit), and narrow structural
   runs of ``jamba-1.5-large-398b`` (the nested per-layer checkpoint,
   ``sgdm``, bf16 parameters with float32 Mamba leaves) and
   ``arctic-480b`` (the dense branch beside the MoE), 2 steps each;
17. serving: ``make_prefill_step`` then ``make_serve_step`` at batch 4
   with 32 greedy tokens decoded on the device, on ``internvl2-1b``
   (256 patches + 256 tokens), granite at 8 layers (512 tokens),
   ``mamba2-370m`` (512) and ``whisper-base`` (1,500 frames + 64 tokens)
   at full width, and ``mamba2-370m`` again in float32 compute: finite
   logits, the caches' ``idx`` and ``pos``, 0 host syncs in a warm decode
   step, and but for MoE each decoded token's logits against a
   teacher-forced ``forward_train`` (relative L2 per position: 0.1 in
   bf16, 1e-4 in float32); prefill ms, ms per decoded token, tokens per
   second, cache bytes;
18. the same rounds (2 each of (a), (b), exact one-bit and exact coherent
   FAIR-k with error feedback) with the kernels and with the plain
   versions from one generator seed: identical ages and weights
   (max |Δw| = 0);
19. a profile of 2 rounds each of (a), (b) and exact coherent FAIR-k:
   device time per round, the device's busy share and the largest kernels
   (report only);
20. summary: a ``{"kernels": [...]}`` line, the card line, and the last
    line ``{"ok": true, "device": {...}}``.

Each path (4-16) runs with every launch count set to 0 just before it
and read just after; a kernel that none of them launched fails the run.
The serving path (17) launches none of the five kernels: its counts must
stay 0.

Imports neither JAX nor the JAX package.  Writes the full kernel timings to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
D = 109_210                         # prototype CNN on 28x28x1, 26 classes
N_CLIENTS, CHUNK, H, B = 50, 10, 5, 20
K_EXACT = 10_921                    # the exact coherent row: rho 0.1 of D
K_ONE_BIT = 21_842                  # the exact one-bit row: rho 0.2 of D
BIG = 2**24                         # aou_merge / block_topk at scale
ADAPTIVE_ROUNDS = 8                 # the controller acts at round 5
FIG_ROUNDS = 3                      # per policy, figs 4, 5, 7 and 9
D_FIG, D_FIG9 = 111_306, 112_346    # the figures' MLP on 24x24x3, hidden 64
K_FIG9 = 22_469                     # fig 9's one-bit row: rho 0.2 of D_FIG9
SWEEP_D, SWEEP_N, SWEEP_SEEDS, SWEEP_ROUNDS = 2048, 16, 8, 20
SWEEP_RATIOS = (0.0, 0.25, 0.5, 0.75, 1.0)
SWEEP_LANES = 2 * len(SWEEP_RATIOS) * SWEEP_SEEDS   # fairk + fairk_auto
TOPK_CASES = ((4096, 16), (4096, 164), (1024, 8))   # (block_size, m)
KERNELS = ("fairk_update", "sign_mv", "sign_from_energy", "aou_merge",
           "block_topk")
THRESH_ROUNDS = 3                   # threshold and async rounds per run
ASYNC_LAG = 2
TREE = (24, 320, 32_000)            # torch_packed_bench --full tree
TREE_LEAVES, TREE_D_PACKED, TREE_D_VALID = 195, 49_996_288, 49_986_880
ENGINE_BIG = 100_000_000            # the threshold engine at 10^8


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def _same(a, b, what: str) -> float:
    """Exact equality (bit for bit, NaN matches NaN) -> max |a - b| (0)."""
    import torch
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{what}: shape/dtype {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    check(bool(torch.equal(nan_a, nan_b)), f"{what}: NaN positions differ")
    if a.dtype == torch.float32:
        same = torch.equal(a[~nan_a].view(torch.int32),
                           b[~nan_b].view(torch.int32))
    else:
        same = torch.equal(a, b)
    a_n, b_n = a[~nan_a], b[~nan_b]
    # equal infinities differ by 0, not by inf - inf = NaN
    diff = torch.where(a_n == b_n, 0, (a_n - b_n).abs())
    err = float(diff.max()) if diff.numel() else 0.0
    check(bool(same), f"{what}: kernel and plain differ (max abs {err})")
    return err


def _time_ms(fn, blocks: int = 50, per_block: int = 20):
    """(device ms, eager ms) per call.  Device: ``per_block`` calls
    captured in one CUDA graph, replayed ``blocks`` times between CUDA
    events, median per call — the host's Python and launch overhead is out
    of it.  Eager: the same calls launched from Python, which at these
    sizes mostly measures the host."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_block):
            fn()
    out = []
    for run in (graph.replay, lambda: [fn() for _ in range(per_block)]):
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(blocks):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        out.append(statistics.median(a.elapsed_time(b) for a, b in pairs)
                   / per_block)
    return out[0], out[1]


def _device_ops(fn, sessions: int = 5):
    """The device operations (kernels, memsets, copies) one warm call of
    ``fn`` makes, by name, from ``torch.profiler``.  A session that
    recorded no device activity at all (the tracer sometimes drops a
    session's records, most often when the session's only work is one
    launch made right after it starts) is repeated, up to ``sessions``
    times; the call waits 10 ms into each session."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ops = {}
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            fn()
            torch.cuda.synchronize()
        ops = {ev.key: ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA}
        if ops:
            break
    return ops


# CUgraphNodeType values (cuda.h) a captured call may leave
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
               4: "graph", 5: "empty", 6: "wait_event", 7: "event_record",
               10: "mem_alloc", 11: "mem_free"}


def _graph_ops(fn):
    """The device operations one warm call of ``fn`` makes, by type: the
    nodes of a CUDA graph captured around the call, read through
    libcuda's ``cuGraphGetNodes``, which no tracer can drop."""
    import ctypes
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(libcuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    kinds = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(libcuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                         ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        name = _NODE_TYPES.get(kind.value, str(kind.value))
        kinds[name] = kinds.get(name, 0) + 1
    return kinds


def _one_op(fn, kernel: str, name: str) -> int:
    """Check that one warm call of ``fn`` makes one device operation, the
    kernel named ``kernel``: the call captured into a CUDA graph leaves
    exactly one kernel node, and ``torch.profiler``, whenever a session
    records device activity at all, sees exactly one operation of that
    name.  Returns the count (1)."""
    captured = _graph_ops(fn)
    check(captured == {"kernel": 1},
          f"{name}: one call captured the device operations {captured}")
    on_card = _device_ops(fn)
    check(not on_card or (sum(on_card.values()) == 1
                          and kernel in next(iter(on_card))),
          f"{name}: one call made the device operations {on_card}")
    return 1


def _bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _record(err, ms, n_bytes, bound, by, library_ms=None):
    return {"max_abs_err": err, "ms": ms["kernel"][0],
            "plain_ms": ms["plain"][0], "eager_ms": ms["kernel"][1],
            "plain_eager_ms": ms["plain"][1], "bound_ms": bound,
            "bound_by": by, "bytes": n_bytes, "library_ms": library_ms}


def kernel_phase(dev):
    """Every kernel variant at the main path's shapes, kernel vs plain."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)

    def vec(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=dev)

    def fairk_inputs(d):
        g = (rng.standard_t(3, size=d) * 0.1).astype(np.float32)
        g[rng.choice(d, 100, replace=False)] = 0.0
        g[rng.choice(d, 100, replace=False)] = -0.0
        age = rng.integers(0, 131, size=d).astype(np.float32)
        for start in (137, 4096, 50_001, 99_999):
            age[start:start + 97] = -1.0             # interior pad runs
        age[-5:] = -1.0
        fresh = np.where(rng.random(d) < 0.5, 1.0, -1.0).astype(np.float32)
        bad = g.copy()
        pos = rng.choice(d, 300, replace=False)
        bad[pos[:100]], bad[pos[100:200]], bad[pos[200:]] = (np.nan, np.inf,
                                                             -np.inf)
        bad_fresh = fresh.copy()
        bad_fresh[rng.choice(d, 30, replace=False)] = np.nan
        t = {"g": vec(g), "g_prev": vec(rng.normal(size=d)),
             "age": vec(age), "res": vec(rng.normal(size=d) * 0.05),
             "fresh": vec(fresh), "bad": vec(bad),
             "bad_fresh": vec(bad_fresh)}
        thetas = [(0.0, 0.0), (float(np.quantile(np.abs(g), 0.9)), 40.5),
                  (float("inf"), 60.5)]
        return t, thetas

    records, extras = {}, {}
    # the node count itself: two elementwise launches are two kernel nodes
    one = torch.zeros(1, device=dev)
    counted = _graph_ops(lambda: one.add_(1.0).mul_(0.5))
    check(counted == {"kernel": 2},
          f"the graph count of two launches is {counted}")

    def fairk_case(t, thetas, name, stats, res, fresh_key, g_key, sanitize,
                   n_in, n_out, fn=None):
        d = t["g"].shape[0]
        errs = []
        fn = fn or (ops.fairk_stats_update if stats else ops.fairk_ef_update)
        for tm, ta in thetas:
            kw = dict(residual=t["res"] if res else None,
                      fresh=t[fresh_key] if fresh_key else None,
                      sanitize=sanitize)
            if fn is ops.fairk_update:
                kw = dict(sanitize=sanitize)
            outs = {m: fn(t[g_key], t["g_prev"], t["age"], tm, ta, mode=m,
                          **kw) for m in ("kernel", "plain")}
            k_out, p_out = outs["kernel"], outs["plain"]
            errs.append(_same(k_out[0], p_out[0], f"{name} g_t"))
            errs.append(_same(k_out[1], p_out[1], f"{name} age'"))
            if res:
                errs.append(_same(k_out[2], p_out[2], f"{name} residual'"))
            if stats:
                for key in ("n_sel", "n_sel_m", "mag_hist", "age_hist"):
                    check(k_out[3][key].dtype == torch.float32,
                          f"{name} {key}: {k_out[3][key].dtype}")
                    errs.append(_same(k_out[3][key], p_out[3][key],
                                      f"{name} {key}"))
                if tm == 0.0:
                    check(float(k_out[3]["n_sel"]) > 0.9 * d,
                          f"{name}: theta=0 selected {k_out[3]['n_sel']}")
        tm, ta = (torch.tensor(v, device=dev) for v in thetas[1])
        kw = dict(residual=t["res"] if res else None,
                  fresh=t[fresh_key] if fresh_key else None,
                  sanitize=sanitize)
        if fn is ops.fairk_update:
            kw = dict(sanitize=sanitize)
        # one warm call with float32 thresholds on the card is one device
        # operation: the kernel (no stack, memset or cast around it)
        n_ops = _one_op(lambda: fn(t[g_key], t["g_prev"], t["age"], tm, ta,
                                   mode="kernel", **kw), "fairk_kernel", name)
        ms = {m: _time_ms(lambda m=m: fn(t[g_key], t["g_prev"], t["age"],
                                         tm, ta, mode=m, **kw),
                          blocks=50 if d <= D else 10)
              for m in ("kernel", "plain")}
        n_bytes = 4 * d * (n_in + n_out) + (4 * 258 if stats else 0) + 8
        bound, by = _bound_ms(n_bytes, (12 + (3 if res else 0)) * d)
        records[name] = _record(max(errs), ms, n_bytes, bound, by)
        records[name]["device_ops"] = n_ops

    t, thetas = fairk_inputs(D)
    fairk_case(t, thetas, "fairk_update[stats]", True, False, None, "g",
               False, 3, 2)
    fairk_case(t, thetas, "fairk_update[stats+fresh]", True, False, "fresh",
               "g", False, 4, 2)
    fairk_case(t, thetas, "fairk_update[stats+res]", True, True, None, "g",
               False, 4, 3)
    fairk_case(t, thetas, "fairk_update[res]", False, True, None, "g", False,
               4, 3)
    # the engine's threshold and legacy packed rounds: no residual, no
    # statistics (ops.fairk_update)
    fairk_case(t, thetas, "fairk_update[no residual]", False, False, None,
               "g", False, 3, 2, fn=ops.fairk_update)
    fairk_case(t, thetas, "fairk_update[stats+sanitize]", True, True,
               "bad_fresh", "bad", True, 5, 3)
    # where the bytes bound sets the pace: the launch path's sizes
    big, big_thetas = fairk_inputs(BIG)
    fairk_case(big, big_thetas, f"fairk_update[stats][{BIG}]", True, False,
               None, "g", False, 3, 2)
    fairk_case(big, big_thetas, f"fairk_update[stats+res][{BIG}]", True,
               True, None, "g", False, 4, 3)
    del big
    # the multi-leaf tree's padded buffer: pads after each of 195 leaves
    tree_case = tree_buffers(dev)
    fairk_case(tree_case, [(0.0, 0.0), (1.6, 30.5), (float("inf"), 30.5)],
               f"fairk_update[stats][tree {TREE_D_PACKED}]", True, False,
               None, "g", False, 3, 2)
    fairk_case(tree_case, [(0.0, 0.0), (1.6, 30.5), (float("inf"), 30.5)],
               f"fairk_update[res][tree {TREE_D_PACKED}]", False, True, None,
               "g", False, 4, 3)
    fairk_case(tree_case, [(0.0, 0.0), (1.6, 30.5), (float("inf"), 30.5)],
               f"fairk_update[no residual][tree {TREE_D_PACKED}]", False,
               False, None, "g", False, 3, 2, fn=ops.fairk_update)
    # the SANITIZE variant the tree's chaos and channel rows run: NaN and
    # +-inf in the aggregate (the erased and corrupted coordinates)
    bad = tree_case["g"].clone()
    pos = torch.randperm(bad.numel(), generator=torch.Generator(
        device=dev).manual_seed(17), device=dev)[:30_000]
    bad[pos[:10_000]] = float("nan")
    bad[pos[10_000:20_000]] = float("inf")
    bad[pos[20_000:]] = -float("inf")
    tree_case["bad"] = bad
    fairk_case(tree_case, [(0.0, 0.0), (1.6, 30.5), (float("inf"), 30.5)],
               f"fairk_update[stats+sanitize][tree {TREE_D_PACKED}]", True,
               False, None, "bad", True, 3, 2)
    del tree_case, bad
    extras["quantile"] = quantile_check(dev)

    noise = vec(rng.normal(size=D) * 2.0)
    for n in (10, 50):
        v = rng.normal(size=(n, D)).astype(np.float32)
        v = np.where(rng.random((n, D)) < 0.05, 0.0, np.sign(v))
        v[rng.random((n, D)) < 0.05] = -0.0
        votes = torch.as_tensor(v.astype(np.float32), device=dev)
        for noisy in (False, True):
            nz = noise if noisy else None
            name = f"sign_mv[{n}x{D}{'+noise' if noisy else ''}]"
            ks, ke = ops.sign_mv(votes, nz, mode="kernel")
            ps, pe = ops.sign_mv(votes, nz, mode="plain")
            err = max(_same(ks, ps, f"{name} signs"),
                      _same(ke, pe, f"{name} energy"))
            ms = {m: _time_ms(lambda m=m: ops.sign_mv(votes, nz, mode=m))
                  for m in ("kernel", "plain")}
            n_bytes = 4 * n * D + 8 * D + (4 * D if noisy else 0)
            bound, by = _bound_ms(n_bytes, 2 * n * D)
            records[name] = _record(err, ms, n_bytes, bound, by)
    # the exact one-bit fold's chunk of compacted votes (10, k)
    v = rng.normal(size=(CHUNK, K_ONE_BIT)).astype(np.float32)
    votes = torch.as_tensor((np.sign(v) + (v == 0)).astype(np.float32),
                            device=dev)
    name = f"sign_mv[{CHUNK}x{K_ONE_BIT}]"
    err = max(_same(a, b, name) for a, b in zip(
        ops.sign_mv(votes, mode="kernel"), ops.sign_mv(votes, mode="plain")))
    ms = {m: _time_ms(lambda m=m: ops.sign_mv(votes, mode=m))
          for m in ("kernel", "plain")}
    n_bytes = 4 * CHUNK * K_ONE_BIT + 8 * K_ONE_BIT
    records[name] = _record(err, ms, n_bytes,
                            *_bound_ms(n_bytes, 2 * CHUNK * K_ONE_BIT))
    one_bit_call_sites(dev, rng, records)
    merge_call_sites(dev, rng, records)
    energy = vec(2.0 * rng.integers(-25, 26, size=D))
    for noisy, width in ((False, D), (True, D), (True, K_ONE_BIT)):
        e = energy[:width]
        nz = noise[:width] if noisy else None
        name = f"sign_from_energy[{width}{'+noise' if noisy else ''}]"
        ks, ke = ops.sign_from_energy(e, nz, mode="kernel")
        ps, pe = ops.sign_from_energy(e, nz, mode="plain")
        err = max(_same(ks, ps, f"{name} signs"),
                  _same(ke, pe, f"{name} energy"))
        ms = {m: _time_ms(lambda m=m: ops.sign_from_energy(e, nz, mode=m))
              for m in ("kernel", "plain")}
        n_bytes = 4 * width * (3 + (1 if noisy else 0))
        bound, by = _bound_ms(n_bytes, 2 * width)
        records[name] = _record(err, ms, n_bytes, bound, by)
    extras.update(merge_and_topk_checks(dev, rng, records))
    # the card's floor for one graph-replayed launch, to subtract from the
    # kernels' device times when ranking them
    one = torch.zeros(1, device=dev)
    extras["launch_floor_ms"] = _time_ms(lambda: one.add_(0))[0]
    torch.cuda.synchronize()
    print(f"launch floor: one graph-replayed add_(0) on one element, "
          f"{extras['launch_floor_ms'] * 1e3:.2f} us", flush=True)
    for name, rec in records.items():
        lib = ("" if rec["library_ms"] is None else
               f", library {rec['library_ms'] * 1e3:.2f} us")
        n_ops = ("" if "device_ops" not in rec else
                 f", {rec['device_ops']} device operation per call")
        if "parent_device_ops" in rec:
            n_ops += (f" (plain, the parent's composition: "
                      f"{rec['parent_device_ops']})")
        print(f"kernel {name}: exact match; device {rec['ms'] * 1e3:.2f} us "
              f"(plain {rec['plain_ms'] * 1e3:.2f} us{lib}), eager "
              f"{rec['eager_ms'] * 1e3:.2f} us (plain "
              f"{rec['plain_eager_ms'] * 1e3:.2f} us), bound "
              f"{rec['bound_ms'] * 1e3:.3f} us by {rec['bound_by']}{n_ops}",
              flush=True)
    two = extras["two_stage_topk"]
    print(f"two_stage_topk(d = {BIG}, k = {two['k']}): device "
          f"{two['ms'] * 1e3:.2f} us (block_topk + stage 2), torch.topk of "
          f"|x| {two['library_ms'] * 1e3:.2f} us", flush=True)
    return records, extras


def one_bit_call_sites(dev, rng, records):
    """The one-bit uplink's call sites at the paths' shapes, each one
    kernel launch: the chunk fold ``ops.vote_fold`` of a (10, 109,210)
    chunk dense (packed path) and gathered at an unsorted selection of
    21,842 (exact path), and fig 9's fold of one chunk of 50 clients
    (50, 112,346) gathered at 22,469 (the kernel's variant for chunks of
    more than 16 rows), into a non-zero accumulator; the packed detection
    with its score (109,210, ``noise_std`` 2.0 times the draw ``z``) and
    the exact detection (``quantize.fsk_majority_from_energy``, noise_std
    2.0) at 21,842 and at fig 9's 22,469.  Kernel against plain bit for
    bit, one device operation per call, timed."""
    import numpy as np
    import torch
    from repro_torch.core import quantize
    from repro_torch.kernels import ops

    def chunk(rows, d):
        x = rng.normal(size=(rows, d)).astype(np.float32)
        u = rng.random((rows, d))
        x[u < 0.05] = 0.0
        x[(u >= 0.05) & (u < 0.1)] = -0.0
        x[0, :3] = [np.nan, np.inf, -np.inf]
        return torch.as_tensor(x, device=dev)

    def sel_of(d, k):
        return torch.as_tensor(rng.permutation(d)[:k], device=dev)

    x = chunk(CHUNK, D)
    fig9 = chunk(N_CLIENTS, D_FIG9)
    for name, x, sel in (
            (f"sign_mv[fold {CHUNK}x{D}]", x, None),
            (f"sign_mv[fold {CHUNK}x{D} at {K_ONE_BIT}]", x,
             sel_of(D, K_ONE_BIT)),
            (f"sign_mv[fold {N_CLIENTS}x{D_FIG9} at {K_FIG9}]", fig9,
             sel_of(D_FIG9, K_FIG9))):
        rows = x.shape[0]
        k = x.shape[1] if sel is None else sel.numel()
        acc = torch.as_tensor((rng.normal(size=k) * 7.0).astype(np.float32),
                              device=dev)
        outs = {}
        for m in ("kernel", "plain"):
            outs[m] = acc.clone()
            check(ops.vote_fold(outs[m], x, sel, mode=m) is outs[m],
                  f"{name}: the fold did not update acc in place")
        err = _same(outs["kernel"], outs["plain"], name)
        n_ops = _one_op(lambda: ops.vote_fold(outs["kernel"], x, sel),
                        "sign_mv_kernel", name)
        ms = {m: _time_ms(lambda m=m: ops.vote_fold(outs[m], x, sel,
                                                    mode=m))
              for m in ("kernel", "plain")}
        # x (at idx) read once, idx read once, acc read and written
        n_bytes = 4 * rows * k + 8 * k + (0 if sel is None else 8 * k)
        records[name] = _record(err, ms, n_bytes,
                                *_bound_ms(n_bytes, 2 * rows * k))
        records[name]["device_ops"] = n_ops
    # the wireless one-bit fold: each client's votes weighted by its
    # sent * csi before the re-sign (0.0 and -0.0 weights vote +1, a
    # negative one flips, NaN votes -1)
    name = f"sign_mv[fold {CHUNK}x{D} weighted]"
    xw = chunk(CHUNK, D)
    row = torch.as_tensor(np.array([1.0, 0.0, -0.0, -0.7, np.nan, 1.03,
                                    0.0, 0.97, -1.0, 1.1],
                                   np.float32)[:CHUNK], device=dev)
    acc = torch.as_tensor((rng.normal(size=D) * 7.0).astype(np.float32),
                          device=dev)
    outs = {m: ops.vote_fold(acc.clone(), xw, None, mode=m, row=row)
            for m in ("kernel", "plain")}
    err = _same(outs["kernel"], outs["plain"], name)
    check(not bool(torch.equal(outs["kernel"], ops.vote_fold(
        acc.clone(), xw, None, mode="plain"))),
          f"{name}: the weights changed no vote")
    n_ops = _one_op(lambda: ops.vote_fold(outs["kernel"], xw, None, row=row),
                    "sign_mv_kernel", name)
    ms = {m: _time_ms(lambda m=m: ops.vote_fold(outs[m], xw, None, mode=m,
                                                row=row))
          for m in ("kernel", "plain")}
    n_bytes = 4 * CHUNK * D + 8 * D + 4 * CHUNK
    records[name] = _record(err, ms, n_bytes,
                            *_bound_ms(n_bytes, 4 * CHUNK * D))
    records[name]["device_ops"] = n_ops
    energy = torch.as_tensor(2.0 * rng.integers(-25, 26, size=D),
                             dtype=torch.float32, device=dev)
    z = torch.as_tensor(rng.normal(size=D).astype(np.float32), device=dev)
    name = f"sign_from_energy[{D}+z+score]"
    outs = {m: ops.sign_from_energy(energy, z=z, noise_std=2.0, score=True,
                                    mode=m) for m in ("kernel", "plain")}
    err = max(_same(a, b, f"{name} {what}") for a, b, what in zip(
        outs["kernel"], outs["plain"], ("signs", "energy", "score")))
    n_ops = _one_op(lambda: ops.sign_from_energy(energy, z=z, noise_std=2.0,
                                                 score=True),
                    "sign_from_energy_kernel", name)
    ms = {m: _time_ms(lambda m=m: ops.sign_from_energy(
        energy, z=z, noise_std=2.0, score=True, mode=m))
        for m in ("kernel", "plain")}
    n_bytes = 4 * D * 5                    # e, z in; signs, energy, score out
    records[name] = _record(err, ms, n_bytes, *_bound_ms(n_bytes, 8 * D))
    records[name]["device_ops"] = n_ops
    for k in (K_ONE_BIT, K_FIG9):
        e, zk = energy[:k], z[:k]
        name = f"sign_from_energy[{k}+z]"
        outs = {m: quantize.fsk_majority_from_energy(e, zk, 2.0, mode=m)
                for m in ("kernel", "plain")}
        err = _same(outs["kernel"], outs["plain"], name)
        n_ops = _one_op(
            lambda: quantize.fsk_majority_from_energy(e, zk, 2.0),
            "sign_from_energy_kernel", name)
        ms = {m: _time_ms(lambda m=m: quantize.fsk_majority_from_energy(
            e, zk, 2.0, mode=m)) for m in ("kernel", "plain")}
        n_bytes = 4 * k * 4                # e, z in; signs, energy out
        records[name] = _record(err, ms, n_bytes, *_bound_ms(n_bytes, 4 * k))
        records[name]["device_ops"] = n_ops


def merge_call_sites(dev, rng, records):
    """The exact path's state updates, each one ``aou_merge`` launch of the
    index form at the paths' shapes (d = 109,210; an unsorted selection of
    k = 10,921 on the coherent uplink and in the engine, 21,842 on the
    one-bit uplink): the trainer's (``ops.aou_merge_by_indices``) coherent
    with and without error feedback and one-bit with it, and the engine's
    (``ops.masked_merge_by_indices``) with noise and residual.  Inputs
    carry −0.0, NaN and ±inf (on selected coordinates too), NaN ages and
    ages past the cap.  Kernel against plain bit for bit; one device
    operation per call; the plain version, which composes the operations
    the call site ran before, is the parent's time and its device
    operations (graph nodes) are recorded."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops

    def row(n, scale=1.0):
        x = (rng.normal(size=n) * scale).astype(np.float32)
        pos = rng.choice(n, 40, replace=False)
        x[pos[:10]], x[pos[10:20]] = -0.0, np.nan
        x[pos[20:30]], x[pos[30:]] = np.inf, -np.inf
        return torch.as_tensor(x, device=dev)

    age = rng.integers(0, 131, size=D).astype(np.float32)
    age[rng.choice(D, 50, replace=False)] = np.nan
    t = {"g_prev": row(D), "age": torch.as_tensor(age, device=dev),
         "sel_count": torch.as_tensor(rng.integers(0, 9, size=D).astype(
             np.float32), device=dev),
         "ef_sum": row(D, 3.0), "sent": row(D), "score": row(D),
         "noise": torch.as_tensor(rng.normal(size=D).astype(np.float32),
                                  device=dev)}
    sites = {}
    for k in (K_EXACT, K_ONE_BIT):
        idx = torch.as_tensor(rng.permutation(D)[:k], device=dev)
        t["g_prev"][idx[:4]] = torch.tensor(
            [-0.0, float("nan"), float("inf"), -float("inf")], device=dev)
        t[k] = {"idx": idx, "fresh": row(k), "z": torch.as_tensor(
            rng.normal(size=k).astype(np.float32), device=dev)}

    def trainer(k, superposed, ef):
        u = t[k]
        return lambda mode=None: ops.aou_merge_by_indices(
            u["idx"], u["fresh"], t["g_prev"], t["age"], t["sel_count"],
            n_clients=N_CLIENTS, superposed=superposed, z=u["z"],
            noise_std=0.1, ef_sum=t["ef_sum"] if ef else None, mode=mode)

    # (call, bytes: the (d,) rows read and written once, idx and the (k,)
    # rows read once)
    sites[f"aou_merge[trainer coherent+ef {D} at {K_EXACT}]"] = (
        trainer(K_EXACT, True, True), 36 * D + 16 * K_EXACT)
    sites[f"aou_merge[trainer coherent {D} at {K_EXACT}]"] = (
        trainer(K_EXACT, True, False), 28 * D + 16 * K_EXACT)
    sites[f"aou_merge[trainer one-bit+ef {D} at {K_ONE_BIT}]"] = (
        trainer(K_ONE_BIT, False, True), 36 * D + 12 * K_ONE_BIT)
    sites[f"aou_merge[engine noise+res {D} at {K_EXACT}]"] = (
        lambda mode=None: ops.masked_merge_by_indices(
            t[K_EXACT]["idx"], t["sent"], t["g_prev"], t["age"],
            noise=t["noise"], noise_scale=0.1 / N_CLIENTS, score=t["score"],
            mode=mode), 32 * D + 8 * K_EXACT)
    for name, (fn, n_bytes) in sites.items():
        outs = {m: fn(m) for m in ("kernel", "plain")}
        err = max(_same(a, b, name) for a, b in zip(outs["kernel"],
                                                    outs["plain"])
                  if a is not None)
        n_ops = _one_op(fn, "aou_merge_idx_kernel", name)
        parent_ops = sum(_graph_ops(lambda: fn("plain")).values())
        ms = {m: _time_ms(lambda m=m: fn(m)) for m in ("kernel", "plain")}
        records[name] = _record(err, ms, n_bytes,
                                *_bound_ms(n_bytes, 8 * D))
        records[name].update(device_ops=n_ops, parent_device_ops=parent_ops)


def merge_and_topk_checks(dev, rng, records):
    """``aou_merge`` at d = 109,210 (ragged, NaN, signed zeros, ages past
    the cap) and 2^24; ``block_topk`` at 2^24 for every (block_size, m) of
    ``TOPK_CASES`` with injected ties, its library yardstick
    ``torch.topk`` on the precomputed |x| (tie order unspecified, timed
    only); ``block_topk`` on NaNs of both signs, infinities of both signs,
    blocks of one value and m = block_size (untimed); ``two_stage_topk``
    at k = d/100 against the stable-sort top-k, timed beside
    ``torch.topk(x.abs(), k)``.  Returns the two-stage timing."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops

    # the exact path's width, the sweep grid's (lanes·d) block, 2^24
    for d in (D, SWEEP_LANES * SWEEP_D, BIG):
        g_new = rng.normal(size=d).astype(np.float32)
        g_new[rng.random(d) < 0.02] = -0.0
        g_new[:3] = [np.nan, np.inf, -np.inf]
        age = rng.integers(0, 131, size=d).astype(np.float32)
        age[3] = np.nan
        mask = (rng.random(d) < 0.1).astype(np.float32)
        args = [torch.as_tensor(a, device=dev) for a in (
            g_new, rng.normal(size=d).astype(np.float32), age, mask)]
        name = f"aou_merge[{d}]"
        err = max(_same(a, b, name) for a, b in zip(
            ops.aou_merge(*args, mode="kernel"),
            ops.aou_merge(*args, mode="plain")))
        ms = {m: _time_ms(lambda m=m: ops.aou_merge(*args, mode=m),
                          blocks=10 if d == BIG else 50)
              for m in ("kernel", "plain")}
        n_bytes = 24 * d
        records[name] = _record(err, ms, n_bytes, *_bound_ms(n_bytes, 7 * d))

    x = rng.normal(size=BIG).astype(np.float32)
    x[rng.random(BIG) < 0.01] = 1.25         # ties inside and across blocks
    x[rng.random(BIG) < 0.01] = -1.25
    x[rng.random(BIG) < 0.01] = 0.0
    xt = torch.as_tensor(x, device=dev)
    absx = xt.abs()
    for bs, m in TOPK_CASES:
        name = f"block_topk[{BIG}/{bs}x{m}]"
        kv, ki = ops.block_topk(xt, bs, m, mode="kernel")
        pv, pi = ops.block_topk(xt, bs, m, mode="plain")
        err = max(_same(kv, pv, f"{name} values"),
                  _same(ki, pi, f"{name} indices"))
        ms = {mode: _time_ms(lambda mode=mode: ops.block_topk(xt, bs, m,
                                                              mode=mode),
                             blocks=10)
              for mode in ("kernel", "plain")}
        lib_ms = _time_ms(lambda: torch.topk(absx.view(-1, bs), m, dim=1),
                          blocks=10)[0]
        nb = BIG // bs
        n_bytes = 4 * BIG + 8 * nb * m
        records[name] = _record(err, ms, n_bytes,
                                *_bound_ms(n_bytes, 2 * BIG), lib_ms)
    edge_d = 16 * 4096
    for kind in ("nan", "inf", "equal"):
        e = rng.normal(size=edge_d).astype(np.float32)
        e[rng.random(edge_d) < 0.01] = 1.25
        if kind == "nan":
            e[rng.random(edge_d) < 0.01] = np.nan
            e[rng.random(edge_d) < 0.01] = -np.nan
        elif kind == "inf":
            e[rng.random(edge_d) < 0.01] = np.inf
            e[rng.random(edge_d) < 0.01] = -np.inf
        else:
            e[:4096] = -2.5                  # blocks of one magnitude
            e[4096:8192] = 0.0
        et = torch.as_tensor(e, device=dev)
        for bs, m in TOPK_CASES + ((4096, 4096),):
            name = f"block_topk[{edge_d}/{bs}x{m}, {kind}]"
            kv, ki = ops.block_topk(et, bs, m, mode="kernel")
            pv, pi = ops.block_topk(et, bs, m, mode="plain")
            _same(kv, pv, f"{name} values")
            _same(ki, pi, f"{name} indices")
    # m = block_size, as the wrapper accepts it
    et = torch.as_tensor(x[:4 * 4096], device=dev)
    for a, b in zip(ops.block_topk(et, 4096, 4096, mode="kernel"),
                    ops.block_topk(et, 4096, 4096, mode="plain")):
        _same(a, b, "block_topk[16384/4096x4096]")
    k = BIG // 100
    vals, idxs = ops.two_stage_topk(xt, k, mode="kernel")
    ref_vals, ref_idx = torch.sort(absx, descending=True, stable=True)
    _same(vals, ref_vals[:k], "two_stage_topk values")
    check(bool(torch.equal(idxs.long(), ref_idx[:k])),
          "two_stage_topk indices differ from the stable-sort top-k")
    ms = _time_ms(lambda: ops.two_stage_topk(xt, k, mode="kernel"),
                  blocks=10)[0]
    lib_ms = _time_ms(lambda: torch.topk(xt.abs(), k), blocks=10)[0]
    return {"two_stage_topk": {"d": BIG, "k": k, "ms": ms,
                               "library_ms": lib_ms}}


# --------------------------------------------------------------------------
# phases 4 to 8: the paths
# --------------------------------------------------------------------------

def make_task(dev):
    """EMNIST-shaped synthetic data split over 50 clients with Dir(0.3),
    and the full-width prototype CNN from a seeded generator."""
    import torch
    from repro_torch.data import partition, synthetic
    from repro_torch.models import cnn

    spec = synthetic.DatasetSpec("emnist-like", (28, 28, 1), 26, 26_000,
                                 2_000)
    (xtr, ytr), (xte, yte) = synthetic.make_dataset(spec, seed=0)
    parts = partition.dirichlet_partition(ytr, N_CLIENTS, 0.3, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params0 = cnn.init_prototype_cnn(gen, (28, 28, 1), 26, (24, 32, 48), 192,
                                     device=dev)
    check(cnn.param_count(params0) == D,
          f"prototype CNN has {cnn.param_count(params0)} parameters, not {D}")
    xte_t = torch.as_tensor(xte, device=dev)
    yte_t = torch.as_tensor(yte, device=dev)

    def loss_fn(p, x, y):
        return cnn.softmax_xent(cnn.prototype_cnn(p, x), y)

    def eval_fn(p):
        with torch.no_grad():
            logits = cnn.prototype_cnn(p, xte_t)
            return {"acc": float(cnn.accuracy(logits, yte_t)),
                    "loss": float(cnn.softmax_xent(logits, yte_t))}

    def sample_round(t):
        return partition.client_batches(xtr, ytr, parts, B, H, seed=t)

    return params0, loss_fn, eval_fn, sample_round


def run_configs():
    """The packed path's runs (a)-(c) and the exact path's runs."""
    from repro_torch.core.oac import ChannelConfig
    from repro_torch.fl import FLConfig
    common = dict(n_clients=N_CLIENTS, local_steps=H, batch_size=B,
                  client_chunk=CHUNK, seed=0)
    coherent = dict(compression_ratio=0.1, local_lr=0.05, global_lr=0.05,
                    channel=ChannelConfig(fading="rayleigh", mean=1.0,
                                          noise_std=0.1), **common)
    one_bit = dict(one_bit=True, compression_ratio=0.2, local_lr=0.003,
                   global_lr=0.003,
                   channel=ChannelConfig(fading="none", mean=1.0,
                                         noise_std=2.0), **common)
    packed = {
        "a_coherent": FLConfig(rounds=5, backend="packed", **coherent),
        "b_one_bit": FLConfig(rounds=5, backend="packed", **one_bit),
        "c_coherent_ef": FLConfig(rounds=3, backend="packed",
                                  error_feedback=True, **coherent),
    }
    exact = {"exact_fairk": FLConfig(rounds=3, backend="exact", **coherent)}
    for policy in ("topk", "roundrobin", "toprand", "agetopk", "randk"):
        exact[f"exact_{policy}"] = FLConfig(rounds=2, backend="exact",
                                            policy=policy, **coherent)
    exact["exact_one_bit"] = FLConfig(rounds=3, backend="exact", **one_bit)
    exact["exact_fairk_ef"] = FLConfig(rounds=2, backend="exact",
                                       error_feedback=True, **coherent)
    return packed, exact


def reset_counters():
    from repro_torch.kernels import aou_merge, block_topk, fairk_update
    from repro_torch.kernels import sign_mv
    fairk_update.LAUNCHES = 0
    sign_mv.SIGN_MV_LAUNCHES = 0
    sign_mv.SIGN_FROM_ENERGY_LAUNCHES = 0
    aou_merge.LAUNCHES = 0
    block_topk.LAUNCHES = 0


def read_counters():
    from repro_torch.kernels import aou_merge, block_topk, fairk_update
    from repro_torch.kernels import sign_mv
    return {"fairk_update": fairk_update.LAUNCHES,
            "sign_mv": sign_mv.SIGN_MV_LAUNCHES,
            "sign_from_energy": sign_mv.SIGN_FROM_ENERGY_LAUNCHES,
            "aou_merge": aou_merge.LAUNCHES,
            "block_topk": block_topk.LAUNCHES}


def fl_path_phase(dev, task, configs, path):
    """Drive each run of ``configs`` through ``train`` with the counts set
    to 0 before it and read after it; check the launch counts, the state
    and the selection."""
    import math
    import torch
    from repro_torch.fl import train

    params0, loss_fn, eval_fn, sample_round = task
    launches = dict.fromkeys(KERNELS, 0)
    summary = {}
    for name, fl in configs.items():
        reset_counters()
        t0 = time.perf_counter()
        hist = train(fl, params0, loss_fn, sample_round, eval_fn=eval_fn,
                     eval_every=1, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counters()
        rounds, exact = fl.rounds, fl.backend == "exact"
        want = dict.fromkeys(KERNELS, 0)
        want["fairk_update"] = 0 if exact else rounds
        # the exact round's state update: one index-form launch
        want["aou_merge"] = rounds if exact else 0
        if fl.one_bit:
            want["sign_mv"] = rounds * (N_CLIENTS // CHUNK)
            want["sign_from_energy"] = rounds
        check(got == want, f"{name}: launches {got}, expected {want}")
        for key in launches:
            launches[key] += got[key]
        st = hist["state"]
        tensors = {"w": st.w, "g": st.g, "age": st.age,
                   "sel_count": st.sel_count, "residual": st.residual,
                   **{f"theta.{k}": v for k, v in st.theta.items()}}
        for key, val in tensors.items():
            check(val.is_cuda, f"{name}: state tensor {key} on {val.device}")
        check(bool(torch.isfinite(st.w).all()), f"{name}: non-finite w")
        check(all(math.isfinite(x) for x in hist["loss"]),
              f"{name}: non-finite loss {hist['loss']}")
        n_sel, k = hist["n_selected"], hist["k"]
        if exact:
            check(n_sel == [float(k)] * rounds,
                  f"{name}: selected {n_sel}, not k = {k} every round")
            check(float(st.sel_count.sum()) == rounds * k
                  and int((st.age == 0.0).sum()) == k,
                  f"{name}: participation counts or ages off the budget")
        else:
            check(n_sel[0] == D,
                  f"{name}: round 0 selected {n_sel[0]}, not {D}")
            check(all(1 <= x <= D for x in n_sel[1:]),
                  f"{name}: selected counts {n_sel}")
        print(f"{path} {name}: {rounds} rounds, launches {got}, "
              f"round ms {[round(x, 3) for x in hist['round_ms']]}, "
              f"selected {n_sel}, k {k}, test loss "
              f"{[round(x, 4) for x in hist['loss']]}, final test acc "
              f"{hist['acc'][-1]:.4f}, wall {wall:.2f} s", flush=True)
        summary[name] = {"round_ms": hist["round_ms"], "n_selected": n_sel,
                         "k": k, "acc": hist["acc"], "loss": hist["loss"],
                         "launches": got}
    return launches, summary


def engine_phase(dev):
    """The exact engine's ``select_and_merge`` (FAIR-k, ρ 0.1, noise 0.1
    over 50 clients, error feedback, fused statistics) for 20 rounds at
    d = 109,210 on seeded N(0, 1) scores, then 3 rounds with ``sanitize``
    (the rank-form branch, on scores with NaN and ±inf), with the kernel
    and with the plain versions: identical outputs; 23 ``aou_merge``
    launches, 20 of the index form and 3 of the mask form."""
    import torch
    from repro_torch.core.engine import EngineConfig, SelectionEngine

    rounds, sanitized = 20, 3
    runs = {}
    for mode in (None, "plain"):
        eng = SelectionEngine(EngineConfig(
            backend="exact", noise_std=0.1, n_clients=N_CLIENTS,
            fused_stats=True, kernel_mode=mode), D)
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        zeros = torch.zeros(D, device=dev)
        g_prev, age, res = zeros, zeros, zeros
        reset_counters()
        for r in range(rounds + sanitized):
            if r == 1:                      # round 0 carries the warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            g = torch.randn(D, generator=gen, device=dev)
            noise = torch.randn(D, generator=gen, device=dev)
            if r >= rounds:
                g[:300:3] = float("nan")
                g[1:300:3] = float("inf")
                g[2:300:3] = -float("inf")
            g_prev, age, stats = eng.select_and_merge(
                g, g_prev, age, noise=noise, residual=res,
                sanitize=r >= rounds)
            res = stats["residual"]
            if r == rounds - 1:
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / (rounds - 1)
        torch.cuda.synchronize()
        runs[mode] = (g_prev, age, res, stats, read_counters(), ms)
    k_out, p_out = runs[None], runs["plain"]
    for i, what in enumerate(("g_t", "age'", "residual'")):
        _same(k_out[i], p_out[i], f"engine {what}")
    for key in ("mag_hist", "age_hist", "n_sel_m"):
        _same(k_out[3][key], p_out[3][key], f"engine {key}")
    check(bool(torch.isfinite(k_out[0]).all()),
          "engine: sanitize let a non-finite value into g_t")
    want = dict.fromkeys(KERNELS, 0)
    want["aou_merge"] = rounds + sanitized
    check(k_out[4] == want, f"engine: launches {k_out[4]}, expected {want}")
    check(p_out[4] == dict.fromkeys(KERNELS, 0),
          f"engine: the plain run launched {p_out[4]}")
    print(f"engine path: {rounds} rounds of exact select_and_merge and "
          f"{sanitized} with sanitize at d = {D}, kernel and plain "
          f"identical; launches {k_out[4]}; host ms per round over rounds "
          f"1-{rounds - 1} {k_out[5]:.3f} (plain {p_out[5]:.3f})",
          flush=True)
    return k_out[4], {"rounds": rounds, "sanitized_rounds": sanitized,
                      "ms_per_round": k_out[5],
                      "plain_ms_per_round": p_out[5]}


def topk_path_phase(dev):
    """The two-stage top-k entry point at d = 2^24, k = d/100 (m = 164):
    one ``block_topk`` launch; the result is the stable-sort top-k."""
    import torch
    from repro_torch.kernels import ops

    x = torch.randn(BIG, generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    k = BIG // 100
    reset_counters()
    vals, idxs = ops.two_stage_topk(x, k)
    torch.cuda.synchronize()
    got = read_counters()
    want = dict.fromkeys(KERNELS, 0)
    want["block_topk"] = 1
    check(got == want, f"two-stage top-k: launches {got}, expected {want}")
    ref_vals, ref_idx = torch.sort(x.abs(), descending=True, stable=True)
    _same(vals, ref_vals[:k], "two-stage top-k values")
    check(bool(torch.equal(idxs.long(), ref_idx[:k])),
          "two-stage top-k indices differ from the stable-sort top-k")
    print(f"top-k path: two_stage_topk(d = {BIG}, k = {k}) equals the "
          f"stable-sort top-k; launches {got}", flush=True)
    return got


def adaptive_configs():
    """``fairk_auto`` at full width, coherent as (a), on both backends."""
    import dataclasses
    packed, _ = run_configs()
    base = dataclasses.replace(packed["a_coherent"], rounds=ADAPTIVE_ROUNDS,
                               policy="fairk_auto")
    return {"adaptive_exact": dataclasses.replace(base, backend="exact"),
            "adaptive_packed": base}


def host_syncs(dev, task, fl, rounds: int = 3):
    """Host syncs per warm round of ``fl``: the round function called on
    uploaded batches and draws under PyTorch's sync debug mode ("warn"),
    counting its warnings -> (syncs per round, the source lines that
    synchronised)."""
    import os
    import warnings
    import torch
    from repro_torch.fl import init_server, make_fl_step
    from repro_torch.fl.trainer import draw_round, init_fault_state

    params0, loss_fn, _, sample_round = task
    state, unravel = init_server(params0, fl, dev)
    d = state.w.shape[0]
    step = make_fl_step(fl, unravel, loss_fn, d, dev)
    fstate = init_fault_state(fl, state) if fl.stateful else None
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    inputs = []
    for t in range(rounds + 1):
        xs, ys = sample_round(t)
        inputs.append((torch.as_tensor(xs, device=dev),
                       torch.as_tensor(ys, device=dev),
                       draw_round(gen, fl, d, dev)))
    carry = (state.w, state.g, state.age, state.sel_count, state.residual,
             state.theta, state.ctrl)

    def one(xs, ys, draws):
        nonlocal carry, fstate
        w, g, age, sc, res, ts, cs = carry
        out = step(w, g, age, sc, xs, ys, res, ts, draws, cs, fstate)
        carry = out[:5] + (out[6], out[7])
        if fl.stateful:
            fstate = out[9]

    one(*inputs[0])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for xs, ys, draws in inputs[1:]:
                one(xs, ys, draws)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    where = sorted({f"{os.path.basename(w.filename)}:{w.lineno}"
                    for w in syncs})
    return len(syncs) / rounds, where


def adaptive_phase(dev, task):
    """``fairk_auto`` (``adaptive_km``) at full width on the exact and the
    packed backend, coherent as (a), ``ADAPTIVE_ROUNDS`` rounds each: one
    ``aou_merge`` launch per exact round, one ``fairk_update`` per packed
    round, the split inside [min_frac, max_frac]; then the same rounds
    with cuDNN deterministic, with the kernels and with the plain
    versions: identical trajectories, ``km_frac`` included; and no host
    sync in a warm round (sync debug mode) on either adaptive route nor
    on the static (a) and exact FAIR-k."""
    import dataclasses
    import math
    import torch
    from repro_torch.fl import train

    params0, loss_fn, eval_fn, sample_round = task
    launches = dict.fromkeys(KERNELS, 0)
    summary = {}
    for name, fl in adaptive_configs().items():
        exact = fl.backend == "exact"
        reset_counters()
        hist = train(fl, params0, loss_fn, sample_round, eval_fn=eval_fn,
                     eval_every=ADAPTIVE_ROUNDS, device=dev)
        torch.cuda.synchronize()
        got = read_counters()
        want = dict.fromkeys(KERNELS, 0)
        want["aou_merge" if exact else "fairk_update"] = fl.rounds
        check(got == want, f"{name}: launches {got}, expected {want}")
        for key in launches:
            launches[key] += got[key]
        c = fl.controller
        kmf = hist["km_frac"]
        check(all(c.min_frac <= f <= c.max_frac for f in kmf),
              f"{name}: km_frac {kmf} outside [{c.min_frac}, "
              f"{c.max_frac}]")
        check(bool(torch.isfinite(hist["state"].w).all())
              and all(math.isfinite(x) for x in hist["loss"]),
              f"{name}: non-finite weights or loss")
        if exact:
            check(hist["n_selected"] == [float(hist["k"])] * fl.rounds,
                  f"{name}: selected {hist['n_selected']}, not k")
        steady = statistics.median(hist["round_ms"][1:])
        summary[name] = {"km_frac": kmf, "round_ms": hist["round_ms"],
                         "steady_round_ms": steady, "launches": got,
                         "loss": hist["loss"], "acc": hist["acc"]}
        print(f"adaptive {name}: {fl.rounds} rounds, launches {got}, "
              f"km_frac {[round(x, 6) for x in kmf]}, round ms "
              f"{[round(x, 3) for x in hist['round_ms']]} (steady "
              f"{steady:.3f}), test loss {hist['loss'][-1]:.4f}",
              flush=True)
    # kernel against plain, cuDNN deterministic (restored afterwards)
    flags = _deterministic()
    try:
        for name, fl in adaptive_configs().items():
            runs = {mode: train(fl, params0, loss_fn, sample_round,
                                device=dev, kernel_mode=mode)
                    for mode in (None, "plain")}
            k, p = runs[None], runs["plain"]
            check(k["km_frac"] == p["km_frac"],
                  f"{name}: km_frac differs, kernel {k['km_frac']} plain "
                  f"{p['km_frac']}")
            for field in ("w", "g", "age", "sel_count"):
                _same(getattr(k["state"], field), getattr(p["state"], field),
                      f"{name} {field}")
            for key in k["state"].ctrl:
                _same(k["state"].ctrl[key], p["state"].ctrl[key],
                      f"{name} ctrl.{key}")
            print(f"adaptive {name}: kernel and plain trajectories "
                  f"identical over {fl.rounds} rounds (w, g, ages, counts, "
                  f"controller state, km_frac)", flush=True)
    finally:
        _restore(flags)
    packed, exact = run_configs()
    syncs = {}
    for name, fl in {**adaptive_configs(),
                     "exact_fairk": exact["exact_fairk"],
                     "a_coherent": packed["a_coherent"]}.items():
        per_round, where = host_syncs(dev, task, fl)
        syncs[name] = {"per_round": per_round, "where": where}
        print(f"host syncs {name}: {per_round:g} per warm round "
              f"{where}", flush=True)
        check(per_round == 0,
              f"host syncs {name}: {per_round:g} per warm round at {where}")
    summary["host_syncs"] = syncs
    return launches, summary


def figures_phase(dev):
    """Figs 4, 5, 7 and 9 through ``benchmarks.torch_common.run_policy``
    at their ``--full`` task width (the MLP on 24x24x3 with hidden 64, d =
    111,306, fig 9 with 26 classes d = 112,346, over 50 clients),
    ``FIG_ROUNDS`` rounds per policy (and per H on fig 7): one
    ``aou_merge`` launch per round, on fig 9's one-bit uplink one
    ``sign_mv`` fold per round (one chunk of 50) and one
    ``sign_from_energy``; k coordinates refreshed every round; finite
    accuracy; then every run again with the plain versions (cuDNN
    deterministic, restored afterwards), which launch no kernel:
    identical weights, aggregates, ages, counts, accuracies and mean
    AoU."""
    import torch
    from benchmarks import torch_common
    from repro_torch.core.oac import ChannelConfig

    task = torch_common.make_task(fast=False, device=dev)
    task26 = torch_common.make_task(fast=False, n_classes=26, device=dev)
    check(task.d == D_FIG and task26.d == D_FIG9,
          f"figure MLPs have d = {task.d} / {task26.d}")
    five = ("fairk", "topk", "agetopk", "toprand", "roundrobin")
    one_bit = dict(rho=0.2, one_bit=True, lr=0.003,
                   channel=ChannelConfig(fading="none", mean=1.0,
                                         noise_std=2.0))
    figures = {
        "fig4": [(task, p, {"eval_every": 1}) for p in five],
        "fig5": [(task, p, {}) for p in five],
        "fig7": [(task, p, {"local_steps": h}) for h in (1, 5, 20)
                 for p in ("fairk", "topk")],
        "fig9": [(task26, p, one_bit) for p in ("fairk", "topk",
                                                 "toprand")],
    }
    launches = dict.fromkeys(KERNELS, 0)
    summary = {}
    flags = _deterministic()
    try:
        for fig, runs in figures.items():
            got, summary[fig] = figure(fig, runs)
            for key in launches:
                launches[key] += got[key]
    finally:
        _restore(flags)
    return launches, summary


def figure(fig, runs):
    """One figure's runs with the kernels (counted), then with the plain
    versions -> (launches, summary)."""
    import math
    import torch
    from benchmarks import torch_common

    reset_counters()
    steady, rows, hists = [], [], []
    for t, policy, kw in runs:
        h = torch_common.run_policy(t, policy, FIG_ROUNDS, **kw)
        check(h["n_selected"] == [float(h["k"])] * FIG_ROUNDS,
              f"{fig} {policy}: selected {h['n_selected']}, not k")
        check(all(math.isfinite(a) for a in h["acc"]),
              f"{fig} {policy}: accuracy {h['acc']}")
        steady += h["round_ms"][1:]
        rows.append((policy, kw.get("local_steps", 5), h["acc"][-1],
                     h["round_ms"]))
        hists.append(h)
    torch.cuda.synchronize()
    got = read_counters()
    n_rounds = FIG_ROUNDS * len(runs)
    want = dict.fromkeys(KERNELS, 0)
    want["aou_merge"] = n_rounds
    if fig == "fig9":
        want["sign_mv"] = want["sign_from_energy"] = n_rounds
    check(got == want, f"{fig}: launches {got}, expected {want}")
    med = statistics.median(steady)
    print(f"figures {fig}: {len(runs)} runs x {FIG_ROUNDS} rounds at "
          f"d = {runs[0][0].d}, launches {got}, steady round ms median "
          f"{med:.3f} (min {min(steady):.3f}, max {max(steady):.3f})",
          flush=True)
    for (t, policy, kw), k in zip(runs, hists):
        what = f"{fig} {policy} H={kw.get('local_steps', 5)}"
        p = torch_common.run_policy(t, policy, FIG_ROUNDS,
                                    kernel_mode="plain", **kw)
        check(k["acc"] == p["acc"] and k["mean_aou"] == p["mean_aou"],
              f"{what}: accuracy or mean AoU differs, kernel {k['acc']} "
              f"{k['mean_aou']} plain {p['acc']} {p['mean_aou']}")
        for field in ("w", "g", "age", "sel_count"):
            _same(getattr(k["state"], field), getattr(p["state"], field),
                  f"{what} {field}")
    torch.cuda.synchronize()
    check(read_counters() == got,
          f"{fig}: the plain runs launched a kernel")
    print(f"figures {fig}: kernel and plain trajectories identical over "
          f"{len(runs)} runs x {FIG_ROUNDS} rounds (w, g, ages, counts, "
          f"accuracy, mean AoU)", flush=True)
    return got, {"steady_round_ms": med, "launches": got,
                 "runs": [{"policy": p, "H": hh, "acc": a, "round_ms": r}
                          for p, hh, a, r in rows]}


def sweep_phase(dev):
    """Fig 6's grid through ``repro_torch.fl.sweep`` (d = 2,048, N = 16,
    ρ = 0.2; fairk and fairk_auto × 5 ratios × 8 seeds = 80 lanes),
    ``SWEEP_ROUNDS`` rounds: one mask-form ``aou_merge`` launch per round
    over the (lanes·d) block; the kernel and plain grids identical; k
    coordinates refreshed per lane per round; ms per grid round."""
    import numpy as np
    import torch
    from repro_torch.fl import sweep

    cfg = sweep.SweepConfig(d=SWEEP_D, n_clients=SWEEP_N, rho=0.2,
                            rounds=SWEEP_ROUNDS)
    seeds, pids, kms, adaptives, labels = sweep.sweep_grid(
        ("fairk", "fairk_auto"), SWEEP_RATIOS, SWEEP_SEEDS, cfg)
    check(len(labels) == SWEEP_LANES, f"{len(labels)} lanes")
    draws = sweep.draw_lanes(cfg, seeds, dev)
    def grid(mode):
        """(metrics, ms per grid round) of one run of the grid."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = sweep.run_grid(cfg, seeds, pids, kms, adaptives,
                                 draws=draws, device=dev, kernel_mode=mode)
        torch.cuda.synchronize()
        return metrics, (time.perf_counter() - t0) * 1e3 / SWEEP_ROUNDS

    grid(None)                                                  # warm-up
    reset_counters()
    out, ms = grid(None)
    got = read_counters()
    want = dict.fromkeys(KERNELS, 0)
    want["aou_merge"] = SWEEP_ROUNDS
    check(got == want, f"sweep: launches {got}, expected {want}")
    # host times in turns: kernel, plain, plain, kernel
    plain, plain_ms = grid("plain")
    times = {"kernel": [ms], "plain": [plain_ms, grid("plain")[1]]}
    times["kernel"].append(grid(None)[1])
    ms, plain_ms = (statistics.median(times[m]) for m in ("kernel",
                                                           "plain"))
    for key in out:
        _same(out[key], plain[key], f"sweep {key}")
    check(bool((out["frac_fresh"] == cfg.k / cfg.d).all()),
          "sweep: a lane refreshed other than k coordinates")
    check(bool(torch.isfinite(out["loss"]).all()), "sweep: non-finite loss")
    loss = out["loss"][:, -1].cpu().numpy()
    km = out["km_frac"][:, -1].cpu().numpy()
    by = {}
    for i, (pol, frac, _) in enumerate(labels):
        by.setdefault(f"{pol} {frac:.2f}", []).append(float(loss[i]))
    auto = [i for i, lab in enumerate(labels) if lab[0] == "fairk_auto"]
    ctrl = cfg.controller
    # km_frac is the realised split round(f·k)/k of the controller's f
    check(bool(((km[auto] >= ctrl.min_frac - 0.5 / cfg.k)
                & (km[auto] <= ctrl.max_frac + 0.5 / cfg.k)).all()),
          f"sweep: adaptive km_frac {km[auto]}")
    finals = {key: float(np.mean(v)) for key, v in by.items()}
    print(f"sweep: {SWEEP_LANES} lanes x d = {SWEEP_D}, {SWEEP_ROUNDS} "
          f"rounds, launches {got}, kernel and plain grids identical; "
          f"ms per grid round {[round(x, 3) for x in times['kernel']]} "
          f"(plain {[round(x, 3) for x in times['plain']]}); mean final "
          f"loss {finals}; adaptive final km_frac mean "
          f"{float(np.mean(km[auto])):.4f}", flush=True)
    return got, {"lanes": SWEEP_LANES, "rounds": SWEEP_ROUNDS,
                 "ms_per_round": ms, "plain_ms_per_round": plain_ms,
                 "times_ms": times,
                 "final_loss": finals}


def parity_phase(dev, task):
    """2 rounds each of (a), (b), exact one-bit and exact coherent FAIR-k
    with error feedback, with the kernels and
    with the plain versions, same generator seed, cuDNN deterministic and
    TF32 off: identical ages and weights (every kernel equals its plain
    version bit for bit, and the rest of the round runs the same
    operations)."""
    import dataclasses
    import torch
    from repro_torch.fl import train

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    params0, loss_fn, _, sample_round = task
    packed, exact = run_configs()
    configs = {**packed, **exact}
    for name, w_tol in (("a_coherent", 0.0), ("b_one_bit", 0.0),
                        ("exact_one_bit", 0.0), ("exact_fairk_ef", 0.0)):
        fl = dataclasses.replace(configs[name], rounds=2)
        runs = {mode: train(fl, params0, loss_fn, sample_round,
                            device=dev, kernel_mode=mode)["state"]
                for mode in (None, "plain")}
        k_st, p_st = runs[None], runs["plain"]
        check(bool(torch.equal(k_st.age, p_st.age)),
              f"{name}: kernel and plain ages differ")
        w_err = float((k_st.w - p_st.w).abs().max())
        check(w_err <= w_tol,
              f"{name}: kernel and plain w differ by {w_err}")
        print(f"parity {name}: ages identical, max |w_kernel - w_plain| = "
              f"{w_err}", flush=True)


def profile_phase(dev, task, summary):
    """Where a round's device time goes: 2 rounds each of (a), (b) and
    exact coherent FAIR-k under ``torch.profiler`` (CPU + CUDA), after the
    paths warmed up.  Sums the device time of the kernels and copies themselves (not of the
    operators that launched them, which would count it twice), lists the
    largest, and estimates the device's busy share as kernel time per
    round over the path's median steady-state round time (the
    profiler slows the host, so its own window would understate it).
    Report only: nothing here is checked."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fl import train

    params0, loss_fn, _, sample_round = task
    packed, exact = run_configs()
    configs = {**packed, **exact}
    out = {}
    for name in ("a_coherent", "b_one_bit", "exact_fairk"):
        fl = dataclasses.replace(configs[name], rounds=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            train(fl, params0, loss_fn, sample_round, device=dev)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            rows.append((ev.self_device_time_total / 1e3, ev.key, ev.count))
        rows.sort(reverse=True)
        per_round = sum(r[0] for r in rows) / fl.rounds
        ours = {key: ms for ms, key, _ in rows
                if any(k in key for k in ("fairk_kernel", "sign_mv_kernel",
                                          "sign_from_energy_kernel",
                                          "aou_merge_kernel",
                                          "aou_merge_idx_kernel",
                                          "block_topk_kernel"))}
        steady = statistics.median(summary[name]["round_ms"][1:])
        out[name] = {"profiled_wall_ms": wall_ms,
                     "device_ms_per_round": per_round,
                     "steady_round_ms": steady,
                     "busy_share": per_round / steady,
                     "ours_ms": ours,
                     "top": [(ms, key[:90], n) for ms, key, n in rows[:10]]}
        print(f"profile {name}: device {per_round:.2f} ms per round "
              f"(kernels and copies) vs steady round {steady:.2f} ms -> "
              f"busy share {per_round / steady:.3f}; ported kernels "
              f"{sum(ours.values()) / fl.rounds:.4f} ms per round; profiled "
              f"window {wall_ms:.1f} ms", flush=True)
        for ms, key, n in rows[:10]:
            print(f"  {ms / fl.rounds:8.3f} ms/round  x{n // fl.rounds:<5d} "
                  f"{key[:90]}", flush=True)
    return out


# --------------------------------------------------------------------------
# slice 7: the threshold backend, async and staged rounds, the multi-leaf
# packed tree, the threshold engine at 10^8
# --------------------------------------------------------------------------

_TREE = {}


def full_tree(dev):
    """The ``--full`` transformer tree of ``torch_packed_bench`` (24 layers,
    d_model 320, vocab 32,000: 195 leaves, 49,996,288 packed coordinates)
    with its server state, built once: ``(tree, g_prev, age, layout)``."""
    if "tree" not in _TREE:
        from benchmarks import torch_packed_bench as bench
        from repro_torch.core import packing
        tree = bench.make_transformer_tree(*TREE, device=dev)
        g_prev, age = bench.server_state(tree)
        lay = packing.PackedLayout.from_tree(tree)
        check((lay.n_leaves, lay.d_packed, lay.d_valid)
              == (TREE_LEAVES, TREE_D_PACKED, TREE_D_VALID),
              f"tree layout {lay.n_leaves} leaves, {lay.d_packed} packed, "
              f"{lay.d_valid} valid")
        _TREE["tree"] = (tree, g_prev, age, lay)
    return _TREE["tree"]


def tree_buffers(dev):
    """The tree's packed buffers in the kernel phase's form: ``g``,
    ``g_prev``, ``age`` (PAD_AGE in the pads) and a residual that is 0 in
    the pads."""
    import torch
    tree, g_prev, age, lay = full_tree(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    res = torch.randn(lay.d_packed, generator=gen, device=dev) * 0.05
    return {"g": lay.pack(tree), "g_prev": lay.pack(g_prev),
            "age": lay.pack_age(age), "res": res * lay.valid_mask(dev)}


def quantile_check(dev):
    """``engine.quantile`` (``jnp.quantile``'s arithmetic) on the card
    against the CPU on the same samples — the threshold route's two
    sample sizes (109,210 and the 10^8 engine's 65,574), static and
    traced ``q``: bit for bit."""
    import torch
    from repro_torch.core import engine
    gen = torch.Generator().manual_seed(11)
    out = []
    for n in (D, 65_574, 1_000):
        x = torch.randn(n, generator=gen).abs()
        for q in (0.925, 0.9, 0.99971):
            for traced in (False, True):
                qq = torch.tensor(q, dtype=torch.float32) if traced else q
                cpu = engine.quantile(x, qq)
                card = engine.quantile(x.to(dev), qq.to(dev) if traced
                                       else qq)
                _same(card.cpu(), cpu, f"quantile n={n} q={q} traced="
                                       f"{traced}")
                out.append(float(cpu))
    print(f"quantile: engine.quantile on the card equals the CPU bit for "
          f"bit on {len(out)} (sample, q) pairs (109,210, 65,574, 1,000; "
          f"static and traced q)", flush=True)
    return {"pairs": len(out), "exact": True}


def threshold_configs():
    """(a), (b), (c) on the threshold backend."""
    import dataclasses
    packed, _ = run_configs()
    return {f"threshold_{name}": dataclasses.replace(
        fl, backend="threshold", rounds=THRESH_ROUNDS)
        for name, fl in packed.items()}


def _identical_states(k, p, what):
    for field in ("w", "g", "age", "sel_count", "residual"):
        _same(getattr(k, field), getattr(p, field), f"{what} {field}")
    for key in k.theta:
        _same(k.theta[key], p.theta[key], f"{what} theta.{key}")
    for key in k.ctrl:
        _same(k.ctrl[key], p.ctrl[key], f"{what} ctrl.{key}")


def _deterministic():
    """cuDNN deterministic and no benchmark; returns the old flags."""
    import torch
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return flags


def _restore(flags):
    import torch
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = flags


def threshold_phase(dev, task):
    """The threshold trainer at full width, (a), (b) and (c), 3 rounds
    each: one ``fairk_update`` per round (plus the one-bit route's folds
    and detections), finite weights and losses, ``n_selected`` within 10%
    of k (the reference's threshold-vs-exact tolerance, 0.01 of d at ρ
    0.1); then kernel and plain trajectories identical (cuDNN
    deterministic).  Host syncs per warm round of (a) reported."""
    import math
    import torch
    from repro_torch.fl import train

    params0, loss_fn, eval_fn, sample_round = task
    launches = dict.fromkeys(KERNELS, 0)
    summary = {}
    flags = _deterministic()
    try:
        for name, fl in threshold_configs().items():
            reset_counters()
            hist = train(fl, params0, loss_fn, sample_round, eval_fn=eval_fn,
                         eval_every=1, device=dev)
            torch.cuda.synchronize()
            got = read_counters()
            want = dict.fromkeys(KERNELS, 0)
            want["fairk_update"] = fl.rounds
            if fl.one_bit:
                want["sign_mv"] = fl.rounds * (N_CLIENTS // CHUNK)
                want["sign_from_energy"] = fl.rounds
            check(got == want, f"{name}: launches {got}, expected {want}")
            for key in launches:
                launches[key] += got[key]
            st = hist["state"]
            check(bool(torch.isfinite(st.w).all())
                  and all(math.isfinite(x) for x in hist["loss"]),
                  f"{name}: non-finite weights or loss")
            k, n_sel = hist["k"], hist["n_selected"]
            check(all(abs(x - k) <= 0.1 * k for x in n_sel),
                  f"{name}: selected {n_sel}, not within 10% of k = {k}")
            plain = train(fl, params0, loss_fn, sample_round, device=dev,
                          kernel_mode="plain")
            _identical_states(st, plain["state"], name)
            summary[name] = {"round_ms": hist["round_ms"], "k": k,
                             "n_selected": n_sel, "loss": hist["loss"],
                             "launches": got}
            print(f"threshold {name}: {fl.rounds} rounds, launches {got}, "
                  f"selected {n_sel} (k {k}), round ms "
                  f"{[round(x, 3) for x in hist['round_ms']]}, test loss "
                  f"{[round(x, 4) for x in hist['loss']]}; kernel and plain "
                  f"trajectories identical", flush=True)
    finally:
        _restore(flags)
    per_round, where = host_syncs(dev, task,
                                  threshold_configs()["threshold_a_coherent"])
    summary["host_syncs_a"] = {"per_round": per_round, "where": where}
    print(f"host syncs threshold (a): {per_round:g} per warm round {where} "
          f"(report only)", flush=True)
    return launches, summary


def _step_rounds(dev, task, fl, kernel_mode=None):
    """``fl.rounds`` rounds through ``make_fl_step`` (the round ``train``
    runs) -> (per-round (age', sel_mask) pairs, final carry)."""
    import torch
    from repro_torch.fl import init_server, make_fl_step
    from repro_torch.fl.trainer import draw_round

    params0, loss_fn, _, sample_round = task
    state, unravel = init_server(params0, fl, dev)
    d = state.w.shape[0]
    step = make_fl_step(fl, unravel, loss_fn, d, dev, kernel_mode)
    gen = torch.Generator(device=dev)
    gen.manual_seed(fl.seed)
    carry = (state.w, state.g, state.age, state.sel_count, state.residual,
             state.theta, state.ctrl)
    per_round = []
    for t in range(fl.rounds):
        xs, ys = sample_round(t)
        w, g, age, sc, res, ts, cs = carry
        out = step(w, g, age, sc, torch.as_tensor(xs, device=dev),
                   torch.as_tensor(ys, device=dev), res, ts,
                   draw_round(gen, fl, d, dev), cs)
        carry = out[:5] + (out[6], out[7])
        per_round.append((out[2], out[5]))
    return per_round, carry


def async_configs():
    """``async_lag = 2``: exact FAIR-k, threshold (a) and packed (a), 3
    rounds each, and ``fairk_auto`` on packed, 8 rounds."""
    import dataclasses
    packed, _ = run_configs()
    a = dataclasses.replace(packed["a_coherent"], async_lag=ASYNC_LAG,
                            rounds=THRESH_ROUNDS)
    return {"async_exact": dataclasses.replace(a, backend="exact"),
            "async_threshold": dataclasses.replace(a, backend="threshold"),
            "async_packed": a,
            "async_packed_auto": dataclasses.replace(
                a, policy="fairk_auto", rounds=ADAPTIVE_ROUNDS)}


def async_phase(dev, task):
    """Async rounds at full width: after every round each selected
    coordinate carries age ``ASYNC_LAG`` and none has age 0; the launch
    counts of the synchronous route (one ``aou_merge`` per exact round,
    one ``fairk_update`` per threshold or packed round); kernel and plain
    identical (cuDNN deterministic)."""
    import torch

    launches = dict.fromkeys(KERNELS, 0)
    summary = {}
    flags = _deterministic()
    try:
        for name, fl in async_configs().items():
            reset_counters()
            rounds, carry = _step_rounds(dev, task, fl)
            torch.cuda.synchronize()
            got = read_counters()
            want = dict.fromkeys(KERNELS, 0)
            want["aou_merge" if fl.backend == "exact"
                 else "fairk_update"] = fl.rounds
            check(got == want, f"{name}: launches {got}, expected {want}")
            for key in launches:
                launches[key] += got[key]
            n_sel = []
            for t, (age, sel) in enumerate(rounds):
                chosen = sel > 0
                check(bool((age[chosen] == ASYNC_LAG).all())
                      and int((age == 0.0).sum()) == 0,
                      f"{name} round {t}: a selected coordinate without "
                      f"age {ASYNC_LAG}, or an age 0")
                n_sel.append(int(chosen.sum()))
            p_rounds, p_carry = _step_rounds(dev, task, fl, "plain")
            for i, (a, b) in enumerate(zip(carry, p_carry)):
                if isinstance(a, dict):
                    for key in a:
                        _same(a[key], b[key], f"{name} carry {i}.{key}")
                else:
                    _same(a, b, f"{name} carry {i}")
            for (a, sa), (b, sb) in zip(rounds, p_rounds):
                _same(a, b, f"{name} age'")
                _same(sa, sb, f"{name} sel_mask")
            summary[name] = {"launches": got, "n_selected": n_sel,
                             "km_frac": float(carry[6]["k_m_frac"])}
            print(f"async {name}: lag {ASYNC_LAG}, {fl.rounds} rounds, "
                  f"launches {got}, selected {n_sel}, every selected "
                  f"coordinate at age {ASYNC_LAG}, km_frac "
                  f"{float(carry[6]['k_m_frac']):.4f}; kernel and plain "
                  f"identical", flush=True)
    finally:
        _restore(flags)
    return launches, summary


def scan_phase(dev, task):
    """``scan_rounds = 3`` on packed (a), 6 rounds, against the per-round
    loop: identical state bit for bit (cuDNN deterministic)."""
    import dataclasses
    import torch
    from repro_torch.fl import train

    params0, loss_fn, _, sample_round = task
    packed, _ = run_configs()
    fl = dataclasses.replace(packed["a_coherent"], rounds=6)
    flags = _deterministic()
    try:
        reset_counters()
        scanned = train(dataclasses.replace(fl, scan_rounds=3), params0,
                        loss_fn, sample_round, device=dev)
        torch.cuda.synchronize()
        got = read_counters()
        loop = train(fl, params0, loss_fn, sample_round, device=dev)
    finally:
        _restore(flags)
    want = dict.fromkeys(KERNELS, 0)
    want["fairk_update"] = fl.rounds
    check(got == want, f"scan: launches {got}, expected {want}")
    _identical_states(scanned["state"], loop["state"], "scan_rounds")
    for key in ("mean_aou", "max_aou", "km_frac", "n_selected"):
        check(scanned[key] == loop[key], f"scan_rounds: {key} differs")
    print(f"scan_rounds: packed (a) 6 rounds in chunks of 3 equal the "
          f"per-round loop bit for bit; launches {got}; round ms "
          f"{[round(x, 3) for x in scanned['round_ms']]} (loop "
          f"{[round(x, 3) for x in loop['round_ms']]})", flush=True)
    return got, {"round_ms": scanned["round_ms"],
                 "loop_round_ms": loop["round_ms"]}


def _same_out(a, b, what):
    """``_same`` over nested tuples, lists and dicts of tensors."""
    import torch
    if isinstance(a, dict):
        check(set(a) == set(b), f"{what}: keys {set(a)} vs {set(b)}")
        for key in a:
            _same_out(a[key], b[key], f"{what}.{key}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same_out(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        _same(a, b, what)
    else:
        check(a == b, f"{what}: {a} vs {b}")


def _syncs(fn) -> int:
    """Host syncs one warm call of ``fn`` makes (sync debug mode).  Where
    there is one, a further call in the "error" mode prints the stack of
    the first."""
    import traceback
    import warnings
    import torch
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n = sum("called a synchronizing" in str(w.message) for w in caught)
    if n:
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError:
            print("the first host sync:\n" + "".join(
                traceback.format_exc().splitlines(True)[-24:]), flush=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return n


def _profile_round(fn, top: int = 8, label: str = "one fused tree round"):
    """Device time of one call of ``fn`` by kernel (``torch.profiler``,
    after a warm-up call): report only."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total / 1e3, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile of {label}: device {total:.3f} ms in "
          f"{sum(r[2] for r in rows)} operations", flush=True)
    for ms, key, n in rows[:top]:
        print(f"  {ms:8.4f} ms  x{n:<4d} {key[:90]}", flush=True)
    return {"device_ms": total, "ops": sum(r[2] for r in rows),
            "top": [(ms, key[:90], n) for ms, key, n in rows[:top]]}


# --------------------------------------------------------------------------
# the scenario layers: faults and the watchdog, the population, the channel
# --------------------------------------------------------------------------

SCEN_FAULTS = dict(dropout=0.2, burst=4.0, fade=0.05, nan_rate=1e-4)
SCEN_CHANNEL = dict(rho_f=0.9, csi_err=0.05, shadow_db=4.0, gmin=0.3)
SCEN_POPULATION = 1_000_000         # virtual clients behind the 50
SCEN_SWEEP_POPULATION = 16_384      # virtual clients per sweep lane
SCAN_ROUNDS = 64                    # the population scan's rounds


def scenario_configs():
    """The scenario runs at full width: chaos on (a) packed, (c) threshold
    with EF and exact FAIR-k; ``fairk_auto`` on packed with chaos and the
    watchdog; a population of 10^6 (Gilbert–Elliott on packed (a),
    diurnal on exact FAIR-k); the wireless channel on packed (a), packed
    (b) and exact one-bit; and faults (fades, NaN) with the population and
    the channel on packed (a)."""
    import dataclasses
    from repro_torch.core import channel, faults, population
    packed, exact = run_configs()
    a, b = packed["a_coherent"], packed["b_one_bit"]
    fc = faults.FaultConfig(**SCEN_FAULTS)
    wl = channel.ChannelConfig(n_clients=N_CLIENTS, **SCEN_CHANNEL)
    pop_ge = population.PopulationConfig(n_clients=SCEN_POPULATION,
                                         participants=N_CLIENTS, mode="ge")
    pop_di = population.PopulationConfig(n_clients=SCEN_POPULATION,
                                         participants=N_CLIENTS,
                                         mode="diurnal")
    r = dataclasses.replace
    return {
        "chaos_a": r(a, faults=fc, rounds=5),
        "chaos_c_threshold": r(packed["c_coherent_ef"], backend="threshold",
                               faults=fc, rounds=3),
        "chaos_exact": r(exact["exact_fairk"], faults=fc, rounds=3),
        "watchdog_auto": r(a, policy="fairk_auto", faults=fc,
                           watchdog=faults.WatchdogConfig(),
                           rounds=ADAPTIVE_ROUNDS),
        "population_ge": r(a, population=pop_ge, rounds=5),
        "population_diurnal_exact": r(exact["exact_fairk"],
                                      population=pop_di, rounds=3),
        "wireless_a": r(a, wireless=wl, rounds=5),
        "wireless_one_bit": r(b, wireless=wl, rounds=3),
        "wireless_one_bit_exact": r(b, backend="exact", wireless=wl,
                                    rounds=3),
        "composed": r(a, faults=faults.FaultConfig(fade=0.05,
                                                    nan_rate=1e-4),
                      population=pop_ge, wireless=wl, rounds=3),
    }


def _scenario_launches(fl):
    """A scenario round's launches: one ``fairk_update`` (threshold,
    packed) or one mask-form ``aou_merge`` (exact), and on the one-bit
    uplink one weighted fold per chunk and one detection."""
    want = dict.fromkeys(KERNELS, 0)
    want["aou_merge" if fl.backend == "exact" else "fairk_update"] = (
        fl.rounds)
    if fl.one_bit:
        want["sign_mv"] = fl.rounds * (N_CLIENTS // CHUNK)
        want["sign_from_energy"] = fl.rounds
    return want


class _SelectionGuard:
    """Wraps ``SelectionEngine.select_and_merge`` for a run: counts, on the
    device (no sync), the coordinates a server phase selected although
    they were erased or non-finite, and the non-finite values it merged;
    ``calls`` is the number of server phases."""

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        import torch
        from repro_torch.core.engine import SelectionEngine
        self.orig = SelectionEngine.select_and_merge
        self.bad = torch.zeros((), device=self.dev)
        self.calls = 0
        guard = self

        def wrapped(eng, g, g_prev, age, **kw):
            out = guard.orig(eng, g, g_prev, age, **kw)
            g_t, age_next, stats = out
            sel = (stats["sel_mask"] > 0 if "sel_mask" in stats
                   else age_next == 0.0)
            unsent = ~torch.isfinite(g)
            if kw.get("erase") is not None:
                unsent = unsent | (kw["erase"] > 0.0)
            guard.bad = (guard.bad + (sel & unsent).sum()
                         + (~torch.isfinite(g_t)).sum())
            guard.calls += 1
            return out

        SelectionEngine.select_and_merge = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.core.engine import SelectionEngine
        SelectionEngine.select_and_merge = self.orig


def _outage_rounds(dev, task, fl, rounds: int = 2):
    """``rounds`` rounds of ``fl`` (an unreachable truncation threshold)
    through ``make_fl_step`` from seeded ``g_prev`` and ages: each must
    merge nothing — ``g_t`` equal to ``g_prev`` bit for bit, every age one
    older, no coordinate selected, the counts unchanged."""
    import torch
    from repro_torch.fl import init_server, make_fl_step
    from repro_torch.fl.trainer import draw_round, init_fault_state

    params0, loss_fn, _, sample_round = task
    state, unravel = init_server(params0, fl, dev)
    d = state.w.shape[0]
    step = make_fl_step(fl, unravel, loss_fn, d, dev)
    fstate = init_fault_state(fl, state)
    gen = torch.Generator(device=dev).manual_seed(3)
    g = torch.randn(d, generator=gen, device=dev)
    age = torch.randint(0, 50, (d,), generator=gen, device=dev).to(
        torch.float32)
    w, sc = state.w, state.sel_count
    for t in range(rounds):
        xs, ys = sample_round(t)
        out = step(w, g, age, sc, torch.as_tensor(xs, device=dev),
                   torch.as_tensor(ys, device=dev), state.residual,
                   state.theta, draw_round(gen, fl, d, dev), state.ctrl,
                   fstate)
        _same(out[1], g, f"outage {fl.backend} round {t} g_t")
        _same(out[2], age + 1.0, f"outage {fl.backend} round {t} age'")
        check(float(out[5].sum()) == 0.0 and bool(torch.equal(out[3], sc)),
              f"outage {fl.backend} round {t}: a coordinate was selected")
        check(float(out[8]["n_selected"]) == 0.0,
              f"outage {fl.backend} round {t}: n_selected "
              f"{float(out[8]['n_selected'])}")
        w, g, age, fstate = out[0], out[1], out[2], out[9]
    return rounds


def scenario_phase(dev, task):
    """The scenario layers at full width (``scenario_configs``): each run
    through ``train`` with the counts set to 0 before it — the launches of
    ``_scenario_launches``, no erased or non-finite coordinate selected,
    finite weights and losses, steady round ms (these rounds include the
    selection guard's checks); then again with cuDNN
    deterministic, with the kernels and with the plain versions: identical
    states, fault states and ``km_frac``; 0 host syncs in a warm round of
    every run; total-outage rounds (``gmin = 1e9``) merge nothing on
    packed, threshold, exact and one-bit; and the sweep (80 lanes × 2,048,
    N = 16, 20 rounds) with fault, population (16,384 virtual clients per
    lane) and wireless lanes: one mask-form ``aou_merge`` per round,
    kernel and plain grids identical."""
    import dataclasses
    import math
    import torch
    from repro_torch.core import channel, faults, population
    from repro_torch.fl import sweep, train

    params0, loss_fn, eval_fn, sample_round = task
    launches = dict.fromkeys(KERNELS, 0)
    summary = {}
    configs = scenario_configs()
    for name, fl in configs.items():
        reset_counters()
        with _SelectionGuard(dev) as guard:
            hist = train(fl, params0, loss_fn, sample_round,
                         eval_fn=eval_fn, eval_every=fl.rounds, device=dev)
            torch.cuda.synchronize()
        got, want = read_counters(), _scenario_launches(fl)
        check(got == want, f"{name}: launches {got}, expected {want}")
        for key in launches:
            launches[key] += got[key]
        check(guard.calls == fl.rounds,
              f"{name}: {guard.calls} server phases in {fl.rounds} rounds")
        check(float(guard.bad) == 0.0,
              f"{name}: {float(guard.bad)} erased or non-finite coordinates "
              f"selected or merged")
        check(bool(torch.isfinite(hist["state"].w).all())
              and all(math.isfinite(x) for x in hist["loss"]),
              f"{name}: non-finite weights or loss {hist['loss']}")
        steady = statistics.median(hist["round_ms"][1:])
        summary[name] = {"round_ms": hist["round_ms"],
                         "steady_round_ms": steady, "launches": got,
                         "n_selected": hist["n_selected"],
                         "loss": hist["loss"], "acc": hist["acc"],
                         "wd_trips": hist.get("wd_trips")}
        print(f"scenario {name}: {fl.backend}, {fl.rounds} rounds, launches "
              f"{got}, selected {hist['n_selected']}, no erased or "
              f"non-finite coordinate selected, round ms "
              f"{[round(x, 3) for x in hist['round_ms']]} (steady "
              f"{steady:.3f}), test loss {hist['loss'][-1]:.4f}"
              + (f", watchdog trips {hist['wd_trips']:g}"
                 if fl.watchdog is not None else ""), flush=True)
    flags = _deterministic()
    try:
        for name, fl in configs.items():
            runs = {mode: train(fl, params0, loss_fn, sample_round,
                                device=dev, kernel_mode=mode)
                    for mode in (None, "plain")}
            k, p = runs[None], runs["plain"]
            _identical_states(k["state"], p["state"], name)
            _same_out(k["fstate"], p["fstate"], f"{name} fstate")
            check(k["km_frac"] == p["km_frac"], f"{name}: km_frac differs")
            # the same rounds without the selection guard's device work
            # (with cuDNN deterministic)
            bare = statistics.median(k["round_ms"][1:])
            summary[name]["unguarded_steady_round_ms"] = bare
            print(f"scenario {name}: kernel and plain trajectories "
                  f"identical over {fl.rounds} rounds (w, g, ages, counts, "
                  f"residual, thresholds, controller and fault state); "
                  f"unguarded steady round {bare:.3f} ms", flush=True)
    finally:
        _restore(flags)
    syncs = {}
    for name, fl in configs.items():
        per_round, where = host_syncs(dev, task, fl)
        syncs[name] = {"per_round": per_round, "where": where}
        print(f"host syncs scenario {name}: {per_round:g} per warm round "
              f"{where}", flush=True)
        check(per_round == 0,
              f"host syncs {name}: {per_round:g} per warm round at {where}")
    summary["host_syncs"] = syncs
    packed, exact = run_configs()
    dead = channel.ChannelConfig(n_clients=N_CLIENTS, near=1.0, pl_exp=0.0,
                                 gmin=1e9, pmax=1e12)
    outage = {"packed": packed["a_coherent"],
              "threshold": dataclasses.replace(packed["a_coherent"],
                                               backend="threshold"),
              "exact": exact["exact_fairk"],
              "packed_one_bit": packed["b_one_bit"]}
    for name, fl in outage.items():
        _outage_rounds(dev, task, dataclasses.replace(fl, wireless=dead))
    print(f"scenario total outage (gmin = 1e9): 2 rounds each on "
          f"{list(outage)}: g_t equal to g_prev, every age one older, "
          f"nothing selected", flush=True)
    summary["total_outage"] = list(outage)
    grids = {
        "faults": dict(faults=faults.FaultConfig(**SCEN_FAULTS)),
        "population": dict(population=population.PopulationConfig(
            n_clients=SCEN_SWEEP_POPULATION, participants=SWEEP_N,
            mode="ge")),
        "wireless": dict(wireless=channel.ChannelConfig(
            n_clients=SWEEP_N, **SCEN_CHANNEL)),
    }
    for name, kw in grids.items():
        cfg = sweep.SweepConfig(d=SWEEP_D, n_clients=SWEEP_N, rho=0.2,
                                rounds=SWEEP_ROUNDS, **kw)
        seeds, pids, kms, adaptives, labels = sweep.sweep_grid(
            ("fairk", "fairk_auto"), SWEEP_RATIOS, SWEEP_SEEDS, cfg)
        draws = sweep.draw_lanes(cfg, seeds, dev)
        out = {}
        for mode in (None, "plain"):
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[mode] = sweep.run_grid(cfg, seeds, pids, kms, adaptives,
                                       draws=draws, device=dev,
                                       kernel_mode=mode)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / SWEEP_ROUNDS
            got = read_counters()
            if mode is None:
                k_ms, k_got = ms, got
        want = dict.fromkeys(KERNELS, 0)
        want["aou_merge"] = SWEEP_ROUNDS
        check(k_got == want, f"sweep {name}: launches {k_got}, expected "
                             f"{want}")
        for key in launches:
            launches[key] += k_got[key]
        for key in out[None]:
            _same(out[None][key], out["plain"][key], f"sweep {name} {key}")
        fresh = out[None]["frac_fresh"]
        check(bool((fresh <= cfg.k / cfg.d).all())
              and bool(torch.isfinite(out[None]["loss"]).all()),
              f"sweep {name}: a lane refreshed more than k, or a non-finite "
              f"loss")
        summary[f"sweep_{name}"] = {"ms_per_round": k_ms,
                                    "plain_ms_per_round": ms,
                                    "mean_frac_fresh": float(fresh.mean())}
        print(f"scenario sweep {name}: {len(labels)} lanes x d = {SWEEP_D}, "
              f"{SWEEP_ROUNDS} rounds, launches {k_got}, kernel and plain "
              f"grids identical, mean refreshed share "
              f"{float(fresh.mean()):.4f} (k/d {cfg.k / cfg.d:.4f}); "
              f"{k_ms:.3f} ms per grid round "
              f"(plain {ms:.3f}, first run each)", flush=True)
    from benchmarks import torch_population_bench
    scan = torch_population_bench.bench_scan(SCEN_POPULATION,
                                             rounds=SCAN_ROUNDS, device=dev)
    check(math.isfinite(scan["client_rounds_per_s"])
          and abs(scan["mean_n_avail"] / SCEN_POPULATION - 0.9) < 0.01,
          f"population scan: {scan}")
    summary["population_scan"] = scan
    print(f"scenario population scan: {SCEN_POPULATION} Gilbert–Elliott "
          f"clients x {SCAN_ROUNDS} rounds in {scan['scan_s']:.4f} s "
          f"(median of 3): {scan['client_rounds_per_s']:.6g} client-rounds "
          f"per s; mean availability "
          f"{scan['mean_n_avail'] / SCEN_POPULATION:.4f}", flush=True)
    return launches, summary


def _seeded(fn, dev):
    """``fn`` whose trailing generator argument is made from a seed, so
    that two calls with one seed draw the same numbers."""
    import torch

    def call(*args):
        *head, seed = args
        return fn(*head, torch.Generator(device=dev).manual_seed(seed))
    return call


def tree_phase(dev):
    """The multi-leaf server phase on the ``--full`` tree through
    ``torch_packed_bench``'s builders: packed (cold, sampled bootstrap),
    persisted (the legacy two-pass round), persisted_ef, fused_stats
    (checked on its sixth carried round), adaptive, async, sanitize, and
    the scenario rows chaos (corruption and fade erasures) and channel
    (the per-block fading chain, outage erasures and the CSI factor).
    Each round makes one ``fairk_update`` launch; a persisted round 1 pack
    and 1 unpack (the re-packing one 3 and 2); ``G_READS`` 1 on the fused
    rounds, 3 on the legacy ones; pads are never selected and keep age −1;
    every output (trees, flat buffers, threshold state, counts and
    histograms) equals its plain rerun.  Each row is timed with CUDA
    events (median of 5 rounds); the legacy warm round's host syncs are
    counted."""
    import torch
    from benchmarks import torch_packed_bench as bench
    from repro_torch.core import controller, packing
    from repro_torch.kernels import fairk_update, ops

    tree, g_prev, age, lay = full_tree(dev)
    pads = ~lay.valid_mask(dev)
    k = bench._mk_engine("packed", lay).budgets()[0]
    ts0 = packing.init_threshold_state(dev)
    _, flat_state, _ = bench.build_persisted_fn(tree, warm=False)
    gp_flat, age_flat, _ = flat_state(g_prev, age)
    res_flat = torch.zeros(lay.d_packed, device=dev)

    def builders(mode):
        packed_fn, _, _ = bench.build_packed_fn(tree, warm=False,
                                                kernel_mode=mode)
        pers, _, _ = bench.build_persisted_fn(tree, warm=True,
                                              kernel_mode=mode)
        pers_ef, _, _ = bench.build_persisted_fn(
            tree, warm=False, error_feedback=True, kernel_mode=mode)
        fused, _, _ = bench.build_persisted_fn(tree, warm=True,
                                               fused_stats=True,
                                               kernel_mode=mode)
        adaptive, _ = bench.build_adaptive_fn(tree, kernel_mode=mode)
        async_fn, _, _ = bench.build_async_fn(tree, kernel_mode=mode)
        sanitize, _ = bench.build_sanitize_fn(tree, kernel_mode=mode)
        chaos, _ = bench.build_chaos_fn(tree, kernel_mode=mode)
        chan_fn, _, _ = bench.build_channel_fn(tree, kernel_mode=mode)
        return {"packed": packed_fn, "persisted": pers,
                "persisted_ef": pers_ef, "fused_stats": fused,
                "adaptive": adaptive, "async": async_fn,
                "sanitize": sanitize, "chaos": _seeded(chaos, dev),
                "channel": _seeded(chan_fn, dev)}

    kern, plain = builders(None), builders("plain")
    # five carried fused rounds: the sixth is the one checked and timed
    ts_f = ts0
    gp_w, age_w = gp_flat, age_flat
    for _ in range(5):
        _, gp_w, age_w, _, ts_f = kern["fused_stats"](tree, gp_w, age_w,
                                                      None, ts_f)
    cvec = controller.controller_state_to_vec(
        controller.init_controller_state(0.75, dev))
    _, fad0, _ = bench.build_channel_fn(tree)
    args = {"packed": (tree, g_prev, age, None),
            "persisted": (tree, gp_flat, age_flat, None, None),
            "persisted_ef": (tree, gp_flat, age_flat, res_flat, None),
            "fused_stats": (tree, gp_w, age_w, None, ts_f),
            "adaptive": (tree, gp_w, age_w, ts_f, cvec),
            "async": (tree, gp_w, age_w, ts_f, gp_w, gp_w),
            "sanitize": (tree, gp_w, age_w, ts_f),
            "chaos": (tree, gp_w, age_w, ts_f, 7),
            "channel": (tree, gp_w, age_w, ts_f, fad0, 9)}
    fused_rows = ("fused_stats", "adaptive", "async", "sanitize", "chaos",
                  "channel")
    launches = dict.fromkeys(KERNELS, 0)
    summary = {"streak_after_5": float(ts_f["streak"]), "k": k}
    for name, fn in kern.items():
        reset_counters()
        out, cnt = bench.counted(fn, *args[name])
        torch.cuda.synchronize()
        got = read_counters()
        want = dict.fromkeys(KERNELS, 0)
        want["fairk_update"] = 1
        check(got == want, f"tree {name}: launches {got}, expected {want}")
        for key in launches:
            launches[key] += got[key]
        copies = (3, 2) if name == "packed" else (1, 1)
        reads = 1 if name in fused_rows else 3
        check(cnt == (1,) + copies + (reads,),
              f"tree {name}: (launches, packs, unpacks, reads of g) {cnt}, "
              f"expected {(1,) + copies + (reads,)}")
        if name != "packed":         # the carried flat int8 age buffer
            check(bool((out[2][pads] == packing.PAD_AGE).all()),
                  f"tree {name}: a pad was selected or lost its age -1")
        ts_out = out[{"packed": 2, "adaptive": 3, "async": 3,
                      "sanitize": 3, "chaos": 3, "channel": 3}.get(name, 4)]
        if name in ("chaos", "channel"):
            # erased and corrupted coordinates are never merged
            check(bool(torch.isfinite(out[1]).all()),
                  f"tree {name}: a non-finite value was merged")
        n_sel = float(ts_out["n_sel"])
        check(0 < n_sel <= lay.d_valid, f"tree {name}: selected {n_sel}")
        if name == "async":
            check(not bool((out[6][pads] > 0).any()),
                  "tree async: a pad was selected")
        _same_out(out, plain[name](*args[name]), f"tree {name}")
        before = fairk_update.LAUNCHES
        us, _ = bench.timed_med(lambda: fn(*args[name]), 5)
        check(fairk_update.LAUNCHES - before == 6,
              f"tree {name}: timed rounds launched "
              f"{fairk_update.LAUNCHES - before}")
        summary[name] = {"ms": us / 1e3, "counts": cnt, "n_sel": n_sel}
        print(f"tree {name}: 1 fairk_update launch, (packs, unpacks) "
              f"{copies}, reads of g {reads}, selected {n_sel:.0f} of "
              f"{lay.d_valid} (k {k}), pads unselected at age -1, equal "
              f"to its plain rerun; {us / 1e3:.3f} ms per round (median "
              f"of 5, CUDA events)", flush=True)
    summary["profile_fused"] = _profile_round(
        lambda: kern["fused_stats"](*args["fused_stats"]))
    summary["legacy_warm_syncs"] = _syncs(
        lambda: kern["persisted"](tree, gp_flat, age_flat, None,
                                  bench.warm_state(ts_f, k)))
    print(f"tree persisted warm round: {summary['legacy_warm_syncs']} host "
          f"syncs (the warm and bootstrap thresholds are both computed and "
          f"chosen with torch.where)", flush=True)
    # the bf16 g_prev / int8 age inputs: the f32 casts around the launch
    gp32 = gp_flat.to(torch.float32)
    age32 = age_flat.to(torch.float32)
    g_flat = lay.pack(tree)
    tm, ta = (torch.tensor(v, device=dev) for v in (1.6, 30.5))
    summary["cast_ms"] = _time_ms(
        lambda: (gp_flat.to(torch.float32), age_flat.to(torch.float32)),
        blocks=10)[0]
    summary["kernel_f32_ms"] = _time_ms(
        lambda: ops.fairk_stats_update(g_flat, gp32, age32, tm, ta),
        blocks=10)[0]
    summary["kernel_bf16_int8_ms"] = _time_ms(
        lambda: ops.fairk_stats_update(g_flat, gp_flat, age_flat, tm, ta),
        blocks=10)[0]
    print(f"tree persisted shape: the bf16 g_prev and int8 age casts take "
          f"{summary['cast_ms']:.4f} ms (2 device operations, "
          f"{6 * lay.d_packed / 1e6:.0f} MB read, {8 * lay.d_packed / 1e6:.0f}"
          f" MB written); fairk_update [stats] on float32 inputs "
          f"{summary['kernel_f32_ms']:.4f} ms, on the bf16/int8 buffers "
          f"with the casts {summary['kernel_bf16_int8_ms']:.4f} ms",
          flush=True)
    return launches, summary


def engine_big_phase(dev):
    """The threshold engine at d = 10^8, one round, kernel equal to plain;
    ``exact_theta`` at d = 109,210 on tie-free input (distinct magnitudes,
    distinct ages): the selected set is exact FAIR-k's."""
    import torch
    from repro_torch.core.engine import EngineConfig, SelectionEngine

    gen = torch.Generator(device=dev).manual_seed(13)
    d = ENGINE_BIG
    g = torch.randn(d, generator=gen, device=dev)
    g_prev = torch.randn(d, generator=gen, device=dev)
    age = torch.randint(0, 40, (d,), generator=gen, device=dev).to(
        torch.float32)
    launches = dict.fromkeys(KERNELS, 0)
    outs = {}
    for mode in (None, "plain"):
        eng = SelectionEngine(EngineConfig(backend="threshold",
                                           kernel_mode=mode), d)
        reset_counters()
        outs[mode] = eng.select_and_merge(g, g_prev, age)
        torch.cuda.synchronize()
        if mode is None:
            got = read_counters()
    _same_out(outs[None], outs["plain"], "engine 1e8")
    want = dict.fromkeys(KERNELS, 0)
    want["fairk_update"] = 1
    check(got == want, f"engine 1e8: launches {got}, expected {want}")
    n_sel, k = float(outs[None][2]["n_selected"]), outs[None][2]["k"]
    check(abs(n_sel - k) <= 0.1 * k, f"engine 1e8: selected {n_sel}, k {k}")
    from benchmarks.torch_packed_bench import timed_med
    eng = SelectionEngine(EngineConfig(backend="threshold"), d)
    ms = timed_med(lambda: eng.select_and_merge(g, g_prev, age),
                   5)[0] / 1e3
    del g, g_prev, age, outs
    for key in launches:
        launches[key] += got[key]
    # exact_theta against exact FAIR-k, tie-free
    g = torch.randn(D, generator=gen, device=dev)
    age = torch.randperm(D, generator=gen, device=dev).to(torch.float32)
    thr = SelectionEngine(EngineConfig(backend="threshold",
                                       exact_theta=True), D)
    exact = SelectionEngine(EngineConfig(backend="exact"), D)
    reset_counters()
    _, age_t, _ = thr.select_and_merge(g, torch.zeros_like(g), age)
    torch.cuda.synchronize()
    got = read_counters()
    launches["fairk_update"] += got["fairk_update"]
    want_mask = torch.zeros(D, dtype=torch.bool, device=dev)
    want_mask[exact.select(g, age)] = True
    check(bool(torch.equal(age_t == 0.0, want_mask)),
          "exact_theta: the selected set differs from exact FAIR-k's")
    print(f"engine: threshold select_and_merge at d = {d} (k {k}, "
          f"selected {n_sel:.0f}) equals its plain version, 1 fairk_update "
          f"launch, {ms:.3f} ms per call (median of 5, CUDA events); "
          f"exact_theta at "
          f"d = {D} selects exact FAIR-k's {int(want_mask.sum())} "
          f"coordinates", flush=True)
    return launches, {"d": d, "k": k, "n_selected": n_sel, "ms": ms}


# --------------------------------------------------------------------------
# the launch path: the single-card train step at internvl2-1b's full width
# --------------------------------------------------------------------------

LAUNCH_ARCH = "internvl2-1b"
LAUNCH_SEQ = 256                    # text tokens after the 256-patch prefix
LAUNCH_BATCH, LAUNCH_MICRO = 4, 2   # batch 4 as two microbatches
LAUNCH_D = 629_664_256              # packed coordinates (384 of them pads)


def launch_configs():
    """(name, OacServerConfig, steps): (i) the default persisted
    fused-stats route, (ii) one-bit with error feedback (and vote noise),
    (iii) adaptive + async + sanitize + fades + the wireless channel."""
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.launch.steps import OacServerConfig
    return [("fused", OacServerConfig(rho=0.1), 3),
            ("one_bit_ef", OacServerConfig(rho=0.1, one_bit=True,
                                           error_feedback=True,
                                           noise_std=0.5), 2),
            ("composed", OacServerConfig(
                rho=0.1, adaptive_km=True, async_agg=True, sanitize=True,
                fade=0.05, wireless=ChannelConfig(rho_f=0.5, gmin=0.3)), 2)]


def _launch_kernels(dev, records):
    """``fairk_update`` [stats] / [stats+fresh+res] and ``sign_mv`` (1, d)
    with noise at the launch path's 629,664,256 coordinates, kernel
    against plain: equal bit for bit, timed (device ms from a graph of 2
    calls replayed 3 times; the plain version from 1 call)."""
    import torch
    from repro_torch.kernels import ops
    d = LAUNCH_D
    gen = torch.Generator(device=dev).manual_seed(19)
    g = torch.randn(d, generator=gen, device=dev) * 0.01
    g_prev = torch.randn(d, generator=gen, device=dev)
    age = torch.randint(0, 40, (d,), generator=gen, device=dev).float()
    age[-384:] = -1.0
    res = torch.randn(d, generator=gen, device=dev) * 1e-3
    fresh = torch.where(torch.rand(d, generator=gen, device=dev) < 0.5,
                        1.0, -1.0)
    tm, ta = (torch.tensor(v, device=dev) for v in (0.0196, 35.5))

    def case(name, kw, n_bytes):
        k = ops.fairk_stats_update(g, g_prev, age, tm, ta, mode="kernel",
                                   **kw)
        p = ops.fairk_stats_update(g, g_prev, age, tm, ta, mode="plain",
                                   **kw)
        errs = [_same(a, b, f"{name} out{i}")
                for i, (a, b) in enumerate(zip(k[:3], p[:3]))
                if a is not None]
        errs += [_same(k[3][key], p[3][key], f"{name} {key}")
                 for key in ("n_sel", "n_sel_m", "mag_hist", "age_hist")]
        del k, p
        ms = {"kernel": _time_ms(lambda: ops.fairk_stats_update(
                  g, g_prev, age, tm, ta, mode="kernel", **kw),
                  blocks=3, per_block=2),
              "plain": _time_ms(lambda: ops.fairk_stats_update(
                  g, g_prev, age, tm, ta, mode="plain", **kw),
                  blocks=2, per_block=1)}
        torch.cuda.empty_cache()
        records[name] = _record(max(errs), ms, n_bytes,
                                *_bound_ms(n_bytes, 12 * d))

    case(f"fairk_update[stats][launch {d}]", {}, 20 * d + 4 * 258 + 8)
    case(f"fairk_update[stats+fresh+res][launch {d}]",
         dict(residual=res, fresh=fresh), 32 * d + 4 * 258 + 8)
    del fresh, g_prev, age
    torch.cuda.empty_cache()
    votes = (g + res)[None]
    noise = 0.5 * torch.randn(d, generator=gen, device=dev)
    del g, res
    name = f"sign_mv[1x{d}+noise][launch]"
    ks, ke = ops.sign_mv(votes, noise, mode="kernel")
    ps, pe = ops.sign_mv(votes, noise, mode="plain")
    err = max(_same(ks, ps, f"{name} signs"), _same(ke, pe,
                                                   f"{name} energy"))
    del ks, ke, ps, pe
    ms = {"kernel": _time_ms(lambda: ops.sign_mv(votes, noise,
                                                 mode="kernel"),
                             blocks=3, per_block=2),
          "plain": _time_ms(lambda: ops.sign_mv(votes, noise, mode="plain"),
                            blocks=2, per_block=1)}
    n_bytes = 16 * d
    records[name] = _record(err, ms, n_bytes, *_bound_ms(n_bytes, 2 * d))
    del votes, noise
    torch.cuda.empty_cache()
    for key in (f"fairk_update[stats][launch {d}]",
                f"fairk_update[stats+fresh+res][launch {d}]", name):
        rec = records[key]
        print(f"kernel {key}: exact match; device {rec['ms']:.3f} ms "
              f"(plain {rec['plain_ms']:.3f} ms), bound "
              f"{rec['bound_ms']:.3f} ms by {rec['bound_by']}", flush=True)


def _clone_state(state):
    from repro_torch import tree as tree_util
    return tree_util.tree_map(lambda x: x.clone(), state)


def _states_same(a, b, what):
    from repro_torch import tree as tree_util
    la, lb = tree_util.leaves(a), tree_util.leaves(b)
    check(len(la) == len(lb), f"{what}: {len(la)} vs {len(lb)} leaves")
    for (path, x), (_, y) in zip(la, lb):
        _same(x, y, f"{what} {path}")


def _cli_resume_check(dev):
    """``repro_torch.launch.train`` at the reduced config on the card: 4
    steps in one run against 2 steps, a checkpoint, and ``--resume`` for
    2 more, under deterministic algorithms: identical final state."""
    import tempfile
    import torch
    from repro_torch.launch import train
    base = ["--arch", LAUNCH_ARCH, "--batch", "4", "--seq", "64",
            "--client-chunk", "2", "--adaptive-km", "--ef"]
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            whole = train.main(base + ["--steps", "4", "--ckpt-dir",
                                       tmp + "/a"])
            train.main(base + ["--steps", "2", "--ckpt-every", "2",
                               "--ckpt-dir", tmp + "/b"])
            rest = train.main(base + ["--steps", "2", "--resume",
                                      "--ckpt-dir", tmp + "/b"])
    finally:
        torch.use_deterministic_algorithms(False)
    check(rest["start"] == 2, f"resume started at {rest['start']}")
    check(rest["losses"] == whole["losses"][2:],
          f"resumed losses {rest['losses']} vs {whole['losses'][2:]}")
    for key in ("params", "opt", "server"):
        _states_same(rest[key], whole[key], f"cli resume {key}")
    print(f"launch cli: --ckpt-every 2 / --resume continues the 4-step "
          f"trajectory bit for bit (losses {whole['losses']})", flush=True)
    return whole["losses"]


def _train_run(dev, label, cfg, shape, oac, n_steps, batch, n_micro,
               tokens, *, compare=True, syncs=False, profile=False):
    """``n_steps`` steps of ``make_train_step(cfg, shape, oac)`` from a
    seeded ``init_lm`` with the configuration's optimizer, the launch
    counts set to 0 just before them and read just after: one
    ``fairk_update`` launch per step (and one ``sign_mv`` on the one-bit
    route), 1 pack, 1 unpack and 1 read of g per step, finite losses and
    weights, pads never selected; with ``compare`` the update phase
    through the kernels and through the plain versions from one cloned
    state and one recorded gradient tree, identical; with ``syncs`` 0
    host syncs in a warm step; with ``profile`` the device operations of
    one step.  Returns (row, launches, (params, opt_state, server,
    layout, next step))."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.core import packing
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import make_optimizer

    kern = steps.make_train_step(cfg, shape, n_micro=n_micro, oac=oac,
                                 device=dev)
    lay = kern.layout
    params = transformer.init_lm_seeded(cfg, 0, dev)
    n_params = sum(x.numel() for _, x in tree_util.leaves(params))
    opt = make_optimizer(kern.meta["optimizer"], kern.meta["lr"])
    opt_state = opt.init(params)
    server = steps.init_server_state(params, oac=oac)
    pads = ~lay.valid_mask(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    c0 = (packing.PACK_CALLS, packing.UNPACK_CALLS, packing.G_READS)
    step_ms, losses = [], []
    for t in range(n_steps):
        b = batch(t)
        a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        params, opt_state, server, loss = kern.fn(params, opt_state,
                                                  server, b, t)
        e.record()
        torch.cuda.synchronize()
        step_ms.append(a.elapsed_time(e))
        losses.append(float(loss))
    got = read_counters()
    counts = (packing.PACK_CALLS - c0[0], packing.UNPACK_CALLS - c0[1],
              packing.G_READS - c0[2])
    steps_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    want = dict.fromkeys(KERNELS, 0)
    want["fairk_update"] = n_steps
    want["sign_mv"] = n_steps if oac.one_bit else 0
    check(got == want, f"{label}: launches {got}, expected {want}")
    check(counts == (n_steps, n_steps, n_steps),
          f"{label}: (packs, unpacks, reads of g) {counts} in {n_steps} "
          f"steps")
    check(all(math.isfinite(x) for x in losses),
          f"{label}: losses {losses}")
    check(all(bool(torch.isfinite(x).all())
              for _, x in tree_util.leaves(params)),
          f"{label}: a weight is not finite")
    check(bool((server["age"][pads] == packing.PAD_AGE).all()),
          f"{label}: a pad was selected or lost its age -1")
    n_sel = float(server["theta"][3])
    check(0 < n_sel <= lay.d_valid, f"{label}: selected {n_sel}")
    # the gradient phase and the update phase apart, on one recorded
    # gradient tree; with ``compare`` the plain update from a clone, taken
    # outside the timed interval
    t = n_steps
    b = batch(t)
    copy = _clone_state((params, opt_state, server)) if compare else None
    g0, g1, u1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    g0.record()
    _, grads = kern.grads_fn(params, b)
    g1.record()
    kern.update(params, opt_state, server, grads, t)
    u1.record()
    torch.cuda.synchronize()
    grads_ms, update_ms = g0.elapsed_time(g1), g1.elapsed_time(u1)
    if compare:
        plain = steps.make_train_step(cfg, shape, n_micro=n_micro, oac=oac,
                                      kernel_mode="plain", device=dev)
        plain.update(*copy, grads, t)
        _states_same((params, opt_state, server), copy,
                     f"{label} kernel vs plain")
    del copy, grads
    torch.cuda.empty_cache()
    steady = (statistics.median(step_ms[1:]) if len(step_ms) > 1
              else step_ms[0])
    row = {"parameters": n_params, "d_packed": lay.d_packed,
           "steps": n_steps, "losses": losses, "step_ms": step_ms,
           "steady_ms": steady, "grads_ms": grads_ms,
           "update_ms": update_ms,
           "server_share": update_ms / (grads_ms + update_ms),
           "tokens_per_s": tokens / (steady / 1e3),
           "n_selected": n_sel, "launches": got,
           "packs_unpacks_reads": counts, "steps_peak_gb": steps_peak_gb,
           "kernel_vs_plain": "identical" if compare else "not compared"}
    t += 1
    if syncs:
        b = batch(t)                 # the batch's upload is not the step's
        row["warm_syncs"] = _syncs(lambda: kern.fn(
            params, opt_state, server, b, t))
        check(row["warm_syncs"] == 0,
              f"{label}: {row['warm_syncs']} host syncs in a warm step")
        t += 2
    if profile:
        b = batch(t)
        row["profile"] = _profile_round(
            lambda: kern.fn(params, opt_state, server, b, t), top=10,
            label=f"one step of {label}")
        t += 1
    print(f"{label}: {n_params} parameters, {lay.d_packed} packed "
          f"coordinates, {n_steps} steps, losses "
          f"{[round(x, 4) for x in losses]}; launches {got}; (packs, "
          f"unpacks, reads of g) {counts}; selected {n_sel:.0f}; kernel "
          f"and plain update phases {row['kernel_vs_plain']}; steady step "
          f"{steady:.1f} ms (CUDA events; steps "
          f"{[round(x, 1) for x in step_ms]}), gradients {grads_ms:.1f} ms "
          f"+ server phase and optimizer {update_ms:.1f} ms (share "
          f"{row['server_share']:.3f}), {row['tokens_per_s']:.0f} tokens/s, "
          f"peak allocated {steps_peak_gb:.2f} GB over the steps"
          + (f", {row['warm_syncs']} host syncs in a warm step"
             if "warm_syncs" in row else ""), flush=True)
    return row, got, (params, opt_state, server, lay, t)


def launch_phase(dev, records):
    """The launch path's train step (``repro_torch.launch.steps``) on
    ``internvl2-1b`` at full width and depth (629,619,968 parameters,
    629,664,256 packed coordinates), batch 4 as two microbatches of the
    256-patch prefix plus 256 text tokens, AdamW, ρ 0.1: runs (i)-(iii) of
    ``launch_configs`` through ``_train_run`` — its checks, the kernel and
    plain update phases identical, 0 host syncs in a warm step of (i) and
    (iii) —, the server state's save/restore round trip bit for bit, and
    the launcher's --resume at the reduced config.  Reports the steady
    step time (CUDA events), the server phase's share, tokens per second,
    device time by kernel and the peak allocated memory (over each
    configuration's steps, and with its kernel-against-plain
    comparison)."""
    import shutil
    import tempfile
    import torch
    from repro_torch import checkpoint
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import train

    t_phase = time.time()
    _launch_kernels(dev, records)
    cfg = get_config(LAUNCH_ARCH)
    shape = InputShape("custom", LAUNCH_SEQ + cfg.n_patches, LAUNCH_BATCH,
                       "train")
    tokens = LAUNCH_BATCH * (LAUNCH_SEQ + cfg.n_patches)
    launches = dict.fromkeys(KERNELS, 0)
    summary = {"arch": LAUNCH_ARCH, "batch": LAUNCH_BATCH,
               "n_micro": LAUNCH_MICRO, "text_seq": LAUNCH_SEQ,
               "patches": cfg.n_patches}

    def batch(t):
        return train.make_batch(cfg, 0, t, LAUNCH_BATCH, LAUNCH_SEQ,
                                LAUNCH_MICRO, dev)

    for name, oac, n_steps in launch_configs():
        row, got, state = _train_run(
            dev, f"launch {name}", cfg, shape, oac, n_steps, batch,
            LAUNCH_MICRO, tokens, syncs=name in ("fused", "composed"),
            profile=name == "fused")
        check(row["d_packed"] == LAUNCH_D,
              f"launch: {row['d_packed']} packed coordinates")
        for key in launches:
            launches[key] += got[key]
        if name == "fused":
            _, _, server, lay, t = state
            tmp = tempfile.mkdtemp(prefix="launch_ckpt_")
            try:
                t0 = time.time()
                path = checkpoint.save_server_state(tmp, server, layout=lay,
                                                    step=t)
                t1 = time.time()
                back, _ = checkpoint.restore_server_state(path, layout=lay,
                                                          device=dev)
                t2 = time.time()
                check(set(back) == set(server), "launch ckpt: fields")
                for key in server:
                    _same(back[key], server[key], f"launch ckpt {key}")
                del back
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            row["ckpt_save_s"], row["ckpt_restore_s"] = t1 - t0, t2 - t1
            print(f"launch ckpt: save_server_state / restore_server_state "
                  f"of the {LAUNCH_D}-coordinate state bit for bit "
                  f"(save {t1 - t0:.2f} s, restore {t2 - t1:.2f} s)",
                  flush=True)
        summary[name] = row
        del state
        torch.cuda.empty_cache()
    summary["max_memory_allocated_gb"] = (
        torch.cuda.max_memory_allocated(dev) / 1e9)
    print(f"launch: torch.cuda.max_memory_allocated "
          f"{summary['max_memory_allocated_gb']:.2f} GB since the last "
          f"configuration's steps began (its kernel-against-plain "
          f"comparison holds a cloned state)", flush=True)
    summary["cli_losses"] = _cli_resume_check(dev)
    summary["seconds"] = time.time() - t_phase
    print(f"launch phase: {summary['seconds']:.1f} s", flush=True)
    return launches, summary


# --------------------------------------------------------------------------
# the layer families' train steps and the serving path
# --------------------------------------------------------------------------

FAMILY_SEQ = 512                    # mamba2 / granite tokens per sequence
WHISPER_TEXT = 256                  # whisper: text tokens (1,500 frames)
GRANITE_LAYERS = 8                  # granite-moe's depth cut, of 32
SERVE_BATCH, SERVE_NEW = 4, 32      # serving: batch, greedy tokens decoded
# decode against teacher forcing: the relative L2 error of each
# position's logits.  bf16: tests/test_torch_serve.py holds 0.02 at 2
# layers and 4 tokens (measured 0.011); at full depth over 32 tokens the
# card measured 0.020 (internvl2-1b) and 0.053 (mamba2-370m, whose SSM
# carry is rounded to bf16 after every token, as the reference's is), so
# 0.1; the float32 rerun of mamba2-370m is held to 1e-4
SERVE_REL_L2 = {"bfloat16": 0.1, "float32": 1e-4}


def family_models():
    """(label, config, text tokens, full width?) of the families phase:
    ``mamba2-370m`` and ``whisper-base`` whole, ``granite-moe-3b-a800m``
    at full width with its depth cut to 8 of 32 layers (the whole model's
    3.37B parameters at ~41 bytes each would not fit the card), and
    narrow structural runs of ``jamba-1.5-large-398b`` and
    ``arctic-480b`` (reduced: width cut, no speed reported)."""
    import dataclasses
    from repro_torch.configs import get_config
    return [
        ("mamba2-370m", get_config("mamba2-370m"), FAMILY_SEQ, True),
        ("whisper-base", get_config("whisper-base"), WHISPER_TEXT, True),
        (f"granite-moe-3b-a800m[{GRANITE_LAYERS} layers]",
         dataclasses.replace(get_config("granite-moe-3b-a800m"),
                             n_layers=GRANITE_LAYERS),
         FAMILY_SEQ, True),
        ("reduced(jamba-1.5-large-398b)",
         get_config("jamba-1.5-large-398b", reduced_variant=True), 64,
         False),
        ("reduced(arctic-480b)",
         get_config("arctic-480b", reduced_variant=True), 64, False),
    ]


def families_phase(dev):
    """The train step of every other layer family (``_train_run``): batch
    4 as two microbatches, ρ 0.1, the configuration's optimizer, (i) the
    persisted fused-stats route — 3 steps at full width, 2 on the narrow
    runs — and on ``mamba2-370m`` also (ii) one-bit with error feedback, 2
    steps; kernel and plain update phases identical except on granite
    (its cloned state would not fit), 0 host syncs in a warm step and the
    device operations of one step at full width."""
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.launch import train
    from repro_torch.launch.steps import OacServerConfig

    t_phase = time.time()
    launches = dict.fromkeys(KERNELS, 0)
    summary = {"batch": LAUNCH_BATCH, "n_micro": LAUNCH_MICRO}
    for label, cfg, seq, full in family_models():
        runs = [("fused", OacServerConfig(rho=0.1), 3 if full else 2)]
        if cfg.name == "mamba2-370m":
            runs.append(("one_bit_ef", OacServerConfig(
                rho=0.1, one_bit=True, error_feedback=True, noise_std=0.5),
                2))
        shape = InputShape("custom", seq, LAUNCH_BATCH, "train")
        tokens = LAUNCH_BATCH * (seq + (cfg.encoder_seq
                                        if cfg.is_encdec else 0))

        def batch(t, cfg=cfg, seq=seq):
            return train.make_batch(cfg, 0, t, LAUNCH_BATCH, seq,
                                    LAUNCH_MICRO, dev)

        for name, oac, n_steps in runs:
            row, got, state = _train_run(
                dev, f"family {label} {name}", cfg, shape, oac, n_steps,
                batch, LAUNCH_MICRO, tokens,
                compare=not cfg.name.startswith("granite-moe"),
                syncs=full and name == "fused",
                profile=full and name == "fused")
            row.update(full_width=full, text_seq=seq,
                       frames=cfg.encoder_seq if cfg.is_encdec else 0)
            summary[f"{label} {name}"] = row
            for key in launches:
                launches[key] += got[key]
            del state
            torch.cuda.empty_cache()
    summary["seconds"] = time.time() - t_phase
    print(f"families phase: {summary['seconds']:.1f} s", flush=True)
    return launches, summary


def serve_models():
    """(label, config, prompt text tokens) of the serving phase, full
    width: ``internvl2-1b`` (256 patches in front), granite at 8 layers,
    ``mamba2-370m``, ``whisper-base`` (1,500 frames to the encoder), and
    ``mamba2-370m`` again in float32 compute (the teacher-forced check
    without bf16 rounding)."""
    import dataclasses
    from repro_torch.configs import get_config
    return [
        ("internvl2-1b", get_config("internvl2-1b"), 256),
        (f"granite-moe-3b-a800m[{GRANITE_LAYERS} layers]",
         dataclasses.replace(get_config("granite-moe-3b-a800m"),
                             n_layers=GRANITE_LAYERS), 512),
        ("mamba2-370m", get_config("mamba2-370m"), 512),
        ("whisper-base", get_config("whisper-base"), 64),
        ("mamba2-370m[float32]", dataclasses.replace(
            get_config("mamba2-370m"), compute_dtype="float32"), 512),
    ]


def _serve_prompt(cfg, text, dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab, (SERVE_BATCH, text),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.family == "vlm":
        batch["embeds"] = (0.02 * torch.randn(
            SERVE_BATCH, cfg.n_patches, cfg.d_model, generator=gen,
            device=dev)).to(cdt)
    if cfg.is_encdec:
        batch["frames"] = (0.02 * torch.randn(
            SERVE_BATCH, cfg.encoder_seq, cfg.d_model, generator=gen,
            device=dev)).to(cdt)
    return batch


def serve_phase(dev):
    """``make_prefill_step`` then ``make_serve_step`` at batch 4 with 32
    greedy tokens decoded on the device (argmax and the position stay on
    the card): finite logits, the caches' ``idx`` and ``pos`` as the
    prompt and the decoded tokens put them, 0 host syncs in a warm decode
    step, and except on MoE (``decode_mode`` routes the batch as one
    group with a capacity floor of 2, by the reference's design) each
    decoded token's logits and the prompt's last ones against a
    teacher-forced ``forward_train`` over prompt + decoded tokens within
    ``SERVE_REL_L2`` of the compute dtype.  Reports prefill ms, ms per
    decoded token, decoded tokens per second and the cache bytes.  No
    kernel of the table runs here: the counts must stay 0."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.configs import InputShape
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    t_phase = time.time()
    summary = {"batch": SERVE_BATCH, "decoded": SERVE_NEW}
    reset_counters()
    for label, cfg, text in serve_models():
        prompt = text + (cfg.n_patches if cfg.family == "vlm" else 0)
        cap = prompt + SERVE_NEW
        pre = steps.make_prefill_step(cfg, InputShape("prefill", prompt,
                                                      SERVE_BATCH,
                                                      "prefill"))
        serve = steps.make_serve_step(cfg, InputShape("decode", cap,
                                                      SERVE_BATCH, "decode"))
        check((serve.meta["capacity"], serve.meta["ring"]) == (cap, False),
              f"serve {label}: meta {serve.meta}")
        params = transformer.init_lm_seeded(cfg, 0, dev)
        batch = _serve_prompt(cfg, text, dev)
        # a warm-up prefill, then the timed one on fresh caches
        pre.fn(params, transformer.init_caches(cfg, SERVE_BATCH, cap,
                                               device=dev), batch)
        caches = transformer.init_caches(cfg, SERVE_BATCH, cap, device=dev)
        cache_bytes = sum(x.numel() * x.element_size()
                          for _, x in tree_util.leaves(caches))
        torch.cuda.synchronize()
        a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        logits, _ = pre.fn(params, caches, batch)
        e.record()
        first = logits[:, -1]
        pos = torch.full((), prompt, dtype=torch.int32, device=dev)
        toks, outs = [], []
        d0, d1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        d0.record()
        for _ in range(SERVE_NEW):
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok)
            logits, _ = serve.fn(params, caches, tok, pos)
            outs.append(logits)
            pos.add_(1)
        d1.record()
        torch.cuda.synchronize()
        prefill_ms = a.elapsed_time(e)
        decode_ms = d0.elapsed_time(d1) / SERVE_NEW
        check(all(bool(torch.isfinite(x).all()) for x in outs),
              f"serve {label}: a logit is not finite")
        for path, x in tree_util.leaves(caches):
            if path[-1] == "idx":
                check(bool((x == cap).all()),
                      f"serve {label}: cache idx {x.tolist()} != {cap}")
            if path[-1] == "pos":
                want = torch.arange(cap, dtype=torch.int32, device=dev)
                check(bool((x == want).all()),
                      f"serve {label}: cache positions differ")
        row = {"prompt": prompt, "capacity": cap, "prefill_ms": prefill_ms,
               "decode_ms_per_token": decode_ms,
               "decoded_tokens_per_s": SERVE_BATCH / (decode_ms / 1e3),
               "prefill_tokens_per_s": SERVE_BATCH * prompt
               / (prefill_ms / 1e3), "cache_bytes": cache_bytes}
        if not cfg.n_experts:
            full = torch.cat([batch["tokens"]] + toks, dim=1)
            with torch.no_grad():
                forced, _ = transformer.forward_train(
                    params, cfg, full, embeds=batch.get("embeds"),
                    frames=batch.get("frames"))
            got = torch.stack([first] + [x[:, 0] for x in outs], 1).float()
            want = forced[:, text - 1:text + SERVE_NEW].float()
            by_pos = ((got - want).norm(dim=-1)
                      / want.norm(dim=-1)).amax(0)
            rel = float(by_pos.max())
            bound = SERVE_REL_L2[cfg.compute_dtype]
            row["teacher_forced_rel_l2_by_position"] = by_pos.tolist()
            row["teacher_forced_max_abs_err"] = float(
                (got - want).abs().max())
            row["teacher_forced_max_rel_l2"] = rel
            row["logits_max_abs"] = float(want.abs().max())
            check(rel <= bound,
                  f"serve {label}: decoded logits off the teacher-forced "
                  f"ones by a relative L2 of {rel} (bound {bound}; max "
                  f"abs {row['teacher_forced_max_abs_err']}; by position "
                  f"{[round(x, 4) for x in by_pos.tolist()]})")
            del forced
        row["warm_syncs"] = _syncs(lambda: serve.fn(params, caches, tok,
                                                    pos))
        check(row["warm_syncs"] == 0,
              f"serve {label}: {row['warm_syncs']} host syncs in a warm "
              f"decode step")
        summary[label] = row
        print(f"serve {label}: prompt {prompt} at batch {SERVE_BATCH}, "
              f"prefill {prefill_ms:.1f} ms "
              f"({row['prefill_tokens_per_s']:.0f} tokens/s), decode "
              f"{decode_ms:.2f} ms per token "
              f"({row['decoded_tokens_per_s']:.0f} tokens/s over "
              f"{SERVE_NEW} greedy steps), caches "
              f"{cache_bytes / 1e6:.1f} MB, idx and pos as expected"
              + (f", teacher-forced max relative L2 "
                 f"{row['teacher_forced_max_rel_l2']:.5f} (first / last "
                 f"position {row['teacher_forced_rel_l2_by_position'][0]:.5f}"
                 f" / {row['teacher_forced_rel_l2_by_position'][-1]:.5f}; "
                 f"max |err| "
                 f"{row['teacher_forced_max_abs_err']:.4f} on logits up to "
                 f"{row['logits_max_abs']:.2f})"
                 if "teacher_forced_max_abs_err" in row
                 else ", MoE: no teacher-forced check")
              + f", {row['warm_syncs']} host syncs in a warm decode step",
              flush=True)
        del params, caches, outs, logits
        torch.cuda.empty_cache()
    got = read_counters()
    check(not any(got.values()), f"serve: a kernel was launched: {got}")
    summary["seconds"] = time.time() - t_phase
    print(f"serve phase: {summary['seconds']:.1f} s", flush=True)
    return summary


def main(argv) -> None:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch not found: run chip_smoke.py from the root of "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))           # benchmarks.torch_common
    # cuBLAS reproducible under deterministic algorithms (the launch
    # phase's --resume check): set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from repro_torch.device import resolve_device, set_numerics
    from repro_torch.kernels import build

    dev = resolve_device(None)
    set_numerics(dev)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {card} | torch: {kind} | devices: {count} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    build.build(force=True)
    print(f"build: {build.BUILD_INFO['seconds']:.2f} s -> "
          f"{build.BUILD_INFO['library']}", flush=True)
    for src, report in build.BUILD_INFO["ptxas"].items():
        lines = [ln for ln in report.splitlines() if "ptxas" in ln]
        print(f"ptxas {src}:\n  " + "\n  ".join(lines), flush=True)

    records, extras = kernel_phase(dev)
    if "--kernels" in argv:
        print("kernels only: the paths were not driven", flush=True)
        return
    task = make_task(dev)
    packed, exact = run_configs()
    by_path = {}
    by_path["packed"], summary = fl_path_phase(dev, task, packed, "packed")
    by_path["exact"], exact_summary = fl_path_phase(dev, task, exact,
                                                    "exact")
    summary.update(exact_summary)
    by_path["engine"], engine_summary = engine_phase(dev)
    by_path["two_stage_topk"] = topk_path_phase(dev)
    by_path["adaptive"], adaptive_summary = adaptive_phase(dev, task)
    by_path["figures"], figures_summary = figures_phase(dev)
    by_path["sweep"], sweep_summary = sweep_phase(dev)
    by_path["threshold"], threshold_summary = threshold_phase(dev, task)
    by_path["async"], async_summary = async_phase(dev, task)
    by_path["scan_rounds"], scan_summary = scan_phase(dev, task)
    by_path["scenario"], scenario_summary = scenario_phase(dev, task)
    by_path["tree"], tree_summary = tree_phase(dev)
    by_path["engine_1e8"], engine_big_summary = engine_big_phase(dev)
    by_path["launch"], launch_summary = launch_phase(dev, records)
    by_path["families"], families_summary = families_phase(dev)
    serve_summary = serve_phase(dev)
    launches = {key: sum(p[key] for p in by_path.values())
                for key in KERNELS}
    for key, n in launches.items():
        check(n > 0, f"kernel {key} was not launched on any path")
    parity_phase(dev, task)
    profile = profile_phase(dev, task, summary)
    check("jax" not in sys.modules, "JAX was imported")
    check(not any(m == "repro" or m.startswith("repro.")
                  for m in sys.modules), "the JAX package was imported")

    # each kernel's line reports the variant at the shape of its busiest
    # call site on the paths (aou_merge: the exact coherent round, the
    # path of every paper figure)
    main_variant = {"fairk_update": "fairk_update[stats]",
                    "sign_mv": f"sign_mv[fold {CHUNK}x{D}]",
                    "sign_from_energy": f"sign_from_energy[{D}+z+score]",
                    "aou_merge": f"aou_merge[trainer coherent {D} at "
                                 f"{K_EXACT}]",
                    "block_topk": f"block_topk[{BIG}/4096x164]"}
    sources = {
        "fairk_update": ("src/repro_torch/kernels/csrc/fairk_update.cu",
                         "src/repro/kernels/fairk_update.py:91"),
        "sign_mv": ("src/repro_torch/kernels/csrc/sign_mv.cu",
                    "src/repro/kernels/sign_mv.py:25"),
        "sign_from_energy": ("src/repro_torch/kernels/csrc/sign_mv.cu",
                             "src/repro/kernels/sign_mv.py:41"),
        "aou_merge": ("src/repro_torch/kernels/csrc/aou_merge.cu",
                      "src/repro/kernels/aou_merge.py:24"),
        "block_topk": ("src/repro_torch/kernels/csrc/block_topk.cu",
                       "src/repro/kernels/block_topk.py:31"),
    }
    kernels = []
    for name, variant in main_variant.items():
        rec = records[variant]
        same = [r["max_abs_err"] for v, r in records.items()
                if v.startswith(name + "[")]
        kernels.append({"name": name, "route": "cuda",
                        "source": sources[name][0],
                        "replaces": sources[name][1],
                        "launches": launches[name],
                        "max_abs_err": max(same), "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"],
                        "variant": variant,
                        "checked_variants": [v for v in records
                                             if v.startswith(name + "[")],
                        "launches_by_path": {p: c[name]
                                             for p, c in by_path.items()}})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kind": kind, "build": {
            k: v for k, v in build.BUILD_INFO.items() if k != "ptxas"},
         "variants": records, "extras": extras, "paths": summary,
         "engine": engine_summary, "adaptive": adaptive_summary,
         "figures": figures_summary, "sweep": sweep_summary,
         "threshold": threshold_summary, "async": async_summary,
         "scan_rounds": scan_summary, "scenario": scenario_summary,
         "tree": tree_summary,
         "engine_1e8": engine_big_summary, "launch": launch_summary,
         "families": families_summary, "serve": serve_summary,
         "launches_by_path": by_path, "profile": profile,
         "kernels": kernels},
        indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
