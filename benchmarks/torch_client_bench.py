"""Streaming client-aggregation benchmark through the PyTorch port (the twin
of ``benchmarks/client_bench.py``): live client-buffer bytes and clients
per second.

* **structural / memory** — the port's client phase streams the N clients
  through ``clients_fold`` in chunks of ``client_chunk = C``: with C < N one
  round makes NO (N, d) float32 tensor, the largest (rows, d) float32
  tensor any operation produces is O(C · d), one round runs exactly ONE
  streaming fold (``trainer.CLIENT_STREAM_PASSES``), and the packed server
  phase reads the gradient buffer once (``packing.G_READS``).  A
  ``TorchDispatchMode`` records every tensor the operations of one round
  produce — ``torch.func.vmap``'s batched results at their physical
  (chunk, d) shape — so the counters hold on the CPU and on the card
  alike, as the reference's jaxpr walk does.
* **throughput** (on the card) — clients per second of the round, CUDA
  events around 8 rounds, the median of 3 repeats, per chunk size; and
  ``peak_client_bytes``, ``torch.cuda.max_memory_allocated`` over one
  round above what was allocated before it (the client chunk's buffers
  are the round's largest).  The port runs the chunks as a Python loop
  (the reference: one ``lax.scan``), so on the card these rates measure
  the host's dispatch.

The problem is the reference's: a linear regression with weight (8, m),
d = 8 m gradient coordinates and 8 + m floats per sample, so at N = 512,
d = 2,048 the (N, d) buffer of the dense fold dominates every other
tensor.

Writes ``benchmarks/artifacts/torch_client_bench.json`` (``--smoke``:
``torch_client_bench_smoke.json``, N = 64, m = 32, C = 8, structural
counters only); ``tools/torch_check_bench_regression.py`` gates them.

  PYTHONPATH=src python -m benchmarks.torch_client_bench [--smoke]
      [--device cpu]      # the card unless --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from repro_torch.core import oac, packing  # noqa: E402
from repro_torch.device import DeviceLike, resolve_device  # noqa: E402
from repro_torch.fl import trainer as fl_trainer  # noqa: E402
from repro_torch.fl.trainer import FLConfig  # noqa: E402

_CH = oac.ChannelConfig(fading="rayleigh", mean=1.0, noise_std=0.1)


def make_problem(n_clients: int, m: int, h: int = 1, b: int = 2,
                 seed: int = 0, device: DeviceLike = None):
    """Linear regression with weight (8, m): d = 8 m gradient coordinates
    per client, 8 + m floats per sample (the reference's numpy draws)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params0 = {"w": rng.normal(size=(8, m)).astype("f4")}
    xs = torch.as_tensor(rng.normal(size=(n_clients, h, b, 8)).astype("f4"),
                         device=dev)
    ys = torch.as_tensor(rng.normal(size=(n_clients, h, b, m)).astype("f4"),
                         device=dev)

    def loss_fn(p, x, y):
        return 0.5 * torch.mean((x @ p["w"] - y) ** 2)

    return params0, loss_fn, xs, ys


def _fl(n_clients: int, chunk, backend: str = "exact") -> FLConfig:
    return FLConfig(n_clients=n_clients, local_steps=1, batch_size=2,
                    local_lr=0.05, global_lr=0.05, rounds=1,
                    compression_ratio=0.1, channel=_CH, backend=backend,
                    client_chunk=chunk, seed=0)


def _build(fl: FLConfig, m: int, device: DeviceLike):
    """(round thunk, d): one round of ``make_fl_step`` on the problem's
    initial state, with one round of draws from ``fl.seed``."""
    dev = resolve_device(device)
    params0, loss_fn, xs, ys = make_problem(fl.n_clients, m, device=dev)
    state, unravel = fl_trainer.init_server(params0, fl, dev)
    d = state.w.shape[0]
    step = fl_trainer.make_fl_step(fl, unravel, loss_fn, d, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(fl.seed)
    draws = fl_trainer.draw_round(gen, fl, d, dev)

    def one_round():
        return step(state.w, state.g, state.age, state.sel_count, xs, ys,
                    state.residual, state.theta, draws, state.ctrl)

    return one_round, d


class _Shapes(TorchDispatchMode):
    """Records the shape and dtype of every tensor an operation produces."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.seen.append((tuple(t.shape), t.dtype))
        return out


def trace_metrics(fl: FLConfig, m: int, device: DeviceLike = None) -> dict:
    """One round under the dispatch mode: (max (rows, d) float32 bytes,
    count of (N, d) float32 tensors, stream passes, reads of g)."""
    one_round, d = _build(fl, m, device)
    passes0, reads0 = fl_trainer.CLIENT_STREAM_PASSES, packing.G_READS
    with _Shapes() as rec:
        one_round()
    passes = fl_trainer.CLIENT_STREAM_PASSES - passes0
    reads = packing.G_READS - reads0
    mats = [s for s, dt in rec.seen
            if len(s) == 2 and s[1] == d and dt == torch.float32]
    max_bytes = max((int(s[0]) * d * 4 for s in mats), default=0)
    nd_live = sum(1 for s in mats if s[0] == fl.n_clients)
    return {"d": d, "max_live_matrix_bytes": max_bytes,
            "nd_live": nd_live, "stream_passes": passes, "g_reads": reads}


def bench_card(fl: FLConfig, m: int, device: DeviceLike = None,
               rounds: int = 8, repeats: int = 3) -> dict:
    """On the card: clients per second (CUDA events around ``rounds``
    rounds, the median of ``repeats``) and the peak allocated bytes of one
    round above what was allocated before it."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("bench_card times the card: pass a CUDA device")
    one_round, _ = _build(fl, m, dev)
    one_round()                                  # warm-up
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    one_round()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    ms = []
    for _ in range(max(repeats, 3)):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(rounds):
            one_round()
        b.record()
        torch.cuda.synchronize(dev)
        ms.append(a.elapsed_time(b))
    sec = statistics.median(ms) / 1e3
    return {"clients_per_s": fl.n_clients * rounds / sec,
            "peak_client_bytes": int(peak), "round_ms": sec * 1e3 / rounds}


def measure(n_clients: int, m: int, chunks, throughput: bool = True,
            device: DeviceLike = None) -> dict:
    """The reference's ``run``: its rows and fields (``throughput`` adds
    the card's clients per second and peak bytes per chunk)."""
    dev = resolve_device(device)
    d = 8 * m
    res = {"n_clients": n_clients, "d": d, "chunks": list(chunks),
           "device": str(dev), "live_bytes": {}, "clients_per_s": {},
           "peak_client_bytes": {}, "round_ms": {}}
    for c in chunks:
        tm = trace_metrics(_fl(n_clients, c), m, dev)
        res["live_bytes"][str(c)] = tm["max_live_matrix_bytes"]
        if c == chunks[0]:                       # smallest chunk
            res["client_nd_live"] = tm["nd_live"]
            res["client_stream_passes"] = tm["stream_passes"]
        if throughput:
            row = bench_card(_fl(n_clients, c), m, dev)
            for key in ("clients_per_s", "peak_client_bytes", "round_ms"):
                res[key][str(c)] = row[key]
    dense = trace_metrics(_fl(n_clients, None), m, dev)
    res["live_bytes"]["dense"] = dense["max_live_matrix_bytes"]
    if throughput:
        res["peak_client_bytes"]["dense"] = bench_card(
            _fl(n_clients, None), m, dev)["peak_client_bytes"]
    # the headline: the chunked round's largest client matrix scales with
    # C, not N (the dense fold pays the full (N, d) buffer)
    res["live_scaling"] = (res["live_bytes"][str(chunks[0])]
                           / max(res["live_bytes"]["dense"], 1))
    if throughput:
        # same-card ratios, guarded by tools/torch_check_bench_regression.py
        c0, c1 = str(chunks[0]), str(chunks[-1])
        res[f"clients_per_s_{c0}_vs_{c1}"] = (res["clients_per_s"][c0]
                                              / res["clients_per_s"][c1])
        res[f"peak_dense_vs_{c0}"] = (res["peak_client_bytes"]["dense"]
                                      / max(res["peak_client_bytes"][c0], 1))
    packed = trace_metrics(_fl(n_clients, chunks[0], backend="packed"), m,
                           dev)
    res["g_reads_fl_packed"] = packed["g_reads"]
    return res


def check(res: dict, chunks) -> None:
    """The reference's asserts, unchanged."""
    n = res["n_clients"]
    assert res["client_stream_passes"] == 1, res
    assert res["client_nd_live"] == 0, res
    assert res["g_reads_fl_packed"] == 1, res
    c0 = chunks[0]
    # O(C * d), with the reference's one-chunk slack
    assert res["live_bytes"][str(c0)] <= 2 * c0 * res["d"] * 4, res
    assert res["live_bytes"]["dense"] >= n * res["d"] * 4, res
    assert res["live_scaling"] <= 2 * c0 / n + 1e-9, res


def _write(res: dict, name: str) -> str:
    out_dir = os.path.join(os.path.dirname(__file__), "artifacts")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return path


def smoke(device: DeviceLike = None) -> dict:
    """The structural gate: one streaming fold per round, no (N, d)
    gradient tensor with C < N, one read of g on the packed round, and the
    largest client matrix O(C · d).  No wall-clock assertion."""
    chunks = (8,)
    res = measure(n_clients=64, m=32, chunks=chunks, throughput=False,
                  device=device)
    check(res, chunks)
    _write(res, "torch_client_bench_smoke.json")
    print(json.dumps(res, indent=1))
    print(f"[torch_client_bench --smoke] OK: "
          f"{res['client_stream_passes']} stream pass, "
          f"{res['client_nd_live']} live (N, d) buffers, g_reads(packed)="
          f"{res['g_reads_fl_packed']}, live bytes C=8: "
          f"{res['live_bytes']['8']} vs dense {res['live_bytes']['dense']}")
    return res


def full(device: DeviceLike = None) -> dict:
    """N = 512, m = 256 (d = 2,048), chunks 8 / 64 / 512 and the dense
    fold, with the card's clients per second and peak bytes."""
    dev = resolve_device(device)
    chunks = (8, 64, 512)
    res = measure(n_clients=512, m=256, chunks=chunks,
                  throughput=dev.type == "cuda", device=dev)
    check(res, chunks)
    _write(res, "torch_client_bench.json")
    for c in chunks:
        rate = res["clients_per_s"].get(str(c))
        print(f"client/chunk_{c},{res['live_bytes'][str(c)]},"
              + (f"clients_per_s={rate:.6g}" if rate is not None
                 else "clients_per_s=not measured (CPU)"))
    print(json.dumps(res, indent=1))
    return res


def run(fast: bool = True, device: DeviceLike = None):
    """``torch_run.py`` rows: per chunk, µs per round (on the card; NaN on
    the CPU) and the live bytes; the smoke size when ``fast``."""
    dev = resolve_device(device)
    n, m, chunks = (64, 32, (8,)) if fast else (512, 256, (8, 64, 512))
    t0 = time.perf_counter()
    res = measure(n, m, chunks, throughput=dev.type == "cuda", device=dev)
    check(res, chunks)
    rows = []
    for c in chunks:
        ms = res["round_ms"].get(str(c))
        rows.append((f"client/chunk_{c}",
                     ms * 1e3 if ms is not None else float("nan"),
                     f"live_bytes={res['live_bytes'][str(c)]};"
                     f"nd_live={res['client_nd_live']};"
                     f"clients_per_s={res['clients_per_s'].get(str(c))}"))
    res["seconds"] = time.perf_counter() - t0
    return rows, res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(args.device)
    return full(args.device)


if __name__ == "__main__":
    main()
