"""Population-scale simulator benchmark through the PyTorch port (the twin
of ``benchmarks/population_bench.py``).

* ``population/round`` — the launch path's packed server phase with a
  stateless population round (``population.stateless_round``: the
  availability draw, the participation rescale, churn-erase blocks
  through the sanitized fused launch) on persisted flat state, against
  the same round without the population (``sanitize``).  Its structural
  counters must stay at 1 pack, 1 unpack, 1 read of g and 1 fused launch.
* ``population/scan_<n>`` — the Gilbert–Elliott population scan
  (``population.population_scan``, a loop over rounds on the device) at
  10^5 virtual clients, and at 10^6 with ``--full``: client-rounds per
  second (host clock around a synchronised run).

Writes ``benchmarks/artifacts/torch_population_bench.json``.  ``--smoke``
asserts the structural counters on a tiny tree and runs a short 10^5 scan
on the CPU.

  PYTHONPATH=src python -m benchmarks.torch_population_bench [--full |
      --smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.torch_packed_bench import (FAST_TREE, FULL_TREE,  # noqa: E402
                                           _mk_engine, build_sanitize_fn,
                                           counted, make_transformer_tree,
                                           server_state, timed_med)
from repro_torch.core import faults, oac, packing, population  # noqa: E402
from repro_torch.device import DeviceLike, resolve_device  # noqa: E402

ROUND_POPULATION = population.PopulationConfig(
    n_clients=100_000, cohort_size=4096, participants=16, avail=0.9,
    mode="diurnal", period=96, depth=0.1)
SEED = 0x509


def build_population_round(tree, pcfg: population.PopulationConfig,
                           seed: int = SEED, kernel_mode=None):
    """The launch-path population round on persisted flat state: the
    stateless availability round ``t`` (a host int), the participation
    rescale ``g · (n_t / M)`` guarded by ``participation_scale``, and the
    churn-erase blocks (uniforms from a generator seeded ``(seed, 0x509,
    t)``) with the total-outage erase, through the sanitized launch."""
    layout = packing.PackedLayout.from_tree(tree)
    eng = _mk_engine("packed", layout, warm=True, fused_stats=True,
                     kernel_mode=kernel_mode)
    d = layout.d_packed
    nb = -(-d // pcfg.erase_block)

    def pop_round(g_tree, gp_flat, age_flat, tstate, t: int):
        dev = gp_flat.device
        ps = population.stateless_round(seed, t, pcfg, dev)
        g_flat = layout.pack(g_tree)           # the only pack per round
        g_flat = faults.participation_scale(
            g_flat * (ps["n_t"] * oac.reciprocal(pcfg.participants)),
            ps["n_t"])
        u = torch.rand(nb, generator=population.round_generator(
            seed, 0x509, t, dev), device=dev)
        erase = faults.erase_with_outage(
            population.churn_erase_mask(u, d, ps["churn"], pcfg), ps["n_t"])
        g_t, age_next, stats = eng.select_and_merge(
            g_flat, gp_flat, age_flat, tstate=tstate, erase=erase,
            sanitize=True)
        g_t_tree = layout.unpack(g_t, cast=False)
        return (g_t_tree, g_t.to(torch.bfloat16), age_next.to(torch.int8),
                stats["tstate"])

    return pop_round, layout


def bench_round(n_layers, d_model, vocab, repeats=5,
                device: DeviceLike = None):
    """Structural counters and median µs of the population round, and of
    the sanitize round it extends."""
    dev = resolve_device(device)
    tree = make_transformer_tree(n_layers, d_model, vocab, device=dev)
    g_prev, age = server_state(tree)
    pop_fn, layout = build_population_round(tree, ROUND_POPULATION)
    san_fn, _ = build_sanitize_fn(tree)
    gp_flat = layout.pack(g_prev).to(torch.bfloat16)
    age_flat = layout.pack_age(age).to(torch.int8)
    ts0 = packing.init_threshold_state(dev)
    _, cnt = counted(pop_fn, tree, gp_flat, age_flat, ts0, 0)
    res = {"d_valid": layout.d_valid, "d_packed": layout.d_packed,
           "population_n_clients": ROUND_POPULATION.n_clients,
           "counts_population": dict(zip(("fused_calls", "packs", "unpacks",
                                          "g_reads"), cnt))}
    res["population_us"], _ = timed_med(
        lambda: pop_fn(tree, gp_flat, age_flat, ts0, 1), repeats)
    res["sanitize_us"], _ = timed_med(
        lambda: san_fn(tree, gp_flat, age_flat, ts0), repeats)
    res["population_vs_sanitize"] = res["sanitize_us"] / res["population_us"]
    return res


def bench_scan(n_clients: int, rounds: int = 64, repeats: int = 3,
               device: DeviceLike = None):
    """Client-rounds per second of the Gilbert–Elliott population scan
    (median of ``repeats`` runs after a warm-up run)."""
    dev = resolve_device(device)
    cfg = population.PopulationConfig(
        n_clients=n_clients, cohort_size=min(n_clients, 4096),
        participants=16, avail=0.9, mode="ge", burst=8.0)

    def run_once():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state, traces = population.population_scan(cfg, rounds, gen, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return state, traces

    run_once()
    ts = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        _, traces = run_once()
        ts.append(time.perf_counter() - t0)
    sec = float(statistics.median(ts))
    return {"n_clients": n_clients, "rounds": rounds, "scan_s": sec,
            "client_rounds_per_s": n_clients * rounds / sec,
            "mean_n_avail": float(traces["n_avail"].mean())}


def run(fast: bool = True, device: DeviceLike = None, repeats: int = 5):
    """CSV rows ``(name, µs, derived)`` and the detail payload: the round on
    the fast tree (12, 192, 8192) or the ``--full`` tree (24, 320,
    32000), the scan at 10^5 (and 10^6 with ``fast=False``)."""
    res = bench_round(*(FAST_TREE if fast else FULL_TREE), repeats=repeats,
                      device=device)
    scans = [bench_scan(100_000, device=device)]
    if not fast:
        scans.append(bench_scan(1_000_000, device=device))
    res["scans"] = scans
    c = res["counts_population"]
    rows = [("torch_population/round", res["population_us"],
             f"vs_sanitize={res['population_vs_sanitize']:.2f}x "
             f"launches={c['fused_calls']} packs={c['packs']} "
             f"unpacks={c['unpacks']} reads={c['g_reads']}")]
    for sc in scans:
        rows.append((f"torch_population/scan_{sc['n_clients']}",
                     sc["scan_s"] * 1e6,
                     f"client_rounds_per_s={sc['client_rounds_per_s']:.6g}"))
    out_dir = os.path.join(os.path.dirname(__file__), "artifacts")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "torch_population_bench.json"),
              "w") as f:
        json.dump(res, f, indent=1)
    return rows, res


def smoke(device: DeviceLike = None) -> dict:
    """The population round on a tiny tree (2, 32, 256) keeps 1 pack, 1
    unpack, 1 read of g and 1 fused launch; the 10^5 scan runs 32 rounds
    with finite throughput."""
    res = bench_round(2, 32, 256, repeats=1, device=device)
    got = tuple(res["counts_population"][key] for key in
                ("fused_calls", "packs", "unpacks", "g_reads"))
    assert got == (1, 1, 1, 1), res
    scan = bench_scan(100_000, rounds=32, repeats=1, device=device)
    assert np.isfinite(scan["client_rounds_per_s"]), scan
    res["scans"] = [scan]
    print(json.dumps(res, indent=1))
    print(f"[torch_population_bench --smoke] OK: population round = "
          f"{got} (launches, packs, unpacks, reads of g); 10^5-client scan "
          f"at {scan['client_rounds_per_s']:.3g} client-rounds/s")
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
    rows, _ = run(fast=not args.full, device=args.device)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
