"""Lemma 1 walkthrough through the PyTorch port (the twin of
``examples/aou_analysis.py``): build the FAIR-k Markov chain, solve the
steady state, plot (ASCII) the AoU distribution against simulation, and
show how E[tau] — the staleness term in Theorem 1's residual error — moves
with the magnitude/freshness split k_M/k.

``repro_torch.core.markov`` is the port's numpy copy of the reference's
chain, so the printed table equals the reference example's number for
number; nothing runs on a device (``--device`` is accepted for the
examples' common interface and unused).

  PYTHONPATH=src python examples/torch_aou_analysis.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import markov  # noqa: E402


def ascii_plot(support, series, width=60, height=12):
    top = max(max(s) for _, s in series)
    for name, s in series:
        print(f"  {name}:")
        for i in range(0, len(support), max(1, len(support) // height)):
            bar = "#" * int(s[i] / top * width)
            print(f"    tau={support[i]:3d} | {bar} {s[i]:.4f}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="unused: the chain is numpy")
    ap.parse_args(argv)
    chain = markov.FairKChain(d=800, k=80, k_m=60, k0=15)   # Fig. 3 params
    support, pmf = markov.aou_distribution(chain)
    emp = markov.simulate_aou(chain, rounds=4000, seed=0, mode="exchange")
    e_tau = float((support * pmf).sum())
    tv = 0.5 * np.abs(pmf - emp).sum()
    print(f"FAIR-k chain d={chain.d} k={chain.k} k_m={chain.k_m} "
          f"k0={chain.k0}: T={chain.max_staleness}, "
          f"E[tau]={e_tau:.2f}, TV(analysis, sim)={tv:.4f}\n")
    ascii_plot(support, [("Lemma 1 analysis", pmf),
                         ("simulation (exchange model)", emp)])

    print("\nE[tau] vs magnitude share k_M/k (Theorem 1 staleness term):")
    sweep = {}
    for km_frac in (0.25, 0.5, 0.75, 0.9):
        km = int(80 * km_frac)
        sweep[km_frac] = markov.expected_staleness(
            markov.FairKChain(d=800, k=80, k_m=km, k0=max(2, km // 4)))
        print(f"  k_M/k={km_frac:.2f}: E[tau] = {sweep[km_frac]:6.2f}")
    print("  k_M/k=1.00: E[tau] unbounded (pure Top-k starves entries)")
    return {"support": support, "pmf": pmf, "emp": emp, "e_tau": e_tau,
            "tv": tv, "e_tau_by_km": sweep}


if __name__ == "__main__":
    main()
