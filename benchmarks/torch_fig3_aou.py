"""Fig. 3 — AoU distribution: Lemma 1 analysis vs simulation, through the
port's copy of the Markov analysis (``repro_torch.core.markov``, numpy
only; the twin of ``benchmarks/fig3_aou.py``).

Paper parameters: k=80, rho=0.1 (d=800), k_M/k=0.75, k_0/k_M=0.25."""

import time

import numpy as np

from repro_torch.core import markov


def run(fast: bool = True, device=None, rounds=None):
    """``rounds`` cuts the simulated rounds (2,000 fast, 10,000 full);
    ``device`` is accepted for the registry and unused (numpy only)."""
    chain = markov.FairKChain(d=800, k=80, k_m=60, k0=15)
    t0 = time.perf_counter()
    support, pmf = markov.aou_distribution(chain)
    analysis_us = (time.perf_counter() - t0) * 1e6
    if rounds is None:
        rounds = 2000 if fast else 10000
    emp_ex = markov.simulate_aou(chain, rounds=rounds, seed=0, mode="exchange")
    emp_ar = markov.simulate_aou(chain, rounds=rounds, seed=0, mode="ar")
    tv_ex = 0.5 * np.abs(pmf - emp_ex).sum()
    tv_ar = 0.5 * np.abs(pmf - emp_ar).sum()
    e_tau = float((support * pmf).sum())
    rows = [
        ("fig3/aou_analysis", analysis_us,
         f"E[tau]={e_tau:.2f};T={chain.max_staleness}"),
        ("fig3/tv_vs_exchange_sim", analysis_us, f"TV={tv_ex:.4f}"),
        ("fig3/tv_vs_ar_sim", analysis_us, f"TV={tv_ar:.4f}"),
    ]
    detail = {"support": support.tolist(), "pmf": pmf.tolist(),
              "empirical_exchange": emp_ex.tolist(),
              "empirical_ar": emp_ar.tolist(), "E_tau": e_tau,
              "tv_exchange": float(tv_ex), "tv_ar": float(tv_ar)}
    return rows, detail
