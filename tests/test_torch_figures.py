"""The paper's figures and Table I through the port
(``benchmarks/torch_*.py``) on the CPU, their depth cut to 2 rounds (Table
I: 2 perturbation pairs per level): each returns rows in the format of
``benchmarks/common.csv_row`` — the same names as its JAX twin, a time and
``key=value`` fields with finite numbers.  Fig. 3 is numpy on both sides:
its derived strings and detail equal the JAX script's exactly.  The
registry ``benchmarks/torch_run.py`` runs from the command line."""

import math
import os
import subprocess
import sys

import pytest
import torch

from benchmarks import (fig3_aou, torch_fig3_aou, torch_fig4_convergence,
                        torch_fig5_staleness, torch_fig6_km_ratio,
                        torch_fig7_local_epochs, torch_fig9_prototype,
                        torch_run, torch_table1_lipschitz)
from benchmarks.torch_common import csv_row, timed

ROOT = os.path.join(os.path.dirname(__file__), "..")

SCRIPTS = {
    "fig3": (torch_fig3_aou, ["fig3/aou_analysis", "fig3/tv_vs_exchange_sim",
                              "fig3/tv_vs_ar_sim"]),
    "fig4": (torch_fig4_convergence,
             [f"fig4/{task}/{p}" for task in ("classification", "powerlaw")
              for p in ("fairk", "topk", "agetopk", "toprand",
                        "roundrobin")]),
    "fig5": (torch_fig5_staleness,
             [f"fig5/{p}" for p in ("fairk", "topk", "agetopk", "toprand",
                                    "roundrobin")]),
    "fig6": (torch_fig6_km_ratio,
             [f"fig6/km_ratio_{f:.2f}" for f in (0.0, 0.25, 0.5, 0.75, 1.0)]
             + ["fig6/km_adaptive"]),
    "fig7": (torch_fig7_local_epochs,
             [f"fig7/H{h}/{p}" for h in (1, 5, 10) for p in ("fairk",
                                                             "topk")]),
    "fig9": (torch_fig9_prototype,
             [f"fig9/onebit/{p}" for p in ("fairk", "topk", "toprand")]),
    "table1": (torch_table1_lipschitz,
               [f"table1/dir_{a}" for a in (0.1, 0.3, 1.0)]),
}


def _fields(derived):
    out = {}
    for part in derived.split(";"):
        key, value = part.split("=")
        out[key] = float(value)
    return out


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script_runs_and_writes_csv_rows(name):
    torch.manual_seed(0)
    mod, names = SCRIPTS[name]
    rows, detail = mod.run(fast=True, device="cpu", rounds=2)
    assert [r[0] for r in rows] == names
    assert isinstance(detail, dict) and detail
    for row in rows:
        line = csv_row(*row)
        head, us, derived = line.split(",", 2)
        assert head == row[0] and math.isfinite(float(us))
        fields = _fields(derived)
        assert fields and all(math.isfinite(v) for v in fields.values())


def test_fig3_equals_the_jax_script():
    t_rows, t_detail = torch_fig3_aou.run(fast=True, device="cpu")
    j_rows, j_detail = fig3_aou.run(fast=True)
    assert [(r[0], r[2]) for r in t_rows] == [(r[0], r[2]) for r in j_rows]
    assert t_detail == j_detail


def test_registry_lists_the_seven_entries():
    # the seven figure and table entries, then the server-phase and
    # population benchmarks
    assert list(torch_run.MODULES) == ["fig3", "fig4", "fig5", "fig6",
                                       "fig7", "table1", "fig9", "engine",
                                       "packed", "population"]


def test_runner_runs_fig3_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "benchmarks.torch_run",
                          "--only", "fig3", "--device", "cpu"], cwd=ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines[1].startswith("fig3/aou_analysis,")
    bad = subprocess.run([sys.executable, "-m", "benchmarks.torch_run",
                          "--only", "fig8", "--device", "cpu"], cwd=ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert bad.returncode != 0 and "unknown benchmark" in bad.stderr


def test_timed_returns_microseconds_and_the_result():
    calls = []
    us, out = timed(lambda x: calls.append(x) or x + 1, 2, repeats=3)
    assert out == 3 and len(calls) == 4 and us > 0.0
