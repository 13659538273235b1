"""Each cell's path run end to end on the CPU at a tiny size, in float32,
against the reference: the readings agree and ``correct`` is true; the
result line has the contract's keys."""

import json

import pytest
import torch

from bench import run
from tiny import tiny_root

CELLS = ("internvl2-1b.train", "mamba2-370m.train", "internvl2-1b.update")


def cpu_run(root, cell, trace=0, seed=2**31 + 11):
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                      "0.5", "--trace", str(trace)])
    return run.run(args, root=root, device=torch.device("cpu"))


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_agrees_with_the_reference(tmp_path, cell):
    result, lines = cpu_run(tiny_root(tmp_path), cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    for check in result["checks"].values():
        # float32 on both sides: far inside the limits set for bf16
        assert check["value"] <= check["limit"] / 10
    assert [ln.split(":")[0] for ln in lines[-len(result["checks"]):]] \
        == [f"check {k}" for k in result["checks"]]


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema(tmp_path, trace):
    root = tiny_root(tmp_path)
    result, _ = cpu_run(root, "internvl2-1b.update", trace=trace)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    json.loads(json.dumps(result))
    dev = result["device"]
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    units = {m["name"]: m["unit"] for m in
             manifest["end_to_end"] + manifest["per_layer"]}
    for name, m in result["metrics"].items():
        # a collection's idle reads 0 in a window without one
        assert m["unit"] == units[name] and (
            m["value"] > 0 or name == "gc_idle_ms" and m["value"] == 0)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(result["metrics"]) <= {
            m["name"] for m in manifest["per_layer"]
            if "internvl2-1b.update" in m["workloads"]}
    else:
        # the p95 needs twenty rounds in the window
        expect = {"round_ms", "setup_s"} | (
            {"round_ms.p95"} if result["attempted"] >= 20 else set())
        assert set(result["metrics"]) == expect
    for check in result["checks"].values():
        assert list(check) == ["value", "limit"]


def test_the_command_refuses_without_a_card(tmp_path):
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run([sys.executable, str(run.ROOT / "bench" / "run.py"),
                          "--workload", "internvl2-1b.update", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout.strip() == ""
