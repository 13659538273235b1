"""``tools/torch_check_bench_regression.py``: the structural part passes
the artifacts of real ``torch_client_bench`` and ``torch_packed_bench``
smoke runs, and fails each broken counter and each missing one; the
ratio part fails without a baseline, passes a run within the tolerance
and fails a regressed ratio."""

import copy
import importlib.util
import json
import os

import pytest

from benchmarks import torch_client_bench, torch_packed_bench

ROOT = os.path.join(os.path.dirname(__file__), "..")
_spec = importlib.util.spec_from_file_location(
    "torch_check_bench_regression",
    os.path.join(ROOT, "tools", "torch_check_bench_regression.py"))
gate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gate)


@pytest.fixture(scope="module")
def artifacts():
    """The two smoke runs' counters, as the smoke entry points write
    them."""
    client = torch_client_bench.measure(64, 32, (8,), throughput=False,
                                        device="cpu")
    torch_client_bench.check(client, (8,))
    packed = torch_packed_bench.bench_tree(2, 32, 256, repeats=1,
                                           device="cpu")
    packed.update(torch_packed_bench.gate_counters(packed))
    return client, packed


def _write(tmp_path, client, packed):
    cp, pp = tmp_path / "client.json", tmp_path / "packed.json"
    cp.write_text(json.dumps(client))
    pp.write_text(json.dumps(packed))
    return ["--client-artifact", str(cp), "--packed-artifact", str(pp)]


def test_gate_passes_good_smoke_artifacts(artifacts, tmp_path, capsys):
    args = _write(tmp_path, *artifacts)
    assert gate.main(args + ["--structural-only"]) == 0
    out = capsys.readouterr().out
    assert "22 structural counters intact" in out
    assert "ratio part skipped" in out


BROKEN = ([("clients", k) for k in gate.STRUCTURAL_CLIENTS]
          + [("packed", k) for k in gate.STRUCTURAL_PACKED])


@pytest.mark.parametrize("which,key", BROKEN)
def test_gate_fails_a_broken_counter(artifacts, tmp_path, capsys, which,
                                     key):
    client, packed = copy.deepcopy(artifacts)
    art = client if which == "clients" else packed
    art[key] = [2, 1] if isinstance(art[key], list) else art[key] + 1
    assert gate.main(_write(tmp_path, client, packed)
                     + ["--structural-only"]) == 1
    assert f"STRUCTURAL ({which}) {key}" in capsys.readouterr().out


@pytest.mark.parametrize("which", ["clients", "packed"])
def test_gate_fails_a_missing_counter(artifacts, tmp_path, capsys, which):
    client, packed = copy.deepcopy(artifacts)
    if which == "clients":
        del client["client_nd_live"]
    else:
        del packed["g_reads_fused_stats"]
    assert gate.main(_write(tmp_path, client, packed)
                     + ["--structural-only"]) == 1
    assert "got None" in capsys.readouterr().out


def test_gate_fails_a_missing_artifact(artifacts, tmp_path, capsys):
    args = _write(tmp_path, *artifacts)
    args[1] = str(tmp_path / "nothing.json")
    assert gate.main(args + ["--structural-only"]) == 1
    assert "no artifact" in capsys.readouterr().out


def test_ratio_part_fails_without_a_baseline(artifacts, tmp_path, capsys):
    args = _write(tmp_path, *artifacts)
    assert gate.main(args + ["--baseline", str(tmp_path / "none.json"),
                             "--full-artifact",
                             str(tmp_path / "none.json")]) == 1
    assert "no baseline" in capsys.readouterr().out


@pytest.mark.parametrize("factor,rc", [(1.0, 0), (0.9, 0), (0.8, 1)])
def test_ratio_part_against_a_baseline(artifacts, tmp_path, capsys, factor,
                                       rc):
    base = {"card": "a card, 700.00 W", "clients_per_s_8_vs_512": 0.5,
            "peak_dense_vs_8": 8.0}
    full = {k: v * factor for k, v in base.items() if k != "card"}
    (tmp_path / "base.json").write_text(json.dumps(base))
    (tmp_path / "full.json").write_text(json.dumps(full))
    args = _write(tmp_path, *artifacts) + [
        "--baseline", str(tmp_path / "base.json"),
        "--full-artifact", str(tmp_path / "full.json")]
    assert gate.main(args) == rc
    out = capsys.readouterr().out
    assert ("REGRESSED" in out) == (rc == 1)


def _run(rate_ratio, peak_ratio=46.3):
    return {"n_clients": 512, "d": 2048, **gate.STRUCTURAL_CLIENTS,
            "clients_per_s": {"8": rate_ratio, "512": 1.0},
            "peak_client_bytes": {"8": 1, "dense": peak_ratio},
            "clients_per_s_8_vs_512": rate_ratio,
            "peak_dense_vs_8": peak_ratio}


def test_baseline_is_the_median_of_the_runs_with_a_tolerance_above_spread():
    base = gate.make_baseline([_run(0.020), _run(0.024), _run(0.021)],
                              "a card, 700.00 W")
    assert base["clients_per_s_8_vs_512"] == 0.021
    assert base["peak_dense_vs_8"] == 46.3
    assert base["spread"]["clients_per_s_8_vs_512"] == pytest.approx(3 / 21)
    assert base["spread"]["peak_dense_vs_8"] == 0.0
    # twice the largest spread (0.286), rounded up to 5 points
    assert base["tol"] == pytest.approx(0.30)
    assert base["n_runs"] == 3 and len(base["runs"]) == 3
    quiet = gate.make_baseline([_run(0.021)] * 3, "a card, 700.00 W")
    assert quiet["tol"] == gate.MIN_TOL


def test_baseline_needs_three_agreeing_runs():
    with pytest.raises(ValueError, match="at least 3"):
        gate.make_baseline([_run(0.02)] * 2, "a card, 700.00 W")
    bad = dict(_run(0.02), client_nd_live=1)
    with pytest.raises(ValueError, match="client_nd_live"):
        gate.make_baseline([_run(0.02), _run(0.02), bad], "a card, 700.00 W")


def test_make_baseline_writes_a_baseline_the_ratio_part_reads(
        artifacts, tmp_path, capsys):
    paths = []
    for i, r in enumerate((0.020, 0.024, 0.021)):
        paths.append(str(tmp_path / f"run{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(_run(r), f)
    base = str(tmp_path / "base.json")
    assert gate.main(["--baseline", base, "--card", "a card, 700.00 W",
                      "--make-baseline"] + paths) == 0
    args = _write(tmp_path, *artifacts) + ["--baseline", base]
    # 0.015 is 29% under the median 0.021: inside the baseline's 30%
    (tmp_path / "full.json").write_text(json.dumps(_run(0.015)))
    assert gate.main(args + ["--full-artifact",
                             str(tmp_path / "full.json")]) == 0
    (tmp_path / "full.json").write_text(json.dumps(_run(0.014)))
    assert gate.main(args + ["--full-artifact",
                             str(tmp_path / "full.json")]) == 1
    assert "REGRESSED" in capsys.readouterr().out


def test_committed_baseline_holds_the_guarded_ratios_and_the_card():
    with open(gate.BASELINE) as f:
        base = json.load(f)
    assert base["n_runs"] == len(base["runs"]) >= gate.MIN_BASELINE_RUNS
    for key in gate.GUARDED_RATIOS:
        assert base[key] > 0
        values = sorted(run[key] for run in base["runs"])
        assert base[key] == values[len(values) // 2]
        assert base["tol"] >= 2 * base["spread"][key]
    assert base["tol"] >= gate.MIN_TOL
    assert "H100" in base["card"] and " W" in base["card"]
    for key in gate.STRUCTURAL_CLIENTS:
        assert base[key] == gate.STRUCTURAL_CLIENTS[key]
