"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files (and new manifest entries) in a copy of the checkout are run
by the harness, with no existing file of the harness edited: a metric
that reads the port's spans, and a configuration of a family that the
yardstick does not count, too."""

import json
import sys
import types

import pytest
import torch

from bench import run
from tiny import tiny_root

METRIC = '''"""Rounds the window completed (a test metric)."""


def read(ctx):
    return float(ctx["rounds"])
'''


def test_new_files_make_a_new_cell(tmp_path):
    root = tiny_root(tmp_path)
    bench = root / "bench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    config = json.loads((bench / "configs" / "internvl2-1b.json").read_text())
    config["name"] = "tiny-dense"
    config["model"].update(name="tiny-dense", family="dense", n_patches=0,
                           qkv_bias=False, tie_embeddings=True)
    (bench / "configs" / "tiny-dense.json").write_text(json.dumps(config))
    (bench / "traffic" / "train_b2_s16.json").write_text(json.dumps(
        {"kind": "train", "batch": 2, "seq_len": 16, "n_micro": 2,
         "lr": 0.001, "oac": {"rho": 0.2}}))
    (bench / "workloads" / "tiny-dense.train.json").write_text(json.dumps(
        {"limits": {"grad1": 0.01, "change3": 0.01}}))
    (bench / "metrics" / "rounds_done.py").write_text(METRIC)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-dense", "source": "test",
                                "file": "bench/configs/tiny-dense.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "tiny-dense.train",
                                  "config": "tiny-dense",
                                  "traffic": "train_b2_s16", "chips": 1,
                                  "why": "test"})
    manifest["per_layer"].append({"name": "rounds_done", "unit": "rounds",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "train step", "moves": "round_ms",
                                  "workloads": ["tiny-dense.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    for trace in (0, 1):
        args = run.parse(["--workload", "tiny-dense.train", "--seed", "7",
                          "--seconds", "0.3", "--trace", str(trace)])
        result, _ = run.run(args, root=root, device=torch.device("cpu"))
        assert result["correct"], result["checks"]
        if trace:
            assert result["metrics"]["rounds_done"]["value"] == \
                result["attempted"]
        else:
            assert set(result["metrics"]) == {"round_ms", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())


SPAN_METRIC = '''"""Calls of the optimizer's span in the traced window (a test
metric)."""


def read(ctx):
    red = (ctx["trace"] or {}).get("spans")
    if not red:
        return None
    return float(red["spans"]["repro_torch.optim.apply"]["calls"])
'''


def test_a_new_metric_file_reads_the_spans(tmp_path, monkeypatch):
    from bench.harness import trace
    root = tiny_root(tmp_path)
    bench = root / "bench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "metrics" / "optim_calls.py").write_text(SPAN_METRIC)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({"name": "optim_calls", "unit": "calls",
                                  "better": "lower",
                                  "source": "device_trace",
                                  "layer": "server phase",
                                  "moves": "round_ms",
                                  "workloads": ["internvl2-1b.update"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    # the CPU's session holds no device operations, so the summary is
    # made up: the window's device time and one span of the program
    stat = {"own_s": 0.5, "incl_s": 0.5, "launches": 6, "incl_launches": 6,
            "calls": 3, "host_s": 0.6, "idle_s": 0.0, "wait_s": 0.0}
    summary = {"window_s": 1.0, "busy_s": 0.9,
               "device_ops": [["adam", 0.5]], "idle_gaps": [["host", 0.1]],
               "kernels": {"adam": (0.5, 6)},
               "spans": {"spans": {"repro_torch.optim.apply": stat},
                         "idle_by_label": {}, "launches": 6}}
    monkeypatch.setattr(trace, "summarize", lambda prof: summary)
    args = run.parse(["--workload", "internvl2-1b.update", "--seed", "5",
                      "--seconds", "0.3", "--trace", "1"])
    result, _ = run.run(args, root=root, device=torch.device("cpu"))
    assert result["correct"], result["checks"]
    got = {k: m["value"] for k, m in result["metrics"].items()}
    assert got["optim_calls"] == 3.0
    n = result["attempted"]
    assert got["optim_ms"] == 1e3 * 0.5 / n
    # no collection ran; no step span ran, so no launches are counted
    assert got["gc_idle_ms"] == 0.0 and "launches_per_round" not in got
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("hook", [False, True])
def test_a_configuration_of_an_uncounted_family(tmp_path, monkeypatch,
                                                hook):
    """A configuration of family ``moe`` (here without experts, which the
    port builds as a decoder) runs to its result line: its round's FLOPs
    come from its reference module's ``active_params`` where defined, and
    are left uncounted (no ``mfu``) where not."""
    from bench.reference import decoder
    ref = types.ModuleType("bench.reference.tiny_moe")
    ref.param_spec, ref.sequence_loss = decoder.param_spec, \
        decoder.sequence_loss
    if hook:
        ref.active_params = lambda m: 10 ** 6
    monkeypatch.setitem(sys.modules, ref.__name__, ref)
    root = tiny_root(tmp_path)
    bench = root / "bench"
    config = json.loads((bench / "configs" / "internvl2-1b.json").read_text())
    config.update(name="tiny-moe", reference="tiny_moe")
    config["model"].update(name="tiny-moe", family="moe", n_patches=0,
                           n_experts=0)
    (bench / "configs" / "tiny-moe.json").write_text(json.dumps(config))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-moe", "source": "test",
                                "file": "bench/configs/tiny-moe.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "tiny-moe.train",
                                  "config": "tiny-moe",
                                  "traffic": "train_b8_s2048_m1",
                                  "chips": 1, "why": "test"})
    for m in manifest["per_layer"]:
        if m["name"] == "mfu":
            m["workloads"].append("tiny-moe.train")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    (bench / "workloads" / "tiny-moe.train.json").write_text(json.dumps(
        {"limits": {"grad1": 0.01, "change3": 0.01}}))
    args = run.parse(["--workload", "tiny-moe.train", "--seed", "9",
                      "--seconds", "0.3", "--trace", "1"])
    result, _ = run.run(args, root=root, device=torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert ("mfu" in result["metrics"]) == hook
