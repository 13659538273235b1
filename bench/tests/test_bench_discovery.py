"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files (and new manifest entries) in a copy of the checkout are run
by the harness, with no existing file of the harness edited."""

import json

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
