"""Tiny copies of the cells for CPU runs: a checkout root in a temporary
directory with its own ``BENCHMARK.json`` and the bench's data files,
the configurations cut to a few hundred thousand parameters and computed
in float32, the traffic cut to a few short sequences."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

TINY_MODEL = {
    "internvl2-1b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         head_dim=16, d_ff=128, vocab=256, n_patches=8,
                         compute_dtype="float32"),
    "mamba2-370m": dict(n_layers=2, d_model=64, vocab=256, ssm_state=16,
                        ssm_head_dim=16, ssm_chunk=16,
                        compute_dtype="float32"),
}
TINY_TRAFFIC = {
    "train_b8_s4096_m1": dict(batch=4, seq_len=40),
    "train_b8_s2048_m1": dict(batch=2, seq_len=32, n_micro=1),
    "update_pool4_onebit_ef": dict(pool=2),
}


# a size a test run on the card holds: internvl2-1b at full width with two
# layers and short sequences; mamba2-370m as its cell runs it (cut to two
# layers, its fp8 control reads under the cell's `grad1_mid` limit: the
# median leaf's gap grows with depth)
CARD_MODEL = {"internvl2-1b": dict(n_layers=2)}
CARD_TRAFFIC = {
    "train_b8_s4096_m1": dict(batch=2, seq_len=1024),
    "update_pool4_onebit_ef": dict(pool=2),
}


def tiny_root(tmp: Path, model=TINY_MODEL, traffic=TINY_TRAFFIC) -> Path:
    """A root whose cells are the benchmark's, cut to CPU size (or to
    ``model`` / ``traffic``'s overrides)."""
    root = Path(tmp)
    for kind in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(BENCH / kind, root / "bench" / kind)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, over in model.items():
        path = root / "bench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["model"].update(over)
        path.write_text(json.dumps(cfg))
    for name, over in traffic.items():
        path = root / "bench" / "traffic" / f"{name}.json"
        tr = json.loads(path.read_text())
        tr.update(over)
        path.write_text(json.dumps(tr))
    return root
