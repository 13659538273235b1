"""The port's dry run (``repro_torch.launch.dryrun``) on the production
mesh, each run in a subprocess of its own (it starts a ``fake`` process
group of 256 ranks and destroys it):

* ``mamba2-370m`` ``train_4k`` at 16×16, full width with its depth cut to
  2 of 48 layers (the whole model takes about 6 minutes on the CPU; the
  sweep and the card run it whole; the test replaces ``dryrun.get_config``
  in its subprocess), fake CPU tensors: the reference's
  artifact keys, 16 microbatches, one ``fairk_update`` custom op per
  step, the gathers and the gradient reduce-scatters on the schedule, the
  memory block consistent, and ``report.py`` / ``benchmarks.
  torch_roofline_table`` reading the artifacts back;
* the FL-OAC step (``--fl-mode`` against ``--fl-mode --fl-baseline``) on
  the whole ``mamba2-370m`` through the command line: FAIR-k's all-reduce
  bytes 147,357,700 (ρ·d of the gradient and the loss) against the
  baseline's 1,473,560,580, a ratio under the reference's 0.2
  (``tests/test_sharded.py``, ``test_fl_oac_collective_reduction``);
* a combination that fails makes the run exit 1; without ``--device`` the
  entry point needs a card;
* the FSDP×TP train step's float32 buffers: ``deepseek-67b`` ``train_4k``
  at 16×16, full width with 2 of its 95 layers, traced under a
  ``StepCounter`` that also notes the largest float32 storage alive at
  the peak and the collectives' groups: no float32 buffer alive at the
  peak (the attention's (S, S) scores aside, activations of one row) is
  larger than the largest leaf's local accumulator plus one block's
  FSDP-gathered float32 gradient, and the gradient
  reduce-scatters over ``data`` number the gathered leaves' blocks times
  the microbatches (one per leaf, block and microbatch).
"""

import json
import os
import subprocess
import sys

import pytest
from rankutil import _env

from repro_torch.launch import dryrun

_TRAIN = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
out = sys.argv[1]
dryrun.start_fake_group(256)
dryrun.get_config = lambda arch: dataclasses.replace(get_config(arch),
                                                     n_layers=2)
art = dryrun.run_one("mamba2-370m", "train_4k", False, out, device="cpu",
                     force=True)
dryrun.run_one = lambda *a, **k: 1 / 0
try:
    dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                 "--device", "cpu", "--out", out])
    code = 0
except SystemExit as e:
    code = e.code
print(json.dumps({"art": art, "failed_exit": code}))
"""


_ACCUMULATORS = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch import tree as tree_util
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import dispatch

dryrun.start_fake_group(256)
cfg = dataclasses.replace(get_config("deepseek-67b"), n_layers=2)
shape = SHAPES["train_4k"]
mesh = make_production_mesh(device_type="cpu")
dev = torch.device("cpu")
data_ranks = sorted(dist.get_process_group_ranks(mesh.get_group("data")))


class Counter(dispatch.StepCounter):
    def __init__(self):
        super().__init__()
        self.f32 = {}
        self.largest_f32_at_peak = 0
        self.data_rs = 0

    def _alive(self, t):
        added = super()._alive(t)
        # the attention's float32 scores, whole (S, S) tiles of one row's
        # heads in any layout, are activations
        if (added and t.dtype == torch.float32
                and t.numel() % shape.seq_len ** 2):
            self.f32[t.untyped_storage()._cdata] = added
        if added and self.live_bytes == self.peak_bytes:
            self.largest_f32_at_peak = max(
                (n for k, n in self.f32.items() if k in self.live),
                default=0)
        return added

    def _collective(self, func, name, args, kwargs, out):
        super()._collective(func, name, args, kwargs, out)
        group = dispatch._group_of(args)
        if (dispatch._COLLECTIVE_KIND[name] == "reduce-scatter"
                and group is not None
                and sorted(dist.get_process_group_ranks(group))
                == data_ranks):
            self.data_rs += 1


with FakeTensorMode():
    bundle = dryrun.make_step(cfg, shape, mesh, device=dev)
    inputs = dryrun.step_inputs(bundle, cfg, shape, mesh, dev)
    counter = Counter()
    counter.track(inputs)
    with counter:
        bundle.fn(*inputs)
params_abs = dryrun.abstract_params(cfg)
specs = sharding.spec_leaves(bundle.in_specs[0])
local, block_grad, scattered = [], 0, 0
for (path, x), spec in zip(tree_util.leaves(params_abs), specs):
    local.append(4 * torch.Size(
        sharding.local_shape(x.shape, spec, mesh)).numel())
    if any("data" in sharding.entry_axes(e) for e in tuple(spec)):
        stacked = path[0] == "blocks"
        scattered += cfg.n_scan_blocks if stacked else 1
        if stacked:
            # one block's gradient, gathered over ``data`` (16 ranks)
            block_grad += 16 * local[-1] // cfg.n_scan_blocks
print(json.dumps({
    "largest_f32_at_peak": counter.largest_f32_at_peak,
    "largest_local_acc": max(local), "block_grad": block_grad,
    "data_reduce_scatters": counter.data_rs,
    "expected_reduce_scatters": scattered * bundle.meta["n_micro"],
    "split": bundle.meta["tensor_parallel"],
    "peak_bytes": counter.peak_bytes}))
"""


def _start(args, env=None):
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=_env(env or {}))


def _wait(p, timeout=600):
    out, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, err[-4000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three dry runs, concurrently."""
    out = str(tmp_path_factory.mktemp("torch_dryrun"))
    fl = ["-m", "repro_torch.launch.dryrun", "--arch", "mamba2-370m",
          "--shape", "train_4k", "--fl-mode", "--device", "cpu", "--out",
          out]
    procs = {"train": _start(["-c", _TRAIN, out]),
             "fl": _start(fl), "base": _start(fl + ["--fl-baseline"]),
             "acc": _start(["-c", _ACCUMULATORS])}
    got = {k: _wait(p) for k, p in procs.items()}
    train = json.loads(got["train"].strip().splitlines()[-1])
    arts = {}
    for tag in ("fl", "flbase"):
        with open(os.path.join(out, f"mamba2-370m__train_4k__16x16__{tag}"
                                    ".json")) as f:
            arts[tag] = json.load(f)
    return out, train, arts, got


def test_fsdp_tp_float32_buffers_and_reduce_scatters(runs):
    got = json.loads(runs[3]["acc"].strip().splitlines()[-1])
    assert got["split"] == ["attn", "ffn", "vocab"]
    assert 0 < got["largest_f32_at_peak"] <= (got["largest_local_acc"]
                                              + got["block_grad"])
    assert got["data_reduce_scatters"] == got["expected_reduce_scatters"]
    # 7 gathered leaves a block, embed and head; 16 microbatches
    assert got["expected_reduce_scatters"] == 16 * (2 * 7 + 2)


def test_train_step_on_the_production_mesh(runs):
    _, train, _, _ = runs
    art = train["art"]
    assert set(art) >= {"arch", "shape", "mesh", "fl_mode", "fl_baseline",
                        "meta", "trace_s", "memory", "parsed", "roofline",
                        "suggestion"}
    assert (art["arch"], art["shape"], art["mesh"]) == (
        "mamba2-370m", "train_4k", "16x16")
    assert art["meta"]["kind"] == "train"
    assert art["meta"]["mesh_shape"] == [16, 16]
    assert art["meta"]["n_micro"] == 16 and art["meta"]["rows_sharded"]
    p = art["parsed"]
    assert set(p) >= {"flops_per_device", "bytes_per_device",
                      "collective_bytes_per_device", "collective_breakdown",
                      "collective_counts", "n_ops", "flops_by_dtype",
                      "peak_bytes"}
    assert p["ops"]["repro_torch.fairk_update"] == 1
    counts = p["collective_counts"]
    assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
    assert counts["all-reduce"] > 0
    assert p["collective_link_bytes"]["nvlink"] == 0.0     # 16-rank axes
    assert p["flops_by_dtype"]["bfloat16"] > p["flops_by_dtype"]["float32"]
    mem = art["memory"]
    assert mem["per_device_total"] == p["peak_bytes"]
    assert mem["temp_bytes"] == mem["per_device_total"] - mem["argument_bytes"]
    assert 0 < mem["argument_bytes"] < mem["per_device_total"]
    r = art["roofline"]
    assert r["chips"] == 256
    assert r["step_time_s"] == max(r["compute_s"], r["memory_s"],
                                   r["collective_s"])
    assert art["suggestion"]
    assert train["failed_exit"] == 1


def test_fl_oac_fairk_moves_a_tenth_of_the_baseline(runs):
    _, _, arts, got = runs
    fairk = arts["fl"]["parsed"]["collective_bytes_per_device"]
    base = arts["flbase"]["parsed"]["collective_bytes_per_device"]
    assert fairk == 147_357_700 and base == 1_473_560_580
    assert fairk / base < 0.2
    assert arts["fl"]["meta"]["kb"] == 8994
    assert arts["flbase"]["fl_baseline"] and not arts["fl"]["fl_baseline"]
    assert "traced OK" in got["fl"] and "traced OK" in got["base"]


def test_report_and_table_read_the_artifacts(runs, capsys):
    from benchmarks import torch_roofline_table
    from repro_torch.roofline import report
    out, _, _, _ = runs
    report.main(["--dir", out])
    text = capsys.readouterr().out
    assert "| mamba2-370m | train_4k | 16x16 |" in text
    assert "| baseline (full all-reduce) | 1.372 |" in text
    assert "| FAIR-k (rho=0.1 blocks) | 0.137 |" in text
    rows, detail = torch_roofline_table.run(art_dir=out)
    assert len(rows) == 3 and len(detail) == 3
    assert all(r[0].startswith("roofline/mamba2-370m__train_4k") for r in rows)


def test_entry_point_needs_a_card_or_the_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k"])
