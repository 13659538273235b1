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
  entry point needs a card.
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
             "fl": _start(fl), "base": _start(fl + ["--fl-baseline"])}
    got = {k: _wait(p) for k, p in procs.items()}
    train = json.loads(got["train"].strip().splitlines()[-1])
    arts = {}
    for tag in ("fl", "flbase"):
        with open(os.path.join(out, f"mamba2-370m__train_4k__16x16__{tag}"
                                    ".json")) as f:
            arts[tag] = json.load(f)
    return out, train, arts, got


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
