"""The extension benchmarks (``benchmarks/torch_ext_error_feedback.py``,
``torch_ext_fairk_auto.py``) and the kernel micro-benchmarks
(``torch_kernels_bench.py``) on the CPU: rows under the JAX scripts' row
names (the reference's ``train`` stood in for by a recorder, so that its
row names come from its own loop), finite fields, and on the CPU the
kernel rows reported as skipped, never as timed."""

import math

import pytest

from benchmarks import ext_error_feedback, ext_fairk_auto
from benchmarks import torch_ext_error_feedback, torch_ext_fairk_auto
from benchmarks import torch_kernels_bench
from benchmarks.torch_common import csv_row

PAIRS = {"ext_ef": (ext_error_feedback, torch_ext_error_feedback),
         "ext_auto": (ext_fairk_auto, torch_ext_fairk_auto)}


def _reference_rows(mod, monkeypatch):
    def fake_train(fl, *a, **kw):
        return {"acc": [0.5], "km_frac": [fl.k_m_frac, fl.k_m_frac]}

    monkeypatch.setattr(mod, "train", fake_train)
    return mod.run(fast=True)[0]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_ext_rows_have_the_reference_names(name, monkeypatch):
    ref, port = PAIRS[name]
    want = [r[0] for r in _reference_rows(ref, monkeypatch)]
    rows, detail = port.run(fast=True, device="cpu", rounds=2)
    assert [r[0] for r in rows] == want
    assert len(detail) == len(want)
    for row in rows:
        head, us, derived = csv_row(*row).split(",", 2)
        assert head == row[0] and math.isfinite(float(us))
        acc = float(derived.split(";")[0].split("=")[1])
        assert 0.0 <= acc <= 1.0


def test_fairk_auto_records_the_split_path():
    _, detail = torch_ext_fairk_auto.run(fast=True, device="cpu", rounds=2)
    for tag, d in detail.items():
        path = d["km_path"]
        assert set(path) == {"start", "end", "min", "max"}
        assert path["min"] <= path["start"] <= path["max"]
        if not tag.startswith("fairk_auto"):
            assert path["start"] == path["end"] == float(tag[-4:])


def test_kernels_bench_skips_the_kernel_rows_on_the_cpu():
    rows, detail = torch_kernels_bench.run(fast=True, device="cpu")
    names = [r[0] for r in rows]
    kernels = ("fairk_update", "sign_mv", "sign_from_energy", "aou_merge",
               "block_topk", "two_stage_topk")
    assert names == [f"kernels/{k}{s}" for k in kernels
                     for s in ("", "_plain")] + [
                         "kernels/exact_topk_baseline"]
    for name, us, derived in rows:
        if name.endswith(("_plain", "_baseline")):
            assert math.isfinite(us) and us > 0
        else:
            assert math.isnan(us) and derived == "skipped=no card"
    for k in kernels:
        assert detail[k]["us"] is None and "skipped" in detail[k]
