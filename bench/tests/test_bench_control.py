"""The control comes out as not correct: the reference put in the port's
place, in the precision below the one the configuration states (fp8
operands of every product for the bf16 train cells, bf16 inputs to the
float32 server round), fails the cell's own limits.  On the card, at the
sizes ``tiny.CARD_MODEL`` / ``CARD_TRAFFIC`` set (the cells' own size is
read by ``bench/calibrate.py``; ``PERF.md`` has those readings)."""

import pytest

from bench.harness import compare
from bench.harness.registry import Registry
from bench.reference.follow import follow
from tiny import CARD_MODEL, CARD_TRAFFIC, tiny_root

CONTROL = {"internvl2-1b.train": "float8_e4m3fn",
           "mamba2-370m.train": "float8_e4m3fn",
           "internvl2-1b.update": "bfloat16"}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_control_is_not_correct(tmp_path, card, cell):
    reg = Registry(tiny_root(tmp_path, CARD_MODEL, CARD_TRAFFIC))
    entry = reg.cell(cell)
    wl = reg.workload(cell, entry["traffic"])
    config = reg.config(entry["config"])
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        control = follow(config, wl, seed, card, prec=CONTROL[cell])
        ref = follow(config, wl, seed, card)
        checks = compare.judge(compare.numbers(control, ref), wl["limits"])
        assert not compare.passed(checks), checks
