"""The comparison catches a timed path broken underneath: each fault a
cell can have, planted in the port's step of a tiny CPU run, turns
``correct`` false under the cell's own limits."""

import pytest
import torch

from bench import run
from bench.harness import cells, faults
from tiny import tiny_root

CASES = [("internvl2-1b.train", f) for f in faults.FAULTS] + \
        [("mamba2-370m.train", f) for f in faults.FAULTS] + \
        [("internvl2-1b.update", f) for f in ("unchanged", "altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_turns_correct_false(tmp_path, monkeypatch, cell, fault):
    made = cells.Cell.__init__

    def broken(self, *a, **kw):
        made(self, *a, **kw)
        faults.plant(self, fault)
    monkeypatch.setattr(cells.Cell, "__init__", broken)
    args = run.parse(["--workload", cell, "--seed", str(2**31 + 5),
                      "--seconds", "0.2", "--trace", "0"])
    result, _ = run.run(args, root=tiny_root(tmp_path),
                        device=torch.device("cpu"))
    assert result["correct"] is False, result["checks"]


def test_update_cell_has_no_batch_to_halve(tmp_path):
    from bench.harness.registry import Registry
    reg = Registry(tiny_root(tmp_path))
    wl = reg.workload("internvl2-1b.update", "update_pool4_onebit_ef")
    cell = cells.Cell(reg.config("internvl2-1b"), wl, 1, torch.device("cpu"))
    with pytest.raises(ValueError):
        faults.plant(cell, "half_batch")
