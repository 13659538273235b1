"""``benchmarks/torch_timing.py`` on the CPU: the exactness check, the
bound and the number of input copies that keep a call out of L2 (the
CUDA-graph timing itself runs only on the card, through ``chip_smoke.py``
and the kernel bench)."""

import pytest
import torch

from benchmarks import torch_timing as tt


def test_same_passes_bit_equal_tensors_with_nans_and_infinities():
    a = torch.tensor([0.0, 1.5, float("nan"), float("inf"), -float("inf")])
    assert tt.same(a, a.clone(), "equal") == 0.0
    idx = torch.arange(4, dtype=torch.int32)
    assert tt.same(idx, idx.clone(), "int") == 0.0


@pytest.mark.parametrize("b,match", [
    (torch.tensor([0.0, 1.5, 2.0]), "differ \\(max abs 0.5"),
    (torch.tensor([-0.0, 1.0, 2.0]), "differ"),           # sign of zero
    (torch.tensor([0.0, float("nan"), 2.0]), "NaN positions"),
    (torch.tensor([0.0, 1.0]), "shape/dtype"),
    (torch.tensor([0.0, 1.0, 2.0], dtype=torch.float64), "shape/dtype"),
])
def test_same_fails_on_any_difference(b, match):
    a = torch.tensor([0.0, 1.0, 2.0])
    with pytest.raises(AssertionError, match=match):
        tt.same(a, b, "case")


def test_bound_takes_the_larger_of_bytes_and_operations():
    ms, by = tt.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = tt.bound_ms(1.0, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)


@pytest.mark.parametrize("n_bytes,sets", [
    (4 * 2**20 + 8 * 256 * 16, 25),   # block_topk at 2^20
    (24 * 2**20, 5),                   # aou_merge at 2^20
    (48 * 2**20, 3),                   # sign_mv's (10, 2^20) votes + out
    (24 * 2**24, 1),                   # aou_merge at 2^24: larger than L2
])
def test_input_sets_reach_twice_the_l2(n_bytes, sets):
    assert tt.input_sets(n_bytes) == sets
    assert sets * n_bytes >= 2 * tt.L2_BYTES
    assert sets == 1 or (sets - 1) * n_bytes < 2 * tt.L2_BYTES
