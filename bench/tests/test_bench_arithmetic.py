"""The metric arithmetic on synthetic inputs: the round time and its
95th percentile over all rounds, the share of the bf16 peak, the kernels'
byte counts against the kernel table's bounds, the idle share and the
idle gaps' labels from intervals."""

import statistics
from pathlib import Path

import pytest

from bench.harness import trace, yardstick
from bench.harness.registry import Registry

ROOT = Path(__file__).resolve().parents[2]
D_LAUNCH = 629_664_256          # internvl2-1b's packed coordinates


def read(name, ctx):
    return Registry(ROOT).reader(name)(ctx)


def test_round_ms_is_the_window_over_its_rounds():
    assert read("round_ms", {"window_s": 30.0, "rounds": 12}) == 2500.0


def test_p95_is_over_all_rounds_and_needs_twenty():
    times = [100.0] * 95 + [200.0] * 5
    p95 = read("round_ms.p95", {"round_ms": times})
    assert p95 == statistics.quantiles(times, n=100)[94]
    assert 100.0 < p95 <= 200.0
    assert read("round_ms.p95", {"round_ms": [1.0] * 19}) is None


def test_phase_means():
    ctx = {"rounds": 4, "grads_ms": [1, 2, 3, 4], "update_ms": [2] * 4}
    assert read("grads_ms", ctx) == 2.5 and read("update_ms", ctx) == 2.0
    assert read("grads_ms", {"rounds": 1, "update_ms": [1]}) is None


def test_model_flops_and_mfu():
    vlm = {"family": "vlm", "d_model": 896, "vocab": 151655, "n_layers": 24,
           "n_heads": 14, "n_kv_heads": 2, "head_dim": 64, "d_ff": 4864,
           "qkv_bias": True}
    # the port's analytic count of internvl2-1b, norms excluded
    assert yardstick.param_count(vlm) == 629_619_968
    flops = yardstick.model_flops(vlm, 8 * 4096)
    assert flops == pytest.approx(1.2378e14, rel=1e-4)
    ctx = {"workload": {"kind": "train"}, "flops_per_round": flops,
           "rounds": 5, "window_s": 30.0}
    assert read("mfu", ctx) == pytest.approx(
        100 * 5 * flops / 30.0 / 989e12)
    assert read("mfu", dict(ctx, workload={"kind": "update"})) is None
    ssm = {"family": "ssm", "d_model": 1024, "vocab": 50280, "n_layers": 48,
           "ssm_expand": 2, "ssm_groups": 1, "ssm_state": 128,
           "ssm_head_dim": 64, "ssm_conv": 4, "tie_embeddings": True}
    assert yardstick.model_flops(ssm, 8 * 2048) == pytest.approx(3.62e13,
                                                                 rel=0.01)


@pytest.mark.parametrize("residual,fresh,bound_ms", [
    (False, False, 3.759), (True, True, 6.015)])
def test_fairk_bytes_match_the_kernel_table(residual, fresh, bound_ms):
    n = yardstick.fairk_update_bytes(D_LAUNCH, residual, fresh)
    assert n / yardstick.HBM_BYTES_PER_S * 1e3 == pytest.approx(bound_ms,
                                                               abs=5e-4)
    # a call that takes the bound's time reads 100%
    assert yardstick.roofline_pct(n, n / 3.35e12) == pytest.approx(100.0)


def test_sign_mv_bytes_match_the_kernel_table():
    n = yardstick.sign_mv_bytes(1, D_LAUNCH, True)
    assert n / yardstick.HBM_BYTES_PER_S * 1e3 == pytest.approx(3.007,
                                                               abs=5e-4)


def test_kernel_roofline_reads_the_trace():
    summary = {"kernels": {"fairk_kernel(float const*)": (0.009, 2),
                           "sign_mv_kernel(float const*)": (0.006, 1)}}
    ctx = {"trace": summary, "d_packed": D_LAUNCH,
           "workload": {"oac": {"one_bit": True, "error_feedback": True,
                                "noise_std": 0.5}}}
    assert read("fairk_update_roofline", ctx) == pytest.approx(
        100 * 6.0149e-3 / 4.5e-3, rel=1e-3)
    assert read("sign_mv_roofline", ctx) == pytest.approx(
        100 * 3.0074e-3 / 6e-3, rel=1e-3)
    assert read("fairk_update_roofline", dict(ctx, trace=None)) is None
    assert read("sign_mv_roofline",
                dict(ctx, trace={"kernels": {}})) is None


def test_idle_share_and_gaps_from_intervals():
    device = [(1.0, 2.0, "a"), (1.5, 3.0, "b"), (5.0, 6.0, "a"),
              (9.0, 12.0, "c")]
    host = [(0.5, 10.0, trace.WINDOW), (3.0, 5.0, "bench.update"),
            (0.5, 4.0, "bench.grads_fn")]
    s = trace.reduce(device, host)
    assert s["window_s"] == pytest.approx(9.5)
    # busy: [1, 3] + [5, 6] + [9, 10] inside the window
    assert s["busy_s"] == pytest.approx(4.0)
    assert read("idle_pct", {"trace": s}) == pytest.approx(
        100 * (1 - 4.0 / 9.5))
    assert s["idle_gaps"][0] == ["host", pytest.approx(3.0)]
    assert s["idle_gaps"][1] == ["bench.update", pytest.approx(2.0)]
    assert s["idle_gaps"][2] == ["bench.grads_fn", pytest.approx(0.5)]
    assert s["device_ops"][0] == ["a", pytest.approx(2.0)]
    assert trace.kernel_time(s, "b") == (pytest.approx(1.5), 1)
    assert trace.reduce([], host) is None
    assert trace.reduce(device, []) is None
