"""The reference server's warm-corrected thresholds and trust gates
against the port's (``SelectionEngine._stats_thresholds``, the launch
path's choice with fused statistics and ``warm_start``): from the same
carried state and histograms both choose the same (θ_M, θ_A) and the
same streak, bit for bit, on track and off, trusted and not."""

import pytest
import torch

from bench.reference.server import Layout, Server

SHAPES = [(64, 96), (300,), (7, 33)]


def _pair():
    from repro_torch.core import engine
    from repro_torch.launch import steps
    params = {f"p{i}": torch.zeros(s) for i, s in enumerate(SHAPES)}
    lay = steps.server_layout(params)
    eng = engine.SelectionEngine(
        engine.EngineConfig(backend="packed", fused_stats=True,
                            warm_start=True), lay.d_packed, layout=lay)
    ref = Server(Layout([params[k].shape for k in sorted(params)]),
                 {"rho": 0.1}, torch.device("cpu"))
    assert eng.budgets()[:2] == (ref.k, ref.k_m)
    return eng, ref


@pytest.mark.parametrize("trial", range(40))
def test_warm_thresholds_match_the_port(trial):
    eng, ref = _pair()
    gen = torch.Generator().manual_seed(trial)

    def u(lo, hi):
        return lo + (hi - lo) * float(torch.rand((), generator=gen))
    k = ref.k
    n_sel = float(round(k * u(0.6, 1.4)))
    state = {"theta_m": torch.tensor(u(1e-4, 1e-2)),
             "theta_a": torch.tensor(u(0.0, 12.0)),
             "n_sel": torch.tensor(n_sel),
             "n_sel_m": torch.tensor(float(round(n_sel * u(0.5, 0.95)))),
             "streak": torch.tensor(float(trial % 6))}
    mag = torch.randint(0, 50, (128,), generator=gen).float()
    age = torch.randint(0, 50, (128,), generator=gen).float()
    ref.carried, ref.mag_hist, ref.age_hist = dict(state), mag, age
    want = ref.select_thresholds()
    tstate = dict(state, init=torch.tensor(1.0), mag_hist=mag, age_hist=age)
    got = eng._stats_thresholds(tstate)
    for a, b in zip(got, want):
        assert torch.equal(a.reshape(()).float(), b.reshape(()).float()), \
            (trial, got, want)


def test_first_round_has_no_streak():
    eng, ref = _pair()
    tm, ta, streak = ref.select_thresholds()
    assert float(tm) == float(ta) == float(streak) == 0.0
    assert ref.warm_rounds == 0
