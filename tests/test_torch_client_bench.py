"""``benchmarks/torch_client_bench.py`` against the JAX package's
``benchmarks/client_bench.py``: the structural counters of one round
(streaming folds, live (N, d) client matrices, reads of g on the packed
round, the largest client matrix) at the reference's smoke size, and the
port's ``CLIENT_STREAM_PASSES`` counter."""

import numpy as np
import pytest
import torch

from benchmarks import client_bench as jbench
from benchmarks import torch_client_bench as tbench
from repro_torch.fl import trainer

N, M, C = 64, 32, 8


def test_smoke_passes_check_on_the_cpu():
    res = tbench.smoke("cpu")
    assert res["device"] == "cpu" and res["d"] == 8 * M
    assert res["clients_per_s"] == {} and res["peak_client_bytes"] == {}


@pytest.fixture(scope="module")
def both():
    port = {"chunked": tbench.trace_metrics(tbench._fl(N, C), M, "cpu"),
            "dense": tbench.trace_metrics(tbench._fl(N, None), M, "cpu"),
            "packed": tbench.trace_metrics(tbench._fl(N, C, "packed"), M,
                                           "cpu")}
    ref = {"chunked": jbench.trace_metrics(jbench._fl(N, C), M),
           "dense": jbench.trace_metrics(jbench._fl(N, None), M),
           "packed": jbench.trace_metrics(jbench._fl(N, C, "packed"), M)}
    return port, ref


@pytest.mark.parametrize("key", ["nd_live", "stream_passes"])
def test_chunked_counters_equal_the_reference(both, key):
    port, ref = both
    assert port["chunked"][key] == ref["chunked"][key]
    assert port["chunked"]["d"] == ref["chunked"]["d"] == 8 * M


def test_packed_round_reads_g_as_the_reference_does(both):
    port, ref = both
    assert port["packed"]["g_reads"] == ref["packed"]["g_reads"] == 1


@pytest.mark.parametrize("case", ["chunked", "dense"])
def test_live_bytes_equal_the_reference(both, case):
    port, ref = both
    assert (port[case]["max_live_matrix_bytes"]
            == ref[case]["max_live_matrix_bytes"])


def test_live_bytes_within_the_reference_slack(both):
    port, _ = both
    d = port["chunked"]["d"]
    assert port["chunked"]["max_live_matrix_bytes"] <= 2 * C * d * 4
    assert port["dense"]["max_live_matrix_bytes"] >= N * d * 4
    assert port["dense"]["nd_live"] > 0


@pytest.mark.parametrize("cfg", [
    dict(), dict(backend="packed"), dict(one_bit=True),
    dict(backend="threshold", error_feedback=True)])
def test_one_stream_pass_per_round(cfg):
    """``clients_fold`` runs once per round whatever the chunk count, on
    every backend and both uplinks."""
    rounds = 3
    fl = trainer.FLConfig(n_clients=8, local_steps=1, batch_size=2,
                          rounds=rounds, client_chunk=2, **cfg)
    params0, loss_fn, _, _ = tbench.make_problem(8, 4, device="cpu")
    rng = np.random.default_rng(1)

    def sample_round(t):
        return (rng.normal(size=(8, 1, 2, 8)).astype("f4"),
                rng.normal(size=(8, 1, 2, 4)).astype("f4"))

    before = trainer.CLIENT_STREAM_PASSES
    trainer.train(fl, params0, loss_fn, sample_round, device="cpu")
    assert trainer.CLIENT_STREAM_PASSES - before == rounds


def test_bench_card_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        tbench.bench_card(tbench._fl(N, C), M, torch.device("cpu"))
