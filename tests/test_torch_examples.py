"""The six ``examples/torch_*.py`` entry points on the CPU at a tiny size,
against the JAX package's examples where both compute the same numbers:
the Lemma 1 table (numpy in both) printed identically, and the
quickstart's data, partition, model size and round settings equal to
the reference example's (captured by standing in for its ``train``)."""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.models import cnn as jcnn
from repro_torch import checkpoint
from repro_torch import tree as tree_util
from repro_torch.models import cnn

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY = {
    "torch_quickstart": ["--rounds", "2"],
    "torch_fl_cifar_sim": ["--rounds", "2", "--policies", "fairk,topk",
                           "--clients", "4", "--model", "mlp"],
    "torch_fl_prototype_onebit": ["--rounds", "2"],
    "torch_train_lm": ["--steps", "2", "--batch", "2", "--seq", "32"],
    "torch_serve_lm": ["--batch", "2", "--prompt-len", "8", "--tokens",
                       "3"],
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_example_runs_on_the_cpu(name):
    out = _load(name).main(TINY[name] + ["--device", "cpu"])
    if name in ("torch_quickstart", "torch_fl_prototype_onebit"):
        assert len(out) == (2 if name == "torch_quickstart" else 3)
        for h in out.values():
            assert all(math.isfinite(a) for a in h["acc"])
            assert h["state"].w.device.type == "cpu"
    elif name == "torch_fl_cifar_sim":
        assert set(out) == {"fairk", "topk"}
        assert all(math.isfinite(r["acc"][-1]) for r in out.values())
    elif name == "torch_train_lm":
        assert len(out["losses"]) == 2
        assert all(math.isfinite(x) for x in out["losses"])
    elif name == "torch_serve_lm":
        assert tuple(out["gen"].shape) == (2, 3)
        logits, _ = out["warm_step"]()
        assert bool(torch.isfinite(logits).all())


def test_aou_analysis_prints_the_reference_table(capsys):
    """The sixth example (numpy only) prints the reference example's
    table character for character."""
    ref = _load("aou_analysis")
    ref.main()
    want = capsys.readouterr().out
    out = _load("torch_aou_analysis").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert "E[tau]" in got and "k_M/k=0.90" in got
    assert math.isfinite(out["e_tau"]) and 0.0 <= out["tv"] < 0.1


def test_quickstart_data_and_settings_equal_the_reference(monkeypatch):
    """The reference example's dataset, partition, model size and
    ``FLConfig`` (its ``train`` stood in for by a recorder) against the
    port example's."""
    seen = {"data": [], "parts": [], "train": []}
    make, dirichlet = jsynthetic.make_dataset, jpartition.dirichlet_partition

    def rec_make(*a, **k):
        out = make(*a, **k)
        seen["data"].append(out)
        return out

    def rec_dirichlet(*a, **k):
        out = dirichlet(*a, **k)
        seen["parts"].append(out)
        return out

    monkeypatch.setattr(jsynthetic, "make_dataset", rec_make)
    monkeypatch.setattr(jpartition, "dirichlet_partition", rec_dirichlet)
    ref = _load("quickstart")

    def fake_train(fl, params0, loss_fn, sample_round, **kw):
        seen["train"].append((fl, params0, sample_round(0)))
        return {"acc": [0.0], "mean_aou": [0.0],
                "sel_count": np.zeros(3)}

    monkeypatch.setattr(ref, "train", fake_train)
    ref.main()
    port = _load("torch_quickstart")
    xtr, ytr, xte, yte, parts = port.make_data()
    (jxtr, jytr), (jxte, jyte) = seen["data"][0]
    for a, b in ((xtr, jxtr), (ytr, jytr), (xte, jxte), (yte, jyte)):
        np.testing.assert_array_equal(a, b)
    assert len(parts) == len(seen["parts"][0]) == port.N_CLIENTS
    for a, b in zip(parts, seen["parts"][0]):
        np.testing.assert_array_equal(a, b)
    params0, _, _, sample_round = port.make_task("cpu")
    jparams = seen["train"][0][1]
    assert cnn.param_count(params0) == jcnn.param_count(jparams)
    for (pa, a), (pb, b) in zip(tree_util.leaves(params0),
                                tree_util.leaves(
                                    {k: dict(v) for k, v in
                                     jparams.items()})):
        assert pa == pb and tuple(a.shape) == tuple(np.shape(b))
    for a, b in zip(sample_round(0), seen["train"][0][2]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert [fl.policy for fl, _, _ in seen["train"]] == list(port.POLICIES)
    for fl, _, _ in seen["train"]:
        mine = port.fl_config(fl.policy)
        for field in ("n_clients", "local_steps", "batch_size", "local_lr",
                      "global_lr", "rounds", "policy", "backend",
                      "compression_ratio", "k_m_frac", "one_bit",
                      "error_feedback"):
            assert getattr(mine, field) == getattr(fl, field), field
        for field in ("fading", "mean", "noise_std"):
            assert (getattr(mine.channel, field)
                    == getattr(fl.channel, field)), field


def test_train_lm_checkpoint_round_trips(tmp_path):
    out = _load("torch_train_lm").main(
        ["--steps", "2", "--batch", "2", "--seq", "32", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)])
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["ckpt"] == str(tmp_path / "step_00000002.npz")
    back = checkpoint.restore(out["ckpt"], like=out["params"], device="cpu")
    la, lb = tree_util.leaves(back), tree_util.leaves(out["params"])
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, a), (_, b) in zip(la, lb):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
