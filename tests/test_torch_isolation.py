"""The port stands alone: every module imports with JAX and the JAX
package blocked, and entry points refuse to run without a card unless the
caller asks for the CPU."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import device as device_mod

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


BENCHMARKS = sorted(
    "benchmarks." + f[:-3] for f in os.listdir(os.path.join(ROOT,
                                                            "benchmarks"))
    if f.startswith("torch_") and f.endswith(".py"))


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    for name in ("repro_torch.fl.trainer", "repro_torch.fl.sweep",
                 "repro_torch.core.controller", "repro_torch.core.markov",
                 "repro_torch.core.lipschitz", "repro_torch.tree",
                 "repro_torch.core.packing", "repro_torch.core.engine",
                 "repro_torch.core.faults", "repro_torch.core.population",
                 "repro_torch.core.channel", "repro_torch.configs",
                 "repro_torch.configs.base",
                 "repro_torch.configs.internvl2_1b",
                 "repro_torch.data.tokens", "repro_torch.models.layers",
                 "repro_torch.models.mlp", "repro_torch.models.attention",
                 "repro_torch.models.transformer", "repro_torch.optim",
                 "repro_torch.optim.optimizers",
                 "repro_torch.optim.schedule", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.io", "repro_torch.launch",
                 "repro_torch.launch.steps", "repro_torch.launch.train"):
        assert name in mods
    assert len(mods) >= 52
    assert len(BENCHMARKS) == 12
    for name in ("benchmarks.torch_engine_bench",
                 "benchmarks.torch_packed_bench",
                 "benchmarks.torch_population_bench"):
        assert name in BENCHMARKS
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods + BENCHMARKS!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') or k == 'repro' "
        "or k.startswith('repro.') for k, v in sys.modules.items() "
        "if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("name", BENCHMARKS)
def test_benchmark_sources_import_no_jax(name):
    path = os.path.join(ROOT, *name.split(".")) + ".py"
    with open(path) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src
    assert "from repro." not in src and "import repro\n" not in src
    assert "from repro " not in src


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_source_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src
    assert "from repro." not in src and "import repro\n" not in src


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    from repro_torch.core import packing
    from repro_torch.fl import trainer
    from repro_torch.kernels import ops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fl = trainer.FLConfig(backend="packed", n_clients=2, client_chunk=1)
    exact = trainer.FLConfig(n_clients=2, client_chunk=1)
    params = {"w": torch.zeros(3)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mod.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.init_server(params, fl)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.make_fl_step(fl, lambda w: w, None, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.train(fl, params, None, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.make_fl_step(exact, lambda w: w, None, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.train(exact, params, None, None)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fairk_ef_update(torch.zeros(3), torch.zeros(3), torch.zeros(3),
                            0.0, 0.0, mode="kernel")
    from repro_torch.fl import sweep
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.run_sweep(sweep.SweepConfig(d=8, rounds=1))
    from benchmarks import torch_common, torch_run
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_common.make_task()
    for name, mod in torch_run.MODULES.items():
        if name == "fig3":           # numpy only: nothing runs on a device
            continue
        with pytest.raises(RuntimeError, match="device='cpu'"):
            # the server-phase benchmarks are cut by repeats, the figures
            # by rounds
            mod.run(**({"repeats": 1}
                       if name in ("engine", "packed", "population")
                       else {"rounds": 1}))
    from benchmarks import torch_packed_bench
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_packed_bench.bench_tree(2, 32, 256, repeats=1)
    from repro_torch.core import engine
    lay = packing.PackedLayout.from_tree({"a": torch.zeros(300)})
    for build in (lay.valid_mask, lay.init_age, lambda: lay.sample_ids(8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert lay.valid_mask("cpu").device.type == "cpu"
    assert lay.init_age(device="cpu").device.type == "cpu"
    assert lay.sample_ids(8, "cpu").device.type == "cpu"
    eng = engine.make_engine("fairk", "packed", layout=lay)
    assert eng.sample_ids("cpu").device.type == "cpu"
    assert device_mod.resolve_device("cpu").type == "cpu"
    state, _ = trainer.init_server(params, fl, device="cpu")
    assert state.w.device.type == "cpu"
    assert packing.init_threshold_state("cpu")["theta_m"].device.type == "cpu"
    from repro_torch.core import channel, faults, population
    pcfg = population.PopulationConfig(n_clients=16, participants=4)
    scenario_builds = {
        "stateless_round": lambda dev: population.stateless_round(
            0, 1, pcfg, dev)["n_t"],
        "stateless_avail": lambda dev: population.stateless_avail(
            0, 1, pcfg, dev),
        "availability_rate": lambda dev: population.availability_rate(
            pcfg, 1, dev),
        "init_block_fading": lambda dev: channel.init_block_fading(4, dev),
        "init_watchdog_state": lambda dev: faults.init_watchdog_state(
            dev)["trips"],
    }
    for name, build in scenario_builds.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(None)
        assert build("cpu").device.type == "cpu", name


def test_launch_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch,
                                                            tmp_path):
    from repro_torch import checkpoint
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("internvl2-1b", reduced_variant=True)
    shape = InputShape("custom", 32, 2, "train")
    builds = {
        "make_train_step": lambda dev: steps.make_train_step(
            cfg, shape, n_micro=2, device=dev).grads_fn(
                params, train.make_batch(cfg, 0, 0, 2, 16, 2, "cpu"))[0],
        "init_lm_seeded": lambda dev: transformer.init_lm_seeded(
            cfg, 0, dev)["embed"],
        "state_from_numpy": lambda dev: steps.state_from_numpy(
            {"a": np.zeros(3, np.float32)}, dev)["a"],
        "restore": lambda dev: checkpoint.restore(path, device=dev)["a"],
        "restore_server_state": lambda dev: checkpoint.restore_server_state(
            srv_path, device=dev)[0]["g"],
    }
    params = transformer.init_lm_seeded(cfg, 0, "cpu")
    path = checkpoint.save(str(tmp_path / "t.npz"), {"a": torch.zeros(3)})
    srv_path = checkpoint.save_server_state(
        str(tmp_path / "s.npz"), {"g": torch.zeros(4, dtype=torch.bfloat16)})
    for name, build in builds.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(None)
        assert build("cpu").device.type == "cpu", name
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "internvl2-1b", "--steps", "1"])


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import aou_merge, block_topk, fairk_update
    from repro_torch.kernels import sign_mv
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        aou_merge.aou_merge_cuda(x, x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        block_topk.block_topk_cuda(x, 2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        fairk_update.fairk_update_cuda(x, x, x, torch.zeros(()),
                                       torch.zeros(()))
    with pytest.raises(ValueError, match="CUDA"):
        sign_mv.sign_mv_cuda(x[None])
    with pytest.raises(ValueError, match="CUDA"):
        sign_mv.sign_from_energy_cuda(x)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is false" in out.stdout
    assert '"ok": true' not in out.stdout


def test_serving_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    """The new layer modules stand alone, and ``init_caches`` (the
    serving path's allocation) follows the card-or-explicit-CPU rule;
    ``cache_specs`` allocates nothing (``meta`` tensors)."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba2, moe, transformer
    mods = _port_modules()
    for name in ("repro_torch.models.moe", "repro_torch.models.mamba2"):
        assert name in mods
    for mod in (moe, mamba2):
        with open(mod.__file__) as f:
            src = f.read()
        assert "import jax" not in src and "from repro." not in src
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("whisper-base", reduced_variant=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_caches(cfg, 1, 8)
    caches = transformer.init_caches(cfg, 1, 8, device="cpu")
    assert caches[0]["attn"]["k"].device.type == "cpu"
    assert caches[0]["cross"]["k"].shape[2] == cfg.encoder_seq
    assert transformer.cache_specs(cfg, 1, 8)[0]["attn"]["k"].is_meta
