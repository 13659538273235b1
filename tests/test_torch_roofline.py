"""The port's roofline (``repro_torch.roofline``) against the JAX
package's (``repro.roofline``).

* ``model_flops`` equals the reference's for every architecture × shape;
  ``build_report`` and ``suggestion`` equal the reference's on the same
  ``parsed`` dicts once the reference's constants are the port's (its
  one bf16 peak, ``HBM_BW`` and its one link at the port's network card),
  and ``report.py``'s three tables equal the reference's on the same
  artifacts but for the "trace s" header.
* The dispatch counter's counterparts of ``tests/test_roofline.py``:
  a loop of 7 matmuls counts 7 times, ``a @ b`` counts 2·m·k·n, views
  move no bytes, an elementwise op moves its operands and result, the
  peak of a known sequence of allocations and frees; on a fake process
  group (a subprocess) an ``all_reduce`` of a float32 (d,) tensor counts
  4·d bytes, on NVLink inside a node of 8 ranks and on the network card
  across nodes.
* The per-rank matmul FLOPs of a reduced ``qwen2.5-32b`` train step on a
  (2, 1) mesh (``tests/shardstep.py``'s shape: 64 tokens, batch 8 as two
  microbatches) against the reference's ``analyze_hlo`` on 2 host devices
  with ``Auto`` axes: within 10% (measured: equal, 2,483,027,968 FLOPs
  on both sides).
* Each kernel's custom op under ``FakeTensorMode``: outputs of the plain
  version's shapes and dtypes, nothing launched.
"""

import json
import subprocess
import sys

import pytest
import torch
from rankutil import _env
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.roofline import analysis as ref_analysis
from repro.roofline import report as ref_report
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.kernels import aou_merge, block_topk, fairk_update, ops
from repro_torch.kernels import sign_mv
from repro_torch.roofline import analysis, report
from repro_torch.roofline.dispatch import StepCounter, count, tensor_bytes


@pytest.fixture
def ref_constants(monkeypatch):
    """The reference's analysis with the port's peaks in its constants."""
    monkeypatch.setattr(ref_analysis, "PEAK_FLOPS", analysis.PEAK_FLOPS)
    monkeypatch.setattr(ref_analysis, "HBM_BW", analysis.HBM_BW)
    monkeypatch.setattr(ref_analysis, "ICI_BW", analysis.NIC_BW)


def test_model_flops_equal_the_reference():
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    assert sorted(SHAPES) == sorted(REF_SHAPES)
    for arch in ARCHS:
        for shape in SHAPES:
            assert analysis.model_flops(get_config(arch), SHAPES[shape]) == \
                ref_analysis.model_flops(ref_config(arch), REF_SHAPES[shape])


PARSED = [
    # compute-bound with low and high usefulness, memory-, collective-bound
    {"flops_per_device": 1e15, "bytes_per_device": 1e9,
     "collective_bytes_per_device": 1e8},
    {"flops_per_device": 1e13, "bytes_per_device": 1e9,
     "collective_bytes_per_device": 1e8},
    {"flops_per_device": 1e12, "bytes_per_device": 1e12,
     "collective_bytes_per_device": 1e8},
    {"flops_per_device": 1e12, "bytes_per_device": 1e9,
     "collective_bytes_per_device": 1e12},
    {"flops_per_device": 0.0, "bytes_per_device": 1e9,
     "collective_bytes_per_device": 0.0},
]


@pytest.mark.parametrize("i", range(len(PARSED)))
def test_build_report_and_suggestion_equal_the_reference(ref_constants, i):
    parsed = dict(PARSED[i], collective_breakdown={}, collective_counts={})
    for arch in ("qwen2.5-32b", "arctic-480b", "whisper-base"):
        for shape in SHAPES:
            got = analysis.build_report(get_config(arch), SHAPES[shape],
                                        "16x16", 256, parsed)
            want = ref_analysis.build_report(ref_config(arch),
                                             REF_SHAPES[shape], "16x16", 256,
                                             parsed)
            g, w = got.as_dict(), want.as_dict()
            # (a NaN usefulness is "NaN" on both sides)
            assert json.dumps(g, sort_keys=True) == json.dumps(
                w, sort_keys=True)
            assert analysis.suggestion(got) == ref_analysis.suggestion(want)


def test_report_terms_by_dtype_and_link():
    """The two deviations: each dtype's FLOPs over its own peak, NVLink
    bytes over NVLink's rate and the rest over the network card's."""
    parsed = {"flops_per_device": 3e12, "bytes_per_device": 0.0,
              "collective_bytes_per_device": 5e9,
              "flops_by_dtype": {"bfloat16": 2e12, "float32": 1e12},
              "collective_link_bytes": {"nvlink": 4.5e9, "nic": 5e8}}
    r = analysis.build_report(get_config("qwen2.5-32b"), SHAPES["train_4k"],
                              "16x16", 256, parsed)
    assert r.compute_s == pytest.approx(2e12 / 989e12 + 1e12 / 67e12)
    assert r.collective_s == pytest.approx(4.5e9 / 450e9 + 5e8 / 50e9)
    assert r.memory_s == 0.0
    assert r.dominant == "collective"
    assert analysis.peak_of(torch.float32) == 67e12
    assert analysis.peak_of("bfloat16") == 989e12


def _artifacts(time_key):
    arts = []
    for i, (arch, shape, mesh, fl, base) in enumerate((
            ("qwen2.5-32b", "train_4k", "16x16", False, False),
            ("qwen2.5-32b", "decode_32k", "2x16x16", False, False),
            ("mamba2-370m", "train_4k", "16x16", True, False),
            ("mamba2-370m", "train_4k", "16x16", True, True),
            ("whisper-base", "long_500k", "16x16", False, False))):
        parsed = dict(PARSED[i], collective_breakdown={},
                      collective_counts={"all-gather": 3 + i,
                                         "all-reduce": 2 * i})
        rep = ref_analysis.build_report(ref_config(arch), REF_SHAPES[shape],
                                        mesh, 256, parsed)
        arts.append({"arch": arch, "shape": shape, "mesh": mesh,
                     "fl_mode": fl, "fl_baseline": base,
                     time_key: 12.345 * (i + 1),
                     "memory": {"per_device_total": 3.3e9 * (i + 1)},
                     "parsed": parsed, "roofline": rep.as_dict(),
                     "suggestion": ref_analysis.suggestion(rep)})
    return arts


def test_report_tables_equal_the_reference(ref_constants):
    ref_arts, arts = _artifacts("compile_s"), _artifacts("trace_s")
    assert report.dryrun_table(arts) == ref_report.dryrun_table(
        ref_arts).replace("compile s", "trace s")
    assert report.roofline_table(arts) == ref_report.roofline_table(ref_arts)
    assert report.fl_table(arts) == ref_report.fl_table(ref_arts)


# ---------------------------------------------------------------------------
# the dispatch counter
# ---------------------------------------------------------------------------

def test_loop_of_matmuls_counts_every_trip():
    trips, n, k = 7, 16, 32
    with FakeTensorMode():
        ws = torch.empty(trips, k, k)
        x = torch.empty(n, k)

        def fn(x, ws):
            for w in ws:
                x = x @ w
            return x
        _, got = count(fn, x, ws)
    assert got["flops_per_device"] == 2 * n * k * k * trips
    assert got["flops_by_dtype"] == {"float32": 2 * n * k * k * trips}


def test_dot_flops():
    a, b = torch.ones(8, 64), torch.ones(64, 32, dtype=torch.float32)
    _, got = count(torch.matmul, a, b)
    assert got["flops_per_device"] == 2 * 8 * 64 * 32
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    _, got = count(torch.matmul, a16, b16)
    assert got["flops_by_dtype"] == {"bfloat16": 2 * 8 * 64 * 32}
    # the matmul moves its operands and its result
    assert got["bytes_per_device"] == 2 * (8 * 64 + 64 * 32 + 8 * 32)


def test_views_move_no_bytes():
    x = torch.zeros(32, 48)

    def views(x):
        return (x.view(48, 32), x.t(), x[3:9], x.transpose(0, 1)[1],
                x.reshape(-1), x.unsqueeze(0).expand(4, 32, 48), x.detach(),
                torch.ops.aten._unsafe_view.default(x, [48, 32]))
    _, got = count(views, x)
    assert got["bytes_per_device"] == 0.0
    assert got["flops_per_device"] == 0.0
    assert got["n_ops"] >= 8


def test_elementwise_and_in_place_bytes():
    d = 1000
    a, b = torch.ones(d), torch.ones(d)
    _, got = count(torch.add, a, b)
    assert got["bytes_per_device"] == 3 * 4 * d
    _, got = count(lambda a, b: a.add_(b), a, b)        # reads a, writes a
    assert got["bytes_per_device"] == 3 * 4 * d
    _, got = count(lambda a, b: a.copy_(b), a, b)       # a is only written
    assert got["bytes_per_device"] == 2 * 4 * d
    _, got = count(lambda a: a.zero_(), a)
    assert got["bytes_per_device"] == 4 * d
    # a broadcast operand counts once
    _, got = count(lambda a, s: a * s.expand(d), a, torch.ones(1))
    assert got["bytes_per_device"] == 4 * d + 4 + 4 * d
    # an in-place scatter touches the rows it writes, not all of self
    cache = torch.zeros(64, 128)
    rows, idx = torch.ones(2, 128), torch.tensor([3, 9])
    _, got = count(lambda c, i, r: c.index_copy_(0, i, r), cache, idx, rows)
    assert got["bytes_per_device"] == 8 * 2 + 2 * (4 * 2 * 128)
    assert tensor_bytes(torch.ones(3, 1).expand(3, 5)) == 12


def test_peak_bytes_of_known_allocations():
    c = StepCounter()
    with FakeTensorMode():
        kept = torch.empty(250)                       # 1,000 bytes, tracked
        assert c.track([kept]) == 1000
        with c:
            a = torch.empty(1000)                     # live 5,000
            b = torch.empty(2000, dtype=torch.float64)  # live 21,000
            v = b.view(4, 500)                        # no new storage
            del a                                     # live 17,000
            e = torch.empty(500, dtype=torch.int8)    # live 17,500
            del b, v                                  # live 1,500
            f = torch.empty(5000)                     # live 21,500
        got = c.result()
        assert c.live_bytes == 21_500
        del e, f
    assert got["peak_bytes"] == 21_500
    assert got["tracked_bytes"] == 1000
    assert c.live_bytes == 1000


_COLLECTIVE = r"""
import json
import torch
import torch.distributed as dist
from repro_torch.launch.dryrun import start_fake_group
from repro_torch.roofline.dispatch import count
start_fake_group(16)
d = 1000
x = torch.zeros(d)
node = dist.new_group(list(range(8)))
out = {}
_, out["world"] = count(dist.all_reduce, x)
_, out["node"] = count(lambda t: dist.all_reduce(t, group=node), x)
_, out["gather"] = count(dist.all_gather_into_tensor, torch.zeros(16 * d), x)
_, out["scatter"] = count(dist.reduce_scatter_tensor, x, torch.zeros(16 * d))
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def collectives():
    out = subprocess.run([sys.executable, "-c", _COLLECTIVE],
                         capture_output=True, text=True, timeout=120,
                         env=_env({}))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_all_reduce_counts_its_bytes_per_link(collectives):
    d = 1000
    w, n = collectives["world"], collectives["node"]
    assert w["collective_bytes_per_device"] == 4 * d
    assert w["collective_breakdown"]["all-reduce"] == 4 * d
    assert w["collective_counts"]["all-reduce"] == 1
    assert w["collective_link_bytes"] == {"nvlink": 0.0, "nic": 4.0 * d}
    assert n["collective_link_bytes"] == {"nvlink": 4.0 * d, "nic": 0.0}
    g, s = collectives["gather"], collectives["scatter"]
    assert g["collective_breakdown"]["all-gather"] == 16 * 4 * d
    assert s["collective_breakdown"]["reduce-scatter"] == 16 * 4 * d
    assert g["collective_counts"]["all-gather"] == 1
    assert s["collective_counts"]["reduce-scatter"] == 1


# ---------------------------------------------------------------------------
# a sharded train step's FLOPs against the reference's HLO
# ---------------------------------------------------------------------------

_REF_FLOPS = r"""
import json
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch import steps
from repro.roofline import analyze_hlo
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
cfg = get_config("qwen2.5-32b", reduced_variant=True)
b = steps.make_train_step(cfg, InputShape("t", 64, 8, "train"), mesh,
                          n_micro=2)
with mesh:
    c = jax.jit(b.fn, in_shardings=b.in_shardings,
                out_shardings=b.out_shardings).lower(*b.input_specs).compile()
print(json.dumps(analyze_hlo(c.as_text())["flops_per_device"]))
"""

_PORT_FLOPS = r"""
import json
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import InputShape, get_config
from repro_torch.launch import dryrun, mesh as mesh_lib, steps
dryrun.start_fake_group(2)
mesh = mesh_lib.make_mesh((2, 1), ("data", "model"), "cpu")
cfg = get_config("qwen2.5-32b", reduced_variant=True)
shape = InputShape("t", 64, 8, "train")
with FakeTensorMode():
    b = steps.make_train_step(cfg, shape, mesh, n_micro=2,
                              kernel_mode="kernel", device="cpu")
    parsed, _ = dryrun.trace_step(
        b.fn, dryrun.step_inputs(b, cfg, shape, mesh, "cpu"))
print(json.dumps(parsed["flops_per_device"]))
"""


def test_sharded_step_flops_against_the_reference_hlo():
    ref_p = subprocess.Popen(
        [sys.executable, "-c", _REF_FLOPS], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env({"XLA_FLAGS": "--xla_force_host_platform_device_count=2"}))
    port_p = subprocess.Popen(
        [sys.executable, "-c", _PORT_FLOPS], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env({}))
    outs = []
    for p in (ref_p, port_p):
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    want, got = outs
    assert got == pytest.approx(want, rel=0.10)


# ---------------------------------------------------------------------------
# the kernels' custom ops under fake tensors
# ---------------------------------------------------------------------------

def _same_meta(fake, plain):
    assert len(fake) == len(plain)
    for f, p in zip(fake, plain):
        if p is None:
            assert f is None
            continue
        assert tuple(f.shape) == tuple(p.shape), (f.shape, p.shape)
        assert f.dtype == p.dtype


def test_custom_ops_fake_outputs_match_the_plain_versions():
    d, k, n = 4096, 64, 5
    g = torch.randn(d)
    before = (fairk_update.LAUNCHES, sign_mv.SIGN_MV_LAUNCHES,
              sign_mv.SIGN_FROM_ENERGY_LAUNCHES, aou_merge.LAUNCHES,
              block_topk.LAUNCHES)
    inputs = {"g": g, "gp": torch.randn(d), "age": torch.rand(d) * 5,
              "res": torch.randn(d), "mask": (torch.rand(d) < 0.1).float(),
              "votes": torch.randn(n, k), "noise": torch.randn(k),
              "x": torch.randn(n, d), "idx": torch.arange(0, d, d // k),
              "row": torch.rand(n), "fresh": torch.randn(k),
              "cnt": torch.zeros(d)}

    def calls(mode, t):
        return {
            "fairk_stats": ops.fairk_stats_update(
                t["g"], t["gp"], t["age"], 0.5, 3.0, residual=t["res"],
                mode=mode),
            "fairk": ops.fairk_ef_update(t["g"], t["gp"], t["age"], 0.5,
                                         3.0, mode=mode),
            "sign_mv": ops.sign_mv(t["votes"], t["noise"], mode=mode),
            "fold": (ops.vote_fold(torch.zeros(k, device=t["g"].device),
                                   t["x"], t["idx"], mode=mode,
                                   row=t["row"]),),
            "energy": ops.sign_from_energy(t["noise"], z=t["noise"],
                                           noise_std=0.5, score=True,
                                           mode=mode),
            "merge": ops.aou_merge(t["g"], t["gp"], t["age"], t["mask"],
                                   mode=mode),
            "by_indices": ops.aou_merge_by_indices(
                t["idx"], t["fresh"], t["gp"], t["age"], t["cnt"],
                n_clients=4, ef_sum=t["res"], mode=mode),
            "masked": ops.masked_merge_by_indices(
                t["idx"], t["g"], t["gp"], t["age"], score=t["res"],
                mode=mode),
            "topk": ops.block_topk(t["g"], 1024, 16, mode=mode),
        }
    plain = calls("plain", inputs)
    with FakeTensorMode() as fm:
        fake_in = {k_: fm.from_tensor(v) for k_, v in inputs.items()}
        counter = StepCounter()
        with counter:
            fake = calls("kernel", fake_in)
        got = counter.result()
    for name in plain:
        p, f = plain[name], fake[name]
        if name == "fairk_stats":
            _same_meta(f[:3], p[:3])
            _same_meta([f[3][s] for s in sorted(p[3])],
                       [p[3][s] for s in sorted(p[3])])
        else:
            _same_meta(f, p)
    after = (fairk_update.LAUNCHES, sign_mv.SIGN_MV_LAUNCHES,
             sign_mv.SIGN_FROM_ENERGY_LAUNCHES, aou_merge.LAUNCHES,
             block_topk.LAUNCHES)
    assert after == before
    # each kernel call is one named operation to a dispatch mode
    assert got["ops"]["repro_torch.fairk_update"] == 2
    assert got["ops"]["repro_torch.sign_mv"] == 1
    assert got["ops"]["repro_torch.vote_fold"] == 1
    assert got["ops"]["repro_torch.sign_from_energy"] == 1
    assert got["ops"]["repro_torch.aou_merge"] == 1
    assert got["ops"]["repro_torch.merge_by_indices"] == 2
    assert got["ops"]["repro_torch.block_topk"] == 1


def test_kernel_mode_refuses_real_cpu_tensors_but_takes_fake_ones():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.resolve_mode("kernel", x)
    with FakeTensorMode() as fm:
        assert ops.resolve_mode("kernel", fm.from_tensor(x)) == "kernel"
        assert ops.resolve_mode(None, fm.from_tensor(x)) == "plain"
