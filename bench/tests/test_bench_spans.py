"""The traced run's span metrics and the round's FLOP count: each span
reader on a hand-built span reduction, and None without one; the trace
summary of a fixed set of synthetic profiler events, whose existing keys
read as before with the span reduction beside them; the FLOP count from a
reference module's ``active_params``, unchanged for the benchmark's own
configurations and None for a family that nothing counts."""

import json
import sys
import types
from pathlib import Path

import pytest
from torch.autograd import DeviceType

from bench import run
from bench.harness import spans, trace
from bench.harness.registry import Registry

ROOT = Path(__file__).resolve().parents[2]
P = spans.PREFIX
MAIN = 1


def read(name, ctx):
    return Registry(ROOT).reader(name)(ctx)


def _stat(own_s=0.0, idle_s=0.0, incl_launches=0):
    return {"own_s": own_s, "incl_s": own_s, "launches": 0,
            "incl_launches": incl_launches, "calls": 1, "host_s": 0.0,
            "idle_s": idle_s, "wait_s": 0.0}


# per span: (own s, idle s, inclusive launches) over a window of 4 rounds
SPANS = {"model.attention": (0.7, 0.01, 480),
         "model.ssd": (4.0, 0.3, 26000), "model.ssd.link": (0.2, 0.1, 19000),
         "model.logits": (0.8, 0.0, 32), "model.loss": (0.3, 0.0, 360),
         "server.pack": (0.007, 0.0, 4), "server.unpack": (0.0, 0.0, 0),
         "server.carry": (0.017, 0.0, 36), "optim.apply": (0.316, 0.002, 1784),
         "host.gc1": (0.0, 0.001, 0), "host.gc2": (0.0, 0.012, 0),
         "step.grads": (0.003, 0.07, 28000), "step.update": (0.0, 0.003, 2328)}
ROUNDS = 4


def _ctx(names=SPANS):
    red = {"spans": {P + n: _stat(*SPANS[n]) for n in names},
           "idle_by_label": {}, "launches": 30400}
    return {"rounds": ROUNDS, "trace": {"busy_s": 1.0, "window_s": 1.0,
                                        "spans": red}}


def _ms(*names, i=0):
    return pytest.approx(1e3 * sum(SPANS[n][i] for n in names) / ROUNDS)


READINGS = {
    "attention_ms": _ms("model.attention"),
    "ssd_ms": _ms("model.ssd", "model.ssd.link"),
    "head_loss_ms": _ms("model.logits", "model.loss"),
    "pack_ms": _ms("server.pack", "server.unpack", "server.carry"),
    "optim_ms": _ms("optim.apply"),
    "gc_idle_ms": _ms("host.gc1", "host.gc2", i=1),
    "launches_per_round": pytest.approx((28000 + 2328) / ROUNDS),
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_span_reader_reads_its_spans_per_round(name):
    assert read(name, _ctx()) == READINGS[name]
    # no trace, a trace without the span reduction, or a failed one
    for ctx in ({"rounds": ROUNDS, "trace": None},
                {"rounds": ROUNDS, "trace": {"busy_s": 1.0}},
                dict(_ctx(), trace={"busy_s": 1.0, "spans": None})):
        assert read(name, ctx) is None


@pytest.mark.parametrize("name", sorted(set(READINGS) - {"gc_idle_ms"}))
def test_span_reader_finds_nothing_where_its_spans_did_not_run(name):
    assert read(name, _ctx(names=["host.gc2"])) is None


def test_gc_idle_is_zero_without_a_collection():
    assert read("gc_idle_ms", _ctx(names=["optim.apply"])) == 0.0
    assert read("gc_idle_ms", _ctx(names=["host.gc2"])) == _ms(
        "host.gc2", i=1)


def test_the_manifest_lists_each_span_metric_where_its_spans_run():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in manifest["per_layer"]}
    train = ["internvl2-1b.train", "mamba2-370m.train"]
    cells = {"attention_ms": ["internvl2-1b.train"],
             "ssd_ms": ["mamba2-370m.train"], "head_loss_ms": train}
    for name in READINGS:
        m = entry[name]
        assert m["source"] == "device_trace" and m["moves"] == "round_ms"
        assert m["workloads"] == cells.get(
            name, train + ["internvl2-1b.update"])


# --- the trace summary from raw events ---------------------------------

class _Ev:
    def __init__(self, a, b, name, cuda=False, user=False, corr=0, seq=-1):
        self.v = (a, b, name, cuda, user, corr, seq)

    def start_ns(self):
        return int(round(self.v[0] * 1e9))

    def end_ns(self):
        return int(round(self.v[1] * 1e9))

    def name(self):
        return self.v[2]

    def device_type(self):
        return DeviceType.CUDA if self.v[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self.v[4]

    def start_thread_id(self):
        return MAIN

    def correlation_id(self):
        return self.v[5]

    def sequence_nr(self):
        return self.v[6]

    def fwd_thread_id(self):
        return 0


class _Prof:
    def __init__(self, events):
        results = types.SimpleNamespace(events=lambda: events)
        self.profiler = types.SimpleNamespace(kineto_results=results)


def _events():
    """One round of a window of 10 s: the benchmark's user-scope spans
    (mirrored on the device), the program's function-scope spans, four
    launches and their operations, and a collection while the device
    idles."""
    def launch(t, corr):
        return _Ev(t, t + 0.01, "cudaLaunchKernel", corr=corr)
    evs = []
    for a, b, name in ((0.0, 10.0, "bench.window"),
                       (1.0, 5.8, "bench.grads_fn"),
                       (6.0, 9.5, "bench.update")):
        evs += [_Ev(a, b, name, user=True),
                _Ev(a + 0.1, b, name, cuda=True, user=True)]
    evs += [_Ev(1.2, 5.5, P + "step.grads"),
            _Ev(1.4, 3.5, P + "model.attention"),
            launch(1.5, 11), _Ev(2.0, 3.0, "gemm", cuda=True, corr=11),
            launch(4.0, 12), _Ev(4.0, 4.5, "add", cuda=True, corr=12),
            _Ev(6.0, 9.0, P + "step.update"),
            _Ev(6.05, 6.15, P + "server.pack"),
            launch(6.1, 13), _Ev(6.2, 7.0, "fairk_kernel", cuda=True,
                                 corr=13),
            _Ev(7.0, 8.95, P + "optim.apply"),
            launch(7.1, 14), _Ev(7.2, 8.1, "adam", cuda=True, corr=14),
            _Ev(8.2, 8.7, P + "host.gc2")]
    return evs


def test_summary_keeps_its_readings_and_adds_the_spans():
    prof = _Prof(_events())
    old = trace.from_profiler(prof)
    new = trace.summarize(prof)
    assert set(new) == set(old) | {"spans"}
    for key in old:
        assert new[key] == old[key], key
    # the readings as the accepted reduction gives them
    assert new["window_s"] == pytest.approx(10.0)
    assert new["busy_s"] == pytest.approx(1.0 + 0.5 + 0.8 + 0.9)
    assert [n for n, _ in new["device_ops"]] == ["gemm", "adam",
                                                 "fairk_kernel", "add"]
    assert [s for _, s in new["device_ops"]] == pytest.approx(
        [1.0, 0.9, 0.8, 0.5])
    assert new["kernels"]["adam"] == (pytest.approx(0.9), 1)
    assert [n for n, _ in new["idle_gaps"]] == [
        "bench.grads_fn", "bench.update", "bench.grads_fn",
        "bench.grads_fn", "bench.update"]
    assert [s for _, s in new["idle_gaps"]] == pytest.approx(
        [2.0, 1.9, 1.7, 1.0, 0.2])
    assert new["spans"] == spans.from_profiler(prof)
    # the span readers over that summary, for two rounds
    ctx = {"rounds": 2, "trace": new}
    assert read("attention_ms", ctx) == pytest.approx(500.0)
    assert read("pack_ms", ctx) == pytest.approx(400.0)
    assert read("optim_ms", ctx) == pytest.approx(450.0)
    assert read("gc_idle_ms", ctx) == pytest.approx(250.0)
    assert read("launches_per_round", ctx) == 2.0
    assert read("ssd_ms", ctx) is None
    assert read("head_loss_ms", ctx) is None


def test_summary_is_none_without_a_window():
    evs = [e for e in _events() if e.name() != "bench.window"]
    assert trace.summarize(_Prof(evs)) is None


# --- the round's FLOPs ---------------------------------------------------

def _config(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name,traffic,flops", [
    ("internvl2-1b", "train_b8_s4096_m1", 123788322668544.0),
    ("mamba2-370m", "train_b8_s2048_m1", 36193337081856.0),
    ("internvl2-1b", "update_pool4_onebit_ef", 0.0)])
def test_the_benchmarks_configurations_keep_their_count(name, traffic,
                                                        flops):
    wl = json.loads((ROOT / "bench" / "traffic" / f"{traffic}.json")
                    .read_text())
    assert run.round_flops(_config(name), wl) == flops


def _port_model(name):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.asdict(get_config(name))


@pytest.fixture
def reference(monkeypatch):
    """A reference module ``bench.reference.<name>`` put in place for one
    test, with the functions given."""
    def put(name, **fns):
        mod = types.ModuleType(f"bench.reference.{name}")
        mod.__dict__.update(fns)
        monkeypatch.setitem(sys.modules, mod.__name__, mod)
        return name
    return put


def test_a_reference_modules_active_params_sets_the_count(reference):
    m = _port_model("granite-moe-3b-a800m")
    name = reference("moe_hook", active_params=lambda model: 800_000_000)
    wl = {"kind": "train", "batch": 2, "seq_len": 1024}
    flops = run.round_flops({"reference": name, "model": m}, wl)
    assert flops == 6.0 * 800_000_000 * 2048
    ctx = {"workload": wl, "flops_per_round": flops, "rounds": 3,
           "window_s": 10.0}
    assert read("mfu", ctx) == pytest.approx(
        100 * 3 * flops / 10.0 / 989e12)
    # a hook takes precedence over the yardstick's own count too
    dense = reference("dense_hook", active_params=lambda model: 7)
    assert run.round_flops(dict(_config("internvl2-1b"), reference=dense),
                           wl) == 6.0 * 7 * 2048


@pytest.mark.parametrize("port_name", ["granite-moe-3b-a800m",
                                       "jamba-1.5-large-398b"])
def test_an_uncounted_family_reads_no_flops(reference, port_name):
    m = _port_model(port_name)
    assert m["family"] in ("moe", "hybrid")
    name = reference("no_hook")
    wl = {"kind": "train", "batch": 8, "seq_len": 2048}
    flops = run.round_flops({"reference": name, "model": m}, wl)
    assert flops is None
    ctx = {"workload": wl, "flops_per_round": flops, "rounds": 3,
           "window_s": 10.0}
    assert read("mfu", ctx) is None
