"""The port's spans (``repro_torch.tracing``) and the benchmark's
reduction of them (``bench/harness/spans.py``), on the CPU.

* With no profiler session, ``span`` hands back one shared null context
  and the collection hook records nothing.
* One small train step of an attention configuration (the one-bit
  route) and of a Mamba-2 configuration gives bit-identical parameters,
  optimizer and server state with and without a session around it; under
  a session it emits every span its configuration reaches, nested as
  ``repro_torch.tracing`` documents, and a forced collection is a
  ``host.gc2`` span.
* The reduction on synthetic events: correlation to the launch, the
  innermost span, a backward operation linked by its sequence number, a
  recompute, idle time under a collection, launch counts, and one owner
  per device operation.
* The port's spans leave no mirror on the device's timeline, so the
  benchmark's trace reader reads the same busy time, device operations
  and kernels with them as without them.
"""

import dataclasses
import gc
import os
import sys

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.join(os.path.dirname(__file__), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench.harness import spans, trace  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

SEQ, BATCH, N_MICRO = 32, 2, 2

# (architecture, the server route): an attention stack on the one-bit
# route with EF, and the SSD stack on route (i)
STEPS = {
    "attention": ("internvl2-1b",
                  dict(one_bit=True, error_feedback=True, noise_std=0.5)),
    "mamba2": ("mamba2-370m", dict(fused_stats=True)),
}

STEP_SPANS = {"step.grads", "step.micro", "step.forward", "step.backward",
              "step.accumulate", "step.update", "server.pack",
              "server.select", "server.carry", "server.unpack",
              "optim.apply", "model.logits", "model.loss"}
MIXER_SPANS = {"attention": {"model.attention", "server.vote"},
               "mamba2": {"model.ssd", "model.ssd.link"}}

# each span's possible parents (the innermost span around it on its
# thread; the CPU runs the backward pass on the calling thread)
PARENTS = {
    "step.grads": {None},
    "step.micro": {"step.grads"},
    "step.forward": {"step.micro"},
    "step.backward": {"step.micro"},
    "step.accumulate": {"step.micro", "step.grads"},
    "model.attention": {"step.forward", "step.backward"},
    "model.ssd": {"step.forward", "step.backward"},
    "model.ssd.link": {"model.ssd"},
    "model.logits": {"step.forward"},
    "model.loss": {"step.forward"},
    "step.update": {None},
    "server.pack": {"step.update"},
    "server.vote": {"step.update"},
    "server.select": {"step.update"},
    "server.carry": {"step.update"},
    "server.unpack": {"step.update"},
    "optim.apply": {"step.update"},
}


def _step(kind):
    arch, oac_kw = STEPS[kind]
    cfg = dataclasses.replace(get_config(arch, reduced_variant=True),
                              compute_dtype="float32")
    oac = steps.OacServerConfig(**oac_kw)
    bundle = steps.make_train_step(
        cfg, InputShape("custom", SEQ, BATCH, "train"), n_micro=N_MICRO,
        oac=oac, device="cpu")
    params = steps.tr.init_lm(torch.Generator().manual_seed(0), cfg)
    opt = make_optimizer(bundle.meta["optimizer"], 1e-3)
    state = {"params": params, "opt": opt.init(params),
             "server": steps.init_server_state(params, oac=oac)}
    batch = train.make_batch(cfg, 0, 0, BATCH, SEQ - (cfg.n_patches or 0),
                             N_MICRO, "cpu")
    return bundle, state, batch


def _run(bundle, state, batch):
    bundle.fn(state["params"], state["opt"], state["server"], batch, 7)


def _leaves(state):
    return [x for _, x in tree_util.leaves(state) if torch.is_tensor(x)]


def _program_spans(prof):
    return [(e.start_ns(), e.end_ns(), e.name()[len(tracing.PREFIX):],
             e.start_thread_id(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(tracing.PREFIX)]


# --- (a) off ---------------------------------------------------------------

def test_span_without_a_session_is_the_shared_null_context():
    assert tracing.span("step.grads") is tracing.span("model.loss")
    with tracing.span("step.grads") as got:
        assert got is None
    assert tracing.GC_HOOK in gc.callbacks


def test_gc_hook_records_nothing_without_a_session(monkeypatch):
    made = []

    class Counted:
        def __init__(self, name):
            made.append(name)

        def __enter__(self):
            return None

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(tracing, "_RecordFunctionFast", Counted)
    gc.collect(1)
    gc.collect()
    assert made == []
    assert getattr(tracing.GC_HOOK._open, "stack", []) == []
    with profile(activities=[ProfilerActivity.CPU]):
        gc.collect(1)
        gc.collect(0)
        gc.collect()
    # the forced collections, and perhaps some the session's own
    # allocations set off: never one of generation 0
    assert {"repro_torch.host.gc1", "repro_torch.host.gc2"} <= set(made)
    assert set(made) <= {"repro_torch.host.gc1", "repro_torch.host.gc2"}
    assert getattr(tracing.GC_HOOK._open, "stack", []) == []
    monkeypatch.undo()
    # a session started afterwards holds no collection from before it
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(1)
    assert not [s for s in _program_spans(prof) if s[2].startswith("host.")]


# --- (b) on and off give the same state ------------------------------------

@pytest.mark.parametrize("kind", sorted(STEPS))
def test_a_session_changes_no_state(kind):
    bundle, plain, batch = _step(kind)
    _run(bundle, plain, batch)
    bundle, traced, batch = _step(kind)
    with profile(activities=[ProfilerActivity.CPU]):
        _run(bundle, traced, batch)
    a, b = _leaves(plain), _leaves(traced)
    assert len(a) == len(b) and len(a) > 10
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


# --- (c) the spans a step emits --------------------------------------------

def _parent(s, same_thread):
    """The innermost span around ``s`` on its thread (None: none)."""
    best = None
    for o in same_thread:
        if o is s or not (o[0] <= s[0] and s[1] <= o[1]):
            continue
        if best is None or o[0] >= best[0]:
            best = o
    return best[2] if best is not None else None


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_step_emits_its_spans_nested(kind):
    bundle, state, batch = _step(kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(bundle, state, batch)
        gc.collect()
    found = _program_spans(prof)
    names = {s[2] for s in found}
    want = STEP_SPANS | MIXER_SPANS[kind]
    assert want <= names
    other = MIXER_SPANS["mamba2" if kind == "attention" else "attention"]
    assert not (names & other)
    assert "host.gc2" in names
    # function scope: no user annotation, so no mirror on a device's
    # timeline
    assert not any(s[4] for s in found)
    for s in found:
        if s[2].startswith("host."):
            continue
        thread = [o for o in found if o[3] == s[3]
                  and not o[2].startswith("host.")]
        assert _parent(s, thread) in PARENTS[s[2]], s[2]
    counts = {n: sum(s[2] == n for s in found) for n in names}
    assert counts["step.micro"] == N_MICRO
    assert counts["step.forward"] == counts["step.backward"] == N_MICRO
    assert counts["step.grads"] == counts["step.update"] == 1
    mixer = "model.attention" if kind == "attention" else "model.ssd"
    # every layer's mixer runs in the forward pass and in the recompute
    assert counts[mixer] % (2 * N_MICRO) == 0


def test_forced_collection_is_a_gc2_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        junk = [[i] for i in range(10_000)]
        gc.collect()
        del junk
    gcs = [s for s in _program_spans(prof) if s[2] == "host.gc2"]
    assert len(gcs) >= 1 and all(b > a for a, b, *_ in gcs)
    assert getattr(tracing.GC_HOOK._open, "stack", []) == []


# --- (d) the reduction on synthetic events ---------------------------------

MAIN, AUTOGRAD = 1, 2


def _host(a, b, name, tid=MAIN, corr=0, seq=-1, ftid=0):
    return (a, b, name, tid, corr, seq, ftid)


def _events():
    """One window: a forward attention op, its backward on the autograd
    thread, a recompute, a launch on the autograd thread outside any
    event, an update with a collection in it, and one launch in staging
    outside every span."""
    P = spans.PREFIX
    host = [
        _host(0.0, 100.0, "bench.window"),
        _host(0.2, 0.9, "bench.stage_batch"),
        _host(0.5, 0.5, "cudaLaunchKernel", corr=107),
        _host(1.0, 60.0, P + "step.grads"),
        _host(2.0, 20.0, P + "step.forward"),
        _host(3.0, 10.0, P + "model.attention"),
        _host(4.0, 5.5, "aten::mm", seq=5),
        _host(5.0, 5.1, "cudaLaunchKernel", corr=101),
        _host(11.0, 12.0, "aten::add", seq=6),
        _host(21.0, 50.0, P + "step.backward"),
        _host(22.0, 30.0, spans.BACKWARD + " MmBackward0", tid=AUTOGRAD,
              seq=5, ftid=MAIN),
        _host(23.0, 23.1, "cudaLaunchKernelExC", tid=AUTOGRAD, corr=102),
        _host(31.0, 40.0, spans.BACKWARD + " AddBackward0", tid=AUTOGRAD,
              seq=6, ftid=MAIN),
        _host(32.0, 36.0, P + "model.attention", tid=AUTOGRAD),
        _host(33.0, 33.1, "cudaLaunchKernel", tid=AUTOGRAD, corr=103),
        _host(41.0, 41.1, "cudaMemcpyAsync", tid=AUTOGRAD, corr=104),
        _host(61.0, 99.0, P + "step.update"),
        _host(62.0, 62.1, "cudaLaunchKernel", corr=105),
        _host(70.0, 90.0, P + "host.gc2"),
        _host(91.0, 91.1, "cudaLaunchKernel", corr=106),
        _host(92.0, 92.1, "cudaStreamIsCapturing", corr=999),
    ]
    device = [
        (0.6, 0.8, "fill", 107),
        (6.0, 8.0, "gemm", 101),
        (24.0, 27.0, "gemm_bwd", 102),
        (37.0, 39.0, "gemm", 103),
        (42.0, 43.0, "Memcpy DtoD", 104),
        (62.5, 70.0, "fairk_kernel", 105),
        (91.0, 95.0, "adam", 106),
    ]
    return device, host


def test_reduction_owns_each_operation_once():
    device, host = _events()
    out = spans.reduce(device, host)
    sp = {n[len(spans.PREFIX):]: v for n, v in out["spans"].items()}
    # forward, its backward (linked by the sequence number) and the
    # recompute all belong to the attention span
    assert sp["model.attention"]["own_s"] == pytest.approx(2 + 3 + 2)
    assert sp["model.attention"]["calls"] == 2
    assert sp["model.attention"]["launches"] == 3
    # the autograd thread's launch outside any event: the span open on
    # the main thread
    assert sp["step.backward"]["own_s"] == pytest.approx(1.0)
    # inclusive: the backward's and the recompute's operations count in
    # the backward span, not in the forward one
    assert sp["step.backward"]["incl_s"] == pytest.approx(3 + 2 + 1)
    assert sp["step.forward"]["incl_s"] == pytest.approx(2)
    assert sp["step.grads"]["incl_s"] == pytest.approx(2 + 3 + 2 + 1)
    assert sp["step.grads"]["incl_launches"] == 4
    assert sp["step.update"]["own_s"] == pytest.approx(7.5 + 4)
    assert sp["step.update"]["launches"] == 2
    # the staging launch has no span
    assert out["unowned_s"] == pytest.approx(0.2)
    assert out["unowned_at"] == {"bench.stage_batch": pytest.approx(0.2)}
    total = sum(b - a for a, b, _, _ in device)
    assert out["device_s"] == pytest.approx(total)
    owned = sum(v["own_s"] for v in out["spans"].values())
    assert owned + out["unowned_s"] == pytest.approx(total)
    # a runtime call that launched nothing is no launch
    assert out["launches"] == 7


def test_reduction_idle_under_a_collection():
    device, host = _events()
    out = spans.reduce(device, host)
    gc2 = out["spans"][spans.PREFIX + "host.gc2"]
    assert gc2["idle_s"] == pytest.approx(20.0)
    assert gc2["own_s"] == 0.0 and gc2["calls"] == 1
    assert gc2["host_s"] == pytest.approx(20.0)
    # the update's idle: 61-62.5, 70-91 and 95-99
    upd = out["spans"][spans.PREFIX + "step.update"]
    assert upd["idle_s"] == pytest.approx(1.5 + 21 + 4)
    # each gap's label: the innermost program span at its middle on any
    # thread (27-37: the recompute on the autograd thread, which opened
    # after the main thread's backward span), else the benchmark's span
    P = spans.PREFIX
    labels = {round(at, 6): lab for lab, _, at in out["long_gaps"]}
    assert labels == {0.0: "bench.stage_batch", 0.8: P + "model.attention",
                      8.0: P + "step.forward", 27.0: P + "model.attention",
                      39.0: P + "step.backward", 43.0: P + "step.grads",
                      70.0: P + "host.gc2", 95.0: P + "step.update"}
    assert out["idle_gaps"][0] == [P + "host.gc2", pytest.approx(21.0)]
    by = out["idle_by_label"]
    assert by[P + "model.attention"] == pytest.approx(5.2 + 10)
    # whose launch each gap waited for (the last gap ends the window)
    wait = {k[len(P):]: v["wait_s"] for k, v in out["spans"].items()}
    assert wait["model.attention"] == pytest.approx(5.2 + 16 + 10)
    assert wait["step.backward"] == pytest.approx(3)
    assert wait["step.update"] == pytest.approx(19.5 + 21)
    assert out["unowned_wait_s"] == pytest.approx(0.6)
    busy = sum(b - a for a, b in trace.merge([(d[0], d[1]) for d in device]))
    assert sum(by.values()) == pytest.approx(100.0 - busy)


def test_reduction_falls_back_where_the_link_finds_nothing():
    device, host = _events()
    # the backward node's forward op is missing: its launch falls to the
    # span open on any thread (the backward span on the main thread)
    host = [h for h in host if h[2] != "aten::mm"]
    sp = spans.reduce(device, host)["spans"]
    assert sp[spans.PREFIX + "model.attention"]["own_s"] == pytest.approx(4)
    assert sp[spans.PREFIX + "step.backward"]["own_s"] == pytest.approx(4)


def test_reduction_needs_a_window_and_device_operations():
    device, host = _events()
    assert spans.reduce(device, [h for h in host
                                 if h[2] != "bench.window"]) is None
    assert spans.reduce([], host) is None
    # operations wholly outside the window are no part of it
    late = [(200.0, 201.0, "gemm", 101)]
    assert spans.reduce(late, host) is None


# --- (e) the benchmark's trace reader does not see the port's spans --------

class _Ev:
    def __init__(self, a, b, name, dev, user=False, tid=MAIN, corr=0,
                 seq=-1, ftid=0):
        self._v = (a, b, name, dev, user, tid, corr, seq, ftid)

    def start_ns(self):
        return int(self._v[0] * 1e9)

    def end_ns(self):
        return int(self._v[1] * 1e9)

    def name(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def correlation_id(self):
        return self._v[6]

    def sequence_nr(self):
        return self._v[7]

    def fwd_thread_id(self):
        return self._v[8]


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _fake_events(with_spans):
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    evs = [_Ev(0.0, 10.0, "bench.window", cpu),
           _Ev(0.0, 10.0, "bench.window", cuda, user=True),
           _Ev(1.0, 9.0, "bench.grads_fn", cpu, user=True),
           _Ev(2.0, 8.5, "bench.grads_fn", cuda, user=True),
           _Ev(1.5, 1.6, "cudaLaunchKernel", cpu, corr=11),
           _Ev(2.0, 3.0, "gemm", cuda, corr=11),
           _Ev(6.0, 6.1, "cudaLaunchKernel", cpu, corr=12),
           _Ev(7.0, 8.5, "fairk_kernel", cuda, corr=12)]
    if with_spans:
        # the port's span: function scope on the host, no device mirror
        evs.append(_Ev(1.2, 8.0, "repro_torch.step.grads", cpu))
    return evs


def test_trace_reader_reads_the_same_with_the_ports_spans():
    old = trace.from_profiler(_Prof(_fake_events(False)))
    new = trace.from_profiler(_Prof(_fake_events(True)))
    for key in ("busy_s", "window_s", "device_ops", "kernels", "idle_gaps"):
        assert old[key] == new[key], key
    idle = 1 - new["busy_s"] / new["window_s"]
    assert idle == pytest.approx(1 - 2.5 / 10)
    got = spans.from_profiler(_Prof(_fake_events(True)))
    # the benchmark's own spans' device mirrors are no device operation
    assert got["device_s"] == pytest.approx(2.5)
    assert got["spans"]["repro_torch.step.grads"]["own_s"] == pytest.approx(
        2.5)
    assert sum(v for v, _ in new["kernels"].values()) == pytest.approx(
        got["device_s"])


def test_a_user_annotations_mirror_is_no_device_operation():
    evs = _fake_events(True) + [
        _Ev(2.0, 8.5, "repro_torch.user", DeviceType.CUDA, user=True)]
    got = spans.from_profiler(_Prof(evs))
    assert got["device_s"] == pytest.approx(2.5)
