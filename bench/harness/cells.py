"""A cell's run: the port's train step built once, driven from the seed
through its first rounds (the rounds the reference follows, and the
warm-up of every shape the window uses), then the measured window on
that same object, then the readings the comparison takes.

Two kinds of cell, named by the workload file's ``kind``:

* ``train``: a round is ``grads_fn`` over the round's batch (drawn from
  the seed, every round's different) and ``update`` — what
  ``make_train_step(...).fn`` runs;
* ``update``: a round is ``update`` alone, on a pool of gradient trees
  drawn in set-up and taken in turn — the edge server's round.

On the card every round records CUDA events at its phases' ends; the
window is timed by the host clock and closed by one synchronize."""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Dict, List

import torch

from bench.harness import inputs
from bench.reference import tree
from bench.reference.follow import family, rounds, step_seed


class _Mark:
    """A point on the device's stream (a CUDA event), or on the host clock
    where there is no card (CPU rehearsals only)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record()
        else:
            self.t = time.perf_counter()

    def ms_since(self, other: "_Mark") -> float:
        if self.cuda:
            return other.ev.elapsed_time(self.ev)
        return (self.t - other.t) * 1e3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _norms(ts: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(t.float(),
                                                 dtype=torch.float64)
                        for t in ts])


class Cell:
    """The program under test, its state and its rounds."""

    def __init__(self, config: Dict[str, Any], wl: Dict[str, Any],
                 seed: int, device: torch.device):
        from repro_torch.configs.base import InputShape, ModelConfig
        from repro_torch.launch import steps
        from repro_torch.optim import make_optimizer
        self.wl, self.seed, self.device = wl, seed, device
        self.model = config["model"]
        cfg = ModelConfig(**self.model)
        spec = family(config).param_spec(self.model)
        self.params = inputs.weights(spec, seed, device,
                                     getattr(torch, self.model["param_dtype"]))
        _check_tree(self.params, steps.abstract_params(cfg))
        oac = steps.OacServerConfig(**wl["oac"])
        train = wl["kind"] == "train"
        shape = (InputShape(wl["name"], wl["seq_len"], wl["batch"], "train")
                 if train else InputShape(wl["name"], 1, 1, "train"))
        self.kern = steps.make_train_step(
            cfg, shape, n_micro=wl.get("n_micro", 1), oac=oac, lr=wl["lr"],
            device=device)
        self.opt_state = make_optimizer(self.kern.meta["optimizer"],
                                        wl["lr"]).init(self.params)
        self.server = steps.init_server_state(self.params, oac=oac)
        self.d_packed = self.kern.layout.d_packed
        if not train:
            self.pool = [inputs.grad_tree(spec, wl["grad_rms"], seed, i,
                                          device)
                         for i in range(wl["pool"])]
        self.followed = rounds(wl)
        self.traced = False
        self.losses: List[torch.Tensor] = []
        self.marks: List[Dict[str, _Mark]] = []

    def span(self, name: str):
        return (torch.profiler.record_function(f"bench.{name}")
                if self.traced else contextlib.nullcontext())

    def round(self, t: int) -> None:
        """Round ``t``: what ``make_train_step(...).fn`` runs, phase by
        phase, or the update alone."""
        marks = {"start": _Mark(self.device)}
        if self.wl["kind"] == "train":
            with self.span("stage_batch"):
                batch = inputs.train_batch(self.model, self.wl, self.seed, t,
                                           self.device)
            marks["staged"] = _Mark(self.device)
            with self.span("grads_fn"):
                loss, grads = self.kern.grads_fn(self.params, batch)
            marks["grads"] = _Mark(self.device)
            self.losses.append(loss)
        else:
            grads = self.pool[t % self.wl["pool"]]
        with self.span("update"):
            self.kern.update(self.params, self.opt_state, self.server, grads,
                             step_seed(self.seed, t))
        marks["end"] = _Mark(self.device)
        self.marks.append(marks)

    def carried(self) -> Dict[str, float]:
        """The port's carried threshold state (``packing``'s
        ``THRESHOLD_STATE_FIELDS``, the head of the ``theta`` vector)."""
        vec = self.server["theta"][:6].tolist()
        return dict(zip(("theta_m", "theta_a", "n_sel_m", "n_sel", "init",
                         "streak"), vec))

    def first_rounds(self) -> Dict[str, Any]:
        """The rounds the reference follows, and their readings."""
        p0 = [p.clone() for _, p in tree.leaves(self.params)]
        for t in range(self.followed):
            self.round(t)
            if t == 0:
                m1 = _norms([m for _, m in tree.leaves(self.opt_state["m"])])
        change = _norms([p - q for (_, p), q in
                         zip(tree.leaves(self.params), p0)])
        del p0
        srv = self.server
        out = {"loss": [float(x) for x in self.losses],
               "m1": m1.tolist(), "change": change.tolist(),
               "age": srv["age"].clone(), "g": srv["g"].clone(),
               "res": srv["res"].clone() if "res" in srv else None,
               "carried": self.carried(), "d_packed": self.d_packed}
        self.losses.clear()
        self.marks.clear()
        return out

    def window(self, seconds: float) -> Dict[str, Any]:
        """Rounds until ``seconds`` have passed on the host clock, then one
        synchronize: (rounds, seconds, the phase times)."""
        _sync(self.device)
        t = self.followed
        streak0 = self.carried()["streak"]
        with self.span("window"):
            begin = _Mark(self.device)
            t0 = time.perf_counter()
            while True:
                self.round(t)
                t += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            _sync(self.device)
            wall = time.perf_counter() - t0
        ends = [begin] + [m["end"] for m in self.marks]
        phases = {"round_ms": [b.ms_since(a) for a, b in
                               zip(ends[:-1], ends[1:])]}
        if self.wl["kind"] == "train":
            phases["grads_ms"] = [m["grads"].ms_since(m["staged"])
                                  for m in self.marks]
            phases["update_ms"] = [m["end"].ms_since(m["grads"])
                                   for m in self.marks]
        else:
            phases["update_ms"] = [m["end"].ms_since(m["start"])
                                   for m in self.marks]
        failed = 0
        if self.losses:
            failed = int((~torch.isfinite(torch.stack(self.losses))).sum())
        elif not all(bool(torch.isfinite(p).all())
                     for _, p in tree.leaves(self.params)):
            failed = len(self.marks)
        # a round whose streak did not advance left the warm path (its
        # predecessor selected off the budget, or its prediction disagreed)
        stalls = streak0 + (t - self.followed) - self.carried()["streak"]
        return {"rounds": t - self.followed, "window_s": wall,
                "failed": failed, "stalls": stalls, **phases}

    def close(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("kern", "params", "opt_state", "server", "pool",
                     "losses", "marks"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _check_tree(made: Any, port: Any) -> None:
    """The benchmark's parameter tree has the port's paths, shapes and
    dtypes."""
    a = [(p, tuple(x.shape), x.dtype) for p, x in tree.leaves(made)]
    b = [(p, tuple(x.shape), x.dtype) for p, x in tree.leaves(port)]
    if a != b:
        raise ValueError(f"the configuration's parameter tree differs from "
                         f"the port's: {sorted(set(a) ^ set(b))[:4]}")


def trace_window(cell: Cell, seconds: float) -> Dict[str, Any]:
    """The window under ``torch.profiler`` (kept in memory), reduced to
    the trace summary and, under its ``"spans"``, the program's spans."""
    from torch.profiler import ProfilerActivity, profile
    from bench.harness import trace
    acts = [ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    cell.traced = True
    with profile(activities=acts) as prof:
        out = cell.window(seconds)
    cell.traced = False
    out["trace"] = trace.summarize(prof)
    return out
