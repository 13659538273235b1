"""What one rank holds at the peak of a train step's dry run: the peak
bytes, where in the step it falls, and the largest storages alive then,
each with its dtype, shape and the operation that made it.

The step is ``repro_torch.launch.dryrun``'s (a fake group of 256 ranks,
512 with ``--multi-pod``; fake CPU tensors), at the architecture's full
width with its depth cut to ``--layers``.  Run it against another
checkout by putting that checkout's ``src`` first on ``PYTHONPATH``.

Usage:
  PYTHONPATH=src python tools/torch_dryrun_peak.py --arch deepseek-67b --layers 24 [--multi-pod] [--top 8]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import dispatch


class PeakCounter(dispatch.StepCounter):
    """A ``StepCounter`` that notes, each time the peak rises, the largest
    storages alive and the operation count."""

    def __init__(self, top: int):
        super().__init__()
        self.top = top
        self.made = {}
        self.op = "input"
        self.at_peak = []
        self.peak_op = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.op = func.overloadpacket.__name__
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _alive(self, t):
        added = super()._alive(t)
        if added:
            self.made[t.untyped_storage()._cdata] = (
                added, str(t.dtype).replace("torch.", ""), list(t.shape),
                self.op)
            if self.live_bytes == self.peak_bytes:
                self.peak_op = self.n_ops
                self.at_peak = sorted(
                    (self.made[k] for k in self.live if k in self.made),
                    reverse=True)[:self.top]
        return added


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-67b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    dryrun.start_fake_group(512 if args.multi_pod else 256)
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    shape = SHAPES[args.shape]
    mesh = make_production_mesh(multi_pod=args.multi_pod, device_type="cpu")
    dev = torch.device("cpu")
    with FakeTensorMode():
        bundle = dryrun.make_step(cfg, shape, mesh, device=dev)
        inputs = dryrun.step_inputs(bundle, cfg, shape, mesh, dev)
        counter = PeakCounter(args.top)
        counter.track(inputs)
        with counter:
            bundle.fn(*inputs)
    gib = 2 ** 30
    out = {"arch": args.arch, "layers": args.layers,
           "mesh": "2x16x16" if args.multi_pod else "16x16",
           "peak_gib": counter.peak_bytes / gib,
           "inputs_gib": counter.tracked_bytes / gib,
           "peak_at_op": counter.peak_op, "ops": counter.n_ops,
           "largest_at_peak": [
               {"gib": n / gib, "dtype": d, "shape": s, "made_by": o}
               for n, d, s, o in counter.at_peak]}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
