"""Kernel micro-benchmarks through the PyTorch port (the twin of
``benchmarks/kernels_bench.py``): the five CUDA kernels, the two-stage
top-k and ``torch.topk`` as the baseline, at d = 2^20 (fast) or 2^24
(full).

On the card every kernel row is first held bit for bit against its plain
PyTorch version (``kernels/ref.py``) on the same inputs, then timed with
``torch_timing.time_ms``: calls captured in one CUDA graph and replayed
between CUDA events (device µs), beside the plain version's device µs,
the bound (``torch_timing.bound_ms``: the bytes each call must move over
3.35 TB/s, or its operations over 67 TFLOP/s) and, where one PyTorch
call computes the same function, that call's µs.  The calls cycle
through ``torch_timing.input_sets`` copies of their inputs (clones on
the device), together twice the 50 MB L2, so every call reads its inputs
from HBM, as the bound assumes.  The rows:

- ``fairk_update`` — ``ops.fairk_stats_update`` [stats], (d,) float32;
- ``sign_mv`` — the majority vote over (10, d) ±1 votes;
- ``sign_from_energy`` — (d,) energies with noise 2·z and the score;
- ``aou_merge`` — the mask form on (d,) float32;
- ``block_topk`` — per-block top-16 of |x| in blocks of 4,096
  (library: ``torch.topk`` on the (d/4096, 4096) rows);
- ``two_stage_topk`` — k = d/100 (library: ``torch.topk(|x|, k)``);
- ``exact_topk_baseline`` — ``torch.topk(|x|, d/100)`` alone.

Each kernel also has a ``<name>_plain`` row: the plain version's µs on the
device it ran on (the only rows timed on the CPU, with the host clock).
On the CPU the kernel rows report as skipped: a plain version is never
reported under a kernel's name.

  PYTHONPATH=src python -m benchmarks.torch_run --only kernels [--full]
      [--device cpu]
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict, List, Tuple

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks import torch_timing as tt  # noqa: E402
from benchmarks.torch_common import timed  # noqa: E402
from repro_torch.device import DeviceLike, resolve_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

N_VOTES = 10                             # the chunk fold's clients


def _inputs(d: int, dev) -> Dict[str, torch.Tensor]:
    """The rows' inputs at d, from a numpy generator seeded 0."""
    rng = np.random.default_rng(0)
    arrays = {
        "x": rng.normal(size=d).astype("f4"),
        "g_old": rng.normal(size=d).astype("f4"),
        "age": rng.integers(0, 40, d).astype("f4"),
        "mask": (rng.random(d) < 0.1).astype("f4"),
        "votes": np.sign(rng.normal(size=(N_VOTES, d))).astype("f4"),
        "energy": 2.0 * rng.integers(-5, 6, size=d).astype("f4"),
        "z": rng.normal(size=d).astype("f4"),
    }
    inp = {key: torch.as_tensor(a, device=dev) for key, a in arrays.items()}
    inp["tm"] = torch.quantile(inp["x"].abs()[:1 << 20], 0.9).reshape(())
    inp["ta"] = torch.tensor(30.5, device=dev)
    inp["absx"] = inp["x"].abs()
    return inp


def _cases(inp: Dict[str, torch.Tensor]
           ) -> Dict[str, Tuple[Callable, int, int, Callable]]:
    """name -> (call(mode), bytes, operations, library call or None) on
    the inputs ``inp``."""
    x, g_old, age, mask, votes, energy, z, tm, ta, absx = (
        inp[key] for key in ("x", "g_old", "age", "mask", "votes", "energy",
                             "z", "tm", "ta", "absx"))
    d = x.numel()
    k = d // 100
    nb = d // 4096
    return {
        "fairk_update": (
            lambda mode: ops.fairk_stats_update(x, g_old, age, tm, ta,
                                                mode=mode),
            4 * d * 5 + 4 * 258 + 8, 12 * d, None),
        "sign_mv": (lambda mode: ops.sign_mv(votes, mode=mode),
                    4 * N_VOTES * d + 8 * d, 2 * N_VOTES * d, None),
        "sign_from_energy": (
            lambda mode: ops.sign_from_energy(energy, z=z, noise_std=2.0,
                                              score=True, mode=mode),
            20 * d, 8 * d, None),
        "aou_merge": (lambda mode: ops.aou_merge(x, g_old, age, mask,
                                                 mode=mode),
                      24 * d, 7 * d, None),
        "block_topk": (lambda mode: ops.block_topk(x, 4096, 16, mode=mode),
                       4 * d + 8 * nb * 16, 2 * d,
                       lambda: torch.topk(absx.view(-1, 4096), 16, dim=1)),
        "two_stage_topk": (lambda mode: ops.two_stage_topk(x, k, mode=mode),
                           4 * d + 8 * k, 2 * d,
                           lambda: torch.topk(absx, k)),
    }


def _flat(out) -> List[torch.Tensor]:
    if isinstance(out, dict):
        return [v for key in sorted(out) for v in _flat(out[key])]
    if isinstance(out, (tuple, list)):
        return [v for o in out for v in _flat(o)]
    return [out] if isinstance(out, torch.Tensor) else []


def run(fast: bool = True, device: DeviceLike = None):
    """Rows ``(name, µs, derived)`` and the detail dict (µs per call)."""
    dev = resolve_device(device)
    d = 1 << 20 if fast else 1 << 24
    blocks = 20 if fast else 10
    cuda = dev.type == "cuda"
    rows, detail = [], {"d": d, "device": str(dev)}
    inp = _inputs(d, dev)
    cases = _cases(inp)
    # on the card, copies of the inputs that keep each call out of L2
    sets = [cases] + [
        _cases({key: v.clone() for key, v in inp.items()}) for _ in range(
            1, max(tt.input_sets(c[1]) for c in cases.values()) if cuda
            else 1)]
    for name, (call, n_bytes, n_ops, library) in cases.items():
        info = {}
        if cuda:
            for a, b in zip(_flat(call("kernel")), _flat(call("plain"))):
                tt.same(a, b, f"{name} kernel vs plain")
            copies = [c[name] for c in sets[:tt.input_sets(n_bytes)]]

            def each(mode):
                return [lambda c=c: c[0](mode) for c in copies]
            ms, eager = tt.time_ms(each("kernel"), blocks=blocks)
            plain_ms = tt.time_ms(each("plain"), blocks=blocks)[0]
            bound, by = tt.bound_ms(n_bytes, n_ops)
            lib_ms = (tt.time_ms([c[3] for c in copies], blocks=blocks)[0]
                      if library is not None else None)
            info = {"us": ms * 1e3, "eager_us": eager * 1e3,
                    "plain_us": plain_ms * 1e3, "bound_us": bound * 1e3,
                    "bound_by": by, "bytes": n_bytes,
                    "input_sets": len(copies),
                    "library_us": (lib_ms * 1e3 if lib_ms is not None
                                   else None),
                    "kernel_vs_plain": "identical"}
            rows.append((f"kernels/{name}", info["us"],
                         f"d={d};bound_us={info['bound_us']:.3f};"
                         f"plain_us={info['plain_us']:.3f};"
                         f"library_us={info['library_us']}"))
            rows.append((f"kernels/{name}_plain", info["plain_us"],
                         f"d={d}"))
        else:
            us, _ = timed(lambda: call("plain"))
            info = {"plain_us": us, "us": None,
                    "skipped": "no card: the CUDA kernel did not run"}
            rows.append((f"kernels/{name}", float("nan"),
                         "skipped=no card"))
            rows.append((f"kernels/{name}_plain", us, f"d={d}"))
        detail[name] = info
    # the exact top-k alone, as in the reference: two_stage_topk's
    # library call
    if cuda:
        copies = sets[:tt.input_sets(cases["two_stage_topk"][1])]
        us = tt.time_ms([c["two_stage_topk"][3] for c in copies],
                        blocks=blocks)[0] * 1e3
    else:
        us, _ = timed(cases["two_stage_topk"][3])
    detail["exact_topk_baseline"] = {"us": us}
    rows.append(("kernels/exact_topk_baseline", us, f"k={d // 100}"))
    return rows, detail
