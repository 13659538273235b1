"""Multi-pod dry run of the port: trace every (architecture × input shape)
on the production meshes, show what one rank holds and moves, and dump the
roofline artifacts (``repro.launch.dryrun`` for PyTorch).

A fake process group of 256 ranks (512 with ``--multi-pod``) stands in for
the cluster: this process is rank 0 — or, where a model's heads split over
``model`` in uneven runs (``parallel.head_range``), the first rank with the
longest run, whose step is the slowest (``traced_rank``) —,
``launch.mesh.make_production_mesh`` lays the mesh on it, and its
collectives return at once.  The step comes
from the same builders a user calls (``make_train_step`` with
``kernel_mode="kernel"``, ``make_prefill_step``, ``make_serve_step``,
``make_fl_oac_step``) and runs once on the rank's inputs under
``FakeTensorMode``, where tensors hold no memory, inside
``roofline.dispatch.StepCounter``: FLOPs by dtype, bytes, the collective
schedule and the peak of the bytes alive on the rank, then
``roofline.analysis.build_report``'s three terms for the H100.  Tensors are
fake CUDA tensors unless ``--device cpu`` asks for fake CPU ones; the
counts do not depend on it.  A combination that does not trace is an
error: the run exits 1 after the others.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--fl-mode] [--device cpu]
Artifacts land in benchmarks/artifacts/torch_dryrun/<arch>__<shape>__<mesh>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves

from repro_torch import tree as tree_util
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.launch.mesh import (MULTI_POD_AXES, MULTI_POD_SHAPE,
                                     PRODUCTION_AXES, PRODUCTION_SHAPE,
                                     AbstractMesh, make_production_mesh)
from repro_torch.launch.steps import (OacServerConfig, abstract_params,
                                      init_server_state, make_fl_oac_step,
                                      make_prefill_step, make_serve_step,
                                      make_train_step, train_input_specs)
from repro_torch.models import transformer as tr
from repro_torch.models.parallel import head_range, heads_split, tp_split
from repro_torch.optim import make_optimizer
from repro_torch.roofline import build_report, suggestion
from repro_torch.roofline.dispatch import count

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "benchmarks", "artifacts", "torch_dryrun")
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# the FL-OAC step's batch per rank (``make_fl_oac_step``'s defaults)
FL_LOCAL_BATCH, FL_SEQ_LEN = 1, 1024


def start_fake_group(world: int, rank: int = 0) -> None:
    """A ``fake`` process group of ``world`` ranks in this process, which
    is ``rank`` (its collectives do nothing); replaces one started
    before."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def traced_rank(cfg, multi_pod: bool = False) -> int:
    """The rank whose step the dry run traces: 0, or where "attn" splits
    over ``model`` in uneven runs of heads the first rank (``model``
    coordinate, the mesh's last axis; row-major ranks) with the most
    heads — the ranks' steps differ there only by their heads, and the
    slowest sets the step."""
    mesh = (AbstractMesh(MULTI_POD_SHAPE, MULTI_POD_AXES) if multi_pod
            else AbstractMesh(PRODUCTION_SHAPE, PRODUCTION_AXES))
    m = mesh.shape[-1]
    if ("attn" not in tp_split(cfg, mesh)
            or heads_split(cfg.n_heads, cfg.n_kv_heads, m)):
        return 0
    runs = [hi - lo for lo, hi in (head_range(cfg.n_heads, r, m)
                                   for r in range(m))]
    return runs.index(max(runs))


def make_step(cfg, shape, mesh, oac_packed: bool = True, device=None):
    if shape.kind == "train":
        return make_train_step(cfg, shape, mesh,
                               oac=OacServerConfig(packed=oac_packed),
                               kernel_mode="kernel", device=device)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, mesh)
    return make_serve_step(cfg, shape, mesh)


def _empty_tree(tree_abs: Any, specs: Any, mesh, device) -> Any:
    """The rank's blocks of ``tree_abs`` as uninitialised tensors."""
    pairs = tree_util.leaves(tree_abs)
    spec_l = sharding.spec_leaves(specs)
    return tree_util.unflatten(
        [pa for pa, _ in pairs],
        [torch.empty(sharding.local_shape(x.shape, sp, mesh), dtype=x.dtype,
                     device=device)
         for (_, x), sp in zip(pairs, spec_l)])


def step_inputs(bundle, cfg, shape, mesh, device, oac_packed: bool = True
                ) -> Tuple:
    """The rank's positional arguments of ``bundle.fn`` (call it under
    ``FakeTensorMode``): the rank's blocks of the parameters, optimizer
    and server state or caches, and the global batch."""
    kind = bundle.meta["kind"]
    if kind == "fl_oac":
        d, nb = bundle.meta["d"], bundle.meta["blocks"]
        f32 = dict(dtype=torch.float32, device=device)
        rows = (FL_LOCAL_BATCH, FL_SEQ_LEN)
        batch = {k: torch.zeros(rows, dtype=torch.int32, device=device)
                 for k in ("tokens", "labels")}
        return (torch.zeros(d, **f32), torch.zeros(d, **f32),
                torch.zeros(nb, **f32), batch, 0)
    p_specs = bundle.in_specs[0]
    params = _empty_tree(abstract_params(cfg), p_specs, mesh, device)
    if kind == "train":
        opt = make_optimizer(bundle.meta["optimizer"], bundle.meta["lr"])
        server = init_server_state(
            abstract_params(cfg), mesh, cfg,
            OacServerConfig(packed=oac_packed), local=True, device=device)
        specs = train_input_specs(cfg, shape, bundle.meta["n_micro"],
                                  bundle.meta["micro_batch"])
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in specs.items()}
        return params, opt.init(params), server, batch, 0
    gb = shape.global_batch
    if kind == "prefill":
        cache_abs = tr.cache_specs(cfg, gb, shape.seq_len)
    else:
        cache_abs = tr.cache_specs(cfg, gb, bundle.meta["capacity"],
                                   ring=bundle.meta["ring"])
    caches = _empty_tree(cache_abs, bundle.in_specs[1], mesh, device)
    if kind == "prefill":
        s_text = (shape.seq_len - cfg.n_patches if cfg.family == "vlm"
                  else shape.seq_len)
        cdt = getattr(torch, cfg.compute_dtype)
        batch = {"tokens": torch.zeros((gb, s_text), dtype=torch.int32,
                                       device=device)}
        if cfg.family == "vlm":
            batch["embeds"] = torch.zeros((gb, cfg.n_patches, cfg.d_model),
                                          dtype=cdt, device=device)
        if cfg.family == "audio":
            batch["frames"] = torch.zeros((gb, cfg.encoder_seq, cfg.d_model),
                                          dtype=cdt, device=device)
        return params, caches, batch
    token = torch.zeros((gb, 1), dtype=torch.int32, device=device)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    return params, caches, token, pos


def _storage_bytes(tree: Any) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
    return total


def trace_step(fn, inputs: Tuple) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """Run ``fn(*inputs)`` (fake tensors) under a ``StepCounter`` (the
    inputs alive from the start) ->
    (the counts, the memory block): ``argument_bytes`` the inputs,
    ``output_bytes`` the outputs, ``temp_bytes`` the peak less the
    inputs, ``per_device_total`` the peak."""
    out, parsed = count(fn, *inputs)
    args_bytes = parsed["tracked_bytes"]
    memory = {"argument_bytes": args_bytes,
              "output_bytes": _storage_bytes(out),
              "temp_bytes": parsed["peak_bytes"] - args_bytes,
              "per_device_total": parsed["peak_bytes"]}
    return parsed, memory


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
            fl_mode: bool = False, fl_baseline: bool = False,
            fl_one_bit: bool = False, force: bool = False,
            oac_packed: bool = True, device=None) -> dict:
    """Trace one combination on the production mesh (the fake group of
    the right size must be started) and write its artifact."""
    dev = resolve_device(device)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}" + (
        "__flbase" if fl_baseline else
        "__fl1bit" if fl_one_bit else "__fl" if fl_mode else "") + (
        "" if oac_packed else "__perleaf")
    out_path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            cached = json.load(f)
        meta = cached.get("meta", {})
        if (meta.get("kind") != "train"
                or meta.get("oac_packed") == oac_packed):
            return cached

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rank = 0 if fl_mode else traced_rank(cfg, multi_pod)
    if dist.get_rank() != rank:
        start_fake_group(dist.get_world_size(), rank)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
    t0 = time.time()
    with FakeTensorMode():
        if fl_mode:
            bundle = make_fl_oac_step(cfg, mesh, seq_len=FL_SEQ_LEN,
                                      local_batch=FL_LOCAL_BATCH,
                                      baseline=fl_baseline,
                                      one_bit=fl_one_bit)
        else:
            bundle = make_step(cfg, shape, mesh, oac_packed=oac_packed,
                               device=dev)
        inputs = step_inputs(bundle, cfg, shape, mesh, dev, oac_packed)
        parsed, memory = trace_step(bundle.fn, inputs)
    t_trace = time.time() - t0
    print({k: v for k, v in memory.items()})
    print({k: parsed[k] for k in ("flops_per_device", "bytes_per_device",
                                  "collective_bytes_per_device", "n_ops")})
    chips = 512 if multi_pod else 256
    report = build_report(cfg, shape, mesh_name, chips, parsed)

    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "fl_mode": fl_mode, "fl_baseline": fl_baseline,
        "device": dev.type, "rank": rank,
        "meta": {k: v for k, v in bundle.meta.items() if k != "scans"}
        | {"scans": bundle.meta.get("scans", {})},
        "trace_s": t_trace,
        "memory": memory,
        "parsed": parsed,
        "roofline": report.as_dict(),
        "suggestion": suggestion(report),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    print(f"[dryrun] {tag}: trace {t_trace:.1f}s, "
          f"dominant={report.dominant}, step={report.step_time_s*1e3:.2f}ms",
          flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) on the chosen mesh")
    ap.add_argument("--fl-mode", action="store_true",
                    help="paper-technique FL-OAC step (clients = ranks)")
    ap.add_argument("--fl-baseline", action="store_true",
                    help="FL-OAC without compression (full all-reduce)")
    ap.add_argument("--fl-onebit", action="store_true",
                    help="FL-OAC with the one-bit FSK-MV uplink (Sec. V-B, "
                         "majority vote over int8 votes)")
    ap.add_argument("--per-leaf-server", action="store_true",
                    help="historical per-leaf OAC server phase (default: "
                         "the persisted packed fused pass)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(ART_DIR))
    ap.add_argument("--device", default=None,
                    help="'cpu' to trace fake CPU tensors (default: fake "
                         "tensors of the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    combos = []
    if args.all:
        for arch in sorted(ARCHS):
            for shape in SHAPE_NAMES:
                combos.append((arch, shape))
    else:
        combos.append((args.arch or "qwen2.5-32b",
                       args.shape or "train_4k"))

    start_fake_group(512 if args.multi_pod else 256)
    failures = []
    try:
        for arch, shape in combos:
            try:
                run_one(arch, shape, args.multi_pod, args.out,
                        fl_mode=args.fl_mode, fl_baseline=args.fl_baseline,
                        fl_one_bit=args.fl_onebit, force=args.force,
                        oac_packed=not args.per_leaf_server, device=dev)
            except Exception as e:
                failures.append((arch, shape, repr(e)))
                traceback.print_exc()
    finally:
        dist.destroy_process_group()
    if failures:
        print(f"\n[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\n[dryrun] all {len(combos)} combination(s) traced OK")


if __name__ == "__main__":
    main()
