"""The sharded prefill and serve steps (``make_prefill_step(cfg, shape,
mesh)`` / ``make_serve_step(cfg, shape, mesh)``) on 8 gloo ranks, against
the port's single-process ``prefill`` / ``decode_step`` (in every rank)
and the reference's sharded steps on 8 placeholder host devices
(``AxisType.Auto`` axes), run concurrently from the same parameters (the
port's seeded init, as numpy).

Reduced configurations in their bf16 compute: a 16-token prompt, then 8
teacher-forced decode steps into caches of capacity 64 —
``qwen2.5-32b`` on (2, 4) at batch 8 (capacity over ``model``) and at
batch 1 (``shard_capacity``: capacity over ``data`` and ``model``, which the
port's prefill derives from the batch of one and fills directly, and the
reference reshards to),
``mamba2-370m`` on (2, 4) (SSM heads and conv channels over ``model``),
and ``granite-moe-3b-a800m`` on (4, 2) (the expert pin; single-token MoE
decoding routes the global batch, gathered over ``data``).  Each rank's
logits rows are held to the reference test's tolerances
(``tests/test_sharded.py::test_decode_parity_sharded_vs_single``: 0.05
dense and SSM, 0.5 MoE) against the single-process decode (the split
products sum in another order), and its caches are its blocks of the single-process caches
(positions exactly, values within the same tolerance).  Against the
reference's sharded steps at the rank's rows the bound is twice that in
bf16: over a prompt and 8 tokens the reference's sharded decode sits up
to 0.081 (dense) from its own one-device decode on these inputs, its
partitioned reductions rounding otherwise; the bf16 MoE case is not held
to it (0.789 there, a routing flip, and 1.18 from the port).
``qwen2.5-32b`` and ``granite-moe-3b-a800m`` again in float32 compute
hold all three comparisons to 1e-4, and so do two float32 cases of their
own: ``jamba-1.5-large-398b`` on (2, 4), whose every part splits over
``model`` (4 heads over 1 kv head, 4 experts, 16 SSM heads, a vocabulary
of 512), and ``whisper-base`` on (2, 4) with seeded frames in the batch
(the cross caches, their frames split over ``model``).  Two more float32
cases hold heads that do not split evenly over ``model``
(``parallel.head_range``; a case's ``overrides`` replace fields of the
reduced configuration on both sides) to the same 1e-4: ``qwen2.5-32b``
with 6 heads over 2 kv heads (runs of 1 / 2 / 1 / 2 heads, a kv group of
3 split between ranks) and ``whisper-base`` with 2 heads (fewer heads
than ranks: two ranks compute none; the cross caches).

The serving steps partition as the train step does
(``parallel.tp_split``): each case asserts the parts its bundles name in
``meta["tensor_parallel"]`` — qwen's heads (4 over 1 kv head on 4
ranks), MLP and vocabulary; mamba2's SSM heads and vocabulary;
granite-moe's heads, experts and vocabulary on 2 ranks.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from rankutil import RANK_PRELUDE, _env

from repro_torch import tree as tree_util
from repro_torch.configs import get_config
from repro_torch.models import transformer as tr

pytestmark = pytest.mark.sharded

PLEN, NDEC, CAP = 16, 8, 64
QWEN_SPLIT = ["attn", "ffn", "vocab"]
GRANITE_SPLIT = ["attn", "experts", "vocab"]
CASES = {
    "qwen": dict(arch="qwen2.5-32b", mesh=[2, 4], gb=8, tol=0.05,
                 split=QWEN_SPLIT),
    "qwen_batch1": dict(arch="qwen2.5-32b", mesh=[2, 4], gb=1, tol=0.05,
                        split=QWEN_SPLIT),
    "mamba2": dict(arch="mamba2-370m", mesh=[2, 4], gb=8, tol=0.05,
                   split=["ssm", "vocab"]),
    "granite_pin": dict(arch="granite-moe-3b-a800m", mesh=[4, 2], gb=8,
                        tol=0.5, split=GRANITE_SPLIT),
    "qwen_f32": dict(arch="qwen2.5-32b", mesh=[2, 4], gb=8, tol=1e-4,
                     compute="float32", split=QWEN_SPLIT),
    "granite_f32": dict(arch="granite-moe-3b-a800m", mesh=[4, 2], gb=8,
                        tol=1e-4, compute="float32", split=GRANITE_SPLIT),
    "jamba_f32": dict(arch="jamba-1.5-large-398b", mesh=[2, 4], gb=8,
                      tol=1e-4, compute="float32",
                      split=["attn", "experts", "ffn", "ssm", "vocab"]),
    "whisper_f32": dict(arch="whisper-base", mesh=[2, 4], gb=8, tol=1e-4,
                        compute="float32", split=QWEN_SPLIT),
    # heads that do not split evenly over ``model``: 6 heads in runs of
    # 1 / 2 / 1 / 2, whose kv groups of 3 split inside a rank's run
    "qwen_uneven_f32": dict(arch="qwen2.5-32b", mesh=[2, 4], gb=8,
                            tol=1e-4, compute="float32", split=QWEN_SPLIT,
                            overrides={"n_heads": 6, "n_kv_heads": 2}),
    # fewer heads than ranks: 2 heads, ranks 0 and 2 compute none; the
    # cross caches
    "whisper_h2_f32": dict(arch="whisper-base", mesh=[2, 4], gb=8,
                           tol=1e-4, compute="float32", split=QWEN_SPLIT,
                           overrides={"n_heads": 2, "n_kv_heads": 2}),
}

REFERENCE = r"""
import dataclasses, json, os, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch import steps as jsteps
from repro.models import transformer as tr

PLEN, NDEC, CAP = %(consts)s
cases, work = json.loads(sys.argv[1]), sys.argv[2]
for name, case in cases.items():
    dm, mm = case["mesh"]
    gb = case["gb"]
    mesh = jax.make_mesh((dm, mm), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    cfg = dataclasses.replace(get_config(case["arch"], reduced_variant=True),
                              compute_dtype=case["compute"],
                              **case.get("overrides", {}))
    init = np.load(os.path.join(work, f"init_{name}.npz"))
    leaves, treedef = jax.tree_util.tree_flatten(
        jsteps.abstract_params(cfg))
    # bfloat16 leaves come as their bits
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(init[f"p{i:03d}"].view(jnp.bfloat16)
                              if init[f"p{i:03d}"].dtype == np.uint16
                              else init[f"p{i:03d}"], l.dtype)
                  for i, l in enumerate(leaves)])
    pre = jsteps.make_prefill_step(cfg, InputShape("p", CAP, gb, "prefill"),
                                   mesh)
    srv = jsteps.make_serve_step(cfg, InputShape("d", CAP, gb, "decode"),
                                 mesh)
    with mesh:
        pre_fn = jax.jit(pre.fn, in_shardings=pre.in_shardings,
                         out_shardings=pre.out_shardings)
        srv_fn = jax.jit(srv.fn, in_shardings=srv.in_shardings,
                         out_shardings=srv.out_shardings)
        caches = tr.init_caches(cfg, gb, capacity=CAP)
        batch = {"tokens": jnp.asarray(init["prompt"])}
        if "frames" in init:
            batch["frames"] = jnp.asarray(init["frames"])
        logits, caches = pre_fn(params, caches, batch)
        # a batch of one decodes with the capacity over data as well
        caches = jax.device_put(caches, srv.in_shardings[1])
        outs = [np.asarray(logits, np.float32)]
        for t in range(NDEC):
            logits, caches = srv_fn(params, caches,
                                    jnp.asarray(init["toks"][:, t:t + 1]),
                                    jnp.asarray(PLEN + t, jnp.int32))
            outs.append(np.asarray(logits, np.float32))
    np.save(os.path.join(work, f"ref_{name}.npy"), np.stack(outs))
print("done")
"""

PORT = r"""
import dataclasses, json, sys
import numpy as np
from repro_torch import tree as tu
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import collectives
from repro_torch.launch import mesh as mesh_lib, sharding, steps
from repro_torch.models import transformer as tr

PLEN, NDEC, CAP = %(consts)s
cases, work = json.loads(sys.argv[1]), sys.argv[2]
res = {}
for name, case in cases.items():
    dm, mm = case["mesh"]
    gb = case["gb"]
    mesh = mesh_lib.make_mesh((dm, mm), ("data", "model"), "cpu")
    cfg = dataclasses.replace(get_config(case["arch"], reduced_variant=True),
                              compute_dtype=case["compute"],
                              **case.get("overrides", {}))
    init = np.load(os.path.join(work, f"init_{name}.npz"))
    pairs = tu.leaves(steps.abstract_params(cfg))
    leaves = [init[f"p{i:03d}"] for i in range(len(pairs))]
    params = tu.unflatten([p for p, _ in pairs], [
        torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        if a.dtype == np.uint16 else torch.from_numpy(a) for a in leaves])
    prompt = torch.from_numpy(init["prompt"])
    toks = torch.from_numpy(init["toks"])
    batch = {"tokens": prompt}
    if "frames" in init:
        batch["frames"] = torch.from_numpy(init["frames"])
    # one process, the whole batch
    caches = tr.init_caches(cfg, gb, CAP, device="cpu")
    single = [tr.prefill(params, cfg, prompt, caches,
                         frames=batch.get("frames"))[0]]
    for t in range(NDEC):
        single.append(tr.decode_step(params, cfg, toks[:, t:t + 1], PLEN + t,
                                     caches)[0])
    # the mesh
    pre = steps.make_prefill_step(cfg, InputShape("p", CAP, gb, "prefill"),
                                  mesh)
    srv = steps.make_serve_step(cfg, InputShape("d", CAP, gb, "decode"),
                                mesh)
    p_specs, c_specs = srv.in_specs[:2]
    local = sharding.local_tree(params, p_specs, mesh)
    mine = steps.init_sharded_caches(cfg, mesh, gb, CAP, device="cpu")
    got = [pre.fn(local, mine, batch)[0]]
    for t in range(NDEC):
        got.append(srv.fn(local, mine, toks[:, t:t + 1],
                          torch.tensor(PLEN + t, dtype=torch.int32))[0])
    rows = list(range(gb))
    if srv.meta["rows_sharded"]:
        n = gb // collectives.axis_size(mesh, sharding.batch_axes(mesh))
        r0 = collectives.axis_index(mesh, sharding.batch_axes(mesh)) * n
        rows = rows[r0:r0 + n]
    single = torch.stack([x[rows] for x in single]).float()
    got = torch.stack(got).float()
    blocks = sharding.local_tree(caches, c_specs, mesh)
    same = all(torch.equal(a, b) for (_, a), (_, b)
               in zip(tu.leaves(blocks), tu.leaves(mine))
               if not a.is_floating_point())
    cache_err = max(float((a.float() - b.float()).abs().max())
                    for (_, a), (_, b) in zip(tu.leaves(blocks),
                                              tu.leaves(mine))
                    if a.is_floating_point())
    np.save(os.path.join(work, f"port_{name}_r{RANK}.npy"), got.numpy())
    res[name] = {"rows": rows, "caches_equal": same, "cache_err": cache_err,
                 "layouts_agree": pre.in_specs[1] == c_specs,
                 "vs_single": float((got - single).abs().max()),
                 "meta": {k: srv.meta[k] for k in ("shard_capacity",
                                                    "rows_sharded",
                                                    "tensor_parallel")},
                 "prefill_split": pre.meta["tensor_parallel"]}
print(json.dumps(res))
"""


for _case in CASES.values():
    _case.setdefault("compute", "bfloat16")


def _host(t):
    """A leaf as numpy: a bfloat16 one as its bits (uint16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("sharded_serve"))
    for name, case in CASES.items():
        cfg = dataclasses.replace(get_config(case["arch"],
                                             reduced_variant=True),
                                  compute_dtype=case["compute"],
                                  **case.get("overrides", {}))
        params = tr.init_lm_seeded(cfg, 0, "cpu")
        rng = np.random.default_rng(1)
        arrays = {f"p{i:03d}": _host(leaf)
                  for i, (_, leaf) in enumerate(tree_util.leaves(params))}
        arrays["prompt"] = rng.integers(0, cfg.vocab,
                                        (case["gb"], PLEN)).astype("i4")
        arrays["toks"] = rng.integers(0, cfg.vocab,
                                      (case["gb"], NDEC)).astype("i4")
        if cfg.family == "audio":
            arrays["frames"] = (0.02 * rng.standard_normal(
                (case["gb"], cfg.encoder_seq, cfg.d_model))).astype(
                    case["compute"])
        np.savez(os.path.join(work, f"init_{name}.npz"), **arrays)
    consts = repr((PLEN, NDEC, CAP))
    args = [json.dumps(CASES), work]
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE % {"consts": consts}, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env({"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}))
    code = RANK_PRELUDE + PORT % {"consts": consts}
    ranks = [subprocess.Popen(
        [sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env({"RANK": str(r), "WORLD_SIZE": "8",
                  "STORE": os.path.join(work, "store")}))
        for r in range(8)]
    procs = [ref] + ranks
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return work, [json.loads(out.strip().splitlines()[-1])
                  for out, _ in outs[1:]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_decode_matches_single_process_and_reference(runs, name):
    work, results = runs
    case = CASES[name]
    ref = np.load(os.path.join(work, f"ref_{name}.npy"))
    assert ref.shape[:2] == (NDEC + 1, case["gb"])
    for r, res in enumerate(results):
        got = res[name]
        assert got["meta"]["shard_capacity"] == (case["gb"] == 1)
        assert got["layouts_agree"], f"rank {r}: prefill and serve caches"
        assert got["meta"]["rows_sharded"] == (case["gb"] == 8)
        assert got["meta"]["tensor_parallel"] == case["split"], r
        assert got["prefill_split"] == case["split"], r
        assert got["caches_equal"], f"rank {r}: cache positions"
        assert got["cache_err"] < case["tol"], (r, got["cache_err"])
        assert got["vs_single"] < case["tol"], (r, got["vs_single"])
        port = np.load(os.path.join(work, f"port_{name}_r{r}.npy"))
        err = np.abs(port - ref[:, got["rows"]]).max()
        assert np.isfinite(port).all()
        # in bf16 the reference's sharded decode itself drifts from its
        # one-device decode (module docstring): twice the tolerance
        if case["compute"] == "float32":
            assert err < case["tol"], (r, err)
        elif case["arch"] != "granite-moe-3b-a800m":
            assert err < 2 * case["tol"], (r, err)
