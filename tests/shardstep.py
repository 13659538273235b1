"""The sharded train step against the reference's, as subprocesses:
the harness of ``tests/test_torch_sharded_step*.py``.

``run(work, cases, updates)`` writes each case's inputs (the port's
seeded init and token batches as numpy; for an update case global random
gradients), then runs the reference on 8 placeholder host devices
(``jax.make_mesh(..., axis_types=(AxisType.Auto,) * 2)``: on jax 0.9.0
the default ``Explicit`` axes make the reference's sharded step fail)
concurrently with the port on 8 gloo ranks; the reference writes its
per-shard draws (``normal(fold_in(PRNGKey(seed), my))``) first and the
ranks wait for them.  A case's ``overrides`` replace fields of the
reduced configuration on both sides.  Each side saves, per rank, the
parameters, the optimizer state and the server state after every step
(after the last one for an update case) — the reference's from the
device at the rank's mesh coordinate (``addressable_shards``).
``check_whole_step`` and ``check_update`` hold them to the tolerances
the test files' docstrings state.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch
from rankutil import RANK_PRELUDE, _env

from repro_torch import tree as tree_util
from repro_torch.configs import get_config
from repro_torch.core import packing
from repro_torch.launch import steps
from repro_torch.models import transformer as tr

SEQ, GB, NM, STEPS, UPDATE_STEPS = 64, 8, 2, 3, 2
# each parameter leaf's own share within 1e-6 of the reference (the
# lowest measured: 96.7%, granite-moe's router after the third step)
LEAF_AGREE = 0.95

REFERENCE = r"""
import dataclasses, json, os, sys, time
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch import sharding as jsh, steps as jsteps
from repro.models import transformer as tr
from repro.optim import make_optimizer

SEQ, GB, NM, STEPS, UPDATE_STEPS = %(consts)s
cases, updates, work = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]


def host(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def setup(case):
    dm, mm = case["mesh"]
    mesh = jax.make_mesh((dm, mm), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    cfg = dataclasses.replace(get_config(case["arch"], reduced_variant=True),
                              compute_dtype="float32",
                              **case.get("overrides", {}))
    return mesh, cfg, jsteps.OacServerConfig(**case.get("oac", {}))


def draws(name, case, n_steps, out):
    mesh, cfg, oac = setup(case)
    if oac.noise_std <= 0.0:
        return
    pa = jsteps.abstract_params(cfg)
    d = jsteps.server_layout(pa, jsh.param_pspecs(pa, cfg, mesh), mesh).d_packed
    for t in range(n_steps):
        for my in range(8):
            key = jax.random.fold_in(jax.random.PRNGKey(t), my)
            out[f"{name}_t{t}_r{my}"] = np.asarray(
                jax.random.normal(key, (d,), jnp.float32))


out = {}
for name, case in cases.items():
    draws(name, case, STEPS, out)
for name, case in updates.items():
    draws(name, case, UPDATE_STEPS, out)
np.savez(os.path.join(work, "draws_part.npz"), **out)
os.replace(os.path.join(work, "draws_part.npz"),
           os.path.join(work, "draws.npz"))


def initial(name, cfg, bundle, mesh, oac):
    init = np.load(os.path.join(work, f"init_{name}.npz"))
    abs_p = jsteps.abstract_params(cfg)
    leaves, treedef = jax.tree_util.tree_flatten(abs_p)
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(init[f"p{i:03d}"], l.dtype)
                  for i, l in enumerate(leaves)])
    opt_state = make_optimizer(bundle.meta["optimizer"], 1e-3).init(params)
    server = jsteps.init_server_state(params, mesh=mesh, cfg=cfg, oac=oac)
    return params, opt_state, server


def per_device(arrays, mesh, trees):
    dm, mm = mesh.devices.shape
    for r in range(dm * mm):
        dev = mesh.devices[r // mm, r %% mm]
        for tag, tree in trees:
            for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
                sh = [s for s in leaf.addressable_shards if s.device == dev]
                arrays[f"r{r}_{tag}{i:03d}"] = host(sh[0].data)


res = {}
for name, case in cases.items():
    mesh, cfg, oac = setup(case)
    bundle = jsteps.make_train_step(cfg, InputShape("t", SEQ, GB, "train"),
                                    mesh, n_micro=NM, oac=oac,
                                    sequence_parallel=case["sp"])
    params, opt_state, server = initial(name, cfg, bundle, mesh, oac)
    step = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                   out_shardings=bundle.out_shardings)
    losses, arrays = [], {}
    init = np.load(os.path.join(work, f"init_{name}.npz"))
    for t in range(STEPS):
        batch = {k: jnp.asarray(init[f"{k}{t}"]).reshape(NM, GB // NM, SEQ)
                 for k in ("tokens", "labels")}
        with mesh:
            params, opt_state, server, loss = step(
                params, opt_state, server, batch, jnp.asarray(t, jnp.int32))
        losses.append(float(loss))
        per_device(arrays, mesh, ((f"t{t}_p", params), (f"t{t}_o", opt_state),
                                  (f"t{t}_s", server)))
    np.savez(os.path.join(work, f"ref_{name}.npz"), **arrays)
    res[name] = losses

for name, case in updates.items():
    mesh, cfg, oac = setup(case)
    captured = {}
    orig = jsteps.compat.shard_map

    def spy(*args, **kw):
        captured["fn"] = orig(*args, **kw)
        return captured["fn"]
    jsteps.compat.shard_map = spy
    try:
        bundle = jsteps.make_train_step(cfg, InputShape("t", SEQ, GB, "train"),
                                        mesh, n_micro=NM, oac=oac,
                                        sequence_parallel=case["sp"])
    finally:
        jsteps.compat.shard_map = orig
    update = jax.jit(captured["fn"])
    params, opt_state, server = initial(name, cfg, bundle, mesh, oac)
    init = np.load(os.path.join(work, f"init_{name}.npz"))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    for t in range(UPDATE_STEPS):
        grads = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(init[f"g{t}_{i:03d}"])
                      for i in range(len(leaves))])
        with mesh:
            params, opt_state, server = update(
                params, opt_state, server, grads, jnp.asarray(t, jnp.int32))
    arrays = {}
    per_device(arrays, mesh, (("p", params), ("o", opt_state),
                              ("s", server)))
    np.savez(os.path.join(work, f"ref_{name}.npz"), **arrays)
print(json.dumps(res))
"""

PORT = r"""
import dataclasses, json, sys, time
import numpy as np
from repro_torch import tree as tu
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import packing
from repro_torch.launch import mesh as mesh_lib, sharding, steps
from repro_torch.optim import make_optimizer

SEQ, GB, NM, STEPS, UPDATE_STEPS = %(consts)s
cases, updates, work = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
draws_file = os.path.join(work, "draws.npz")
t0 = time.time()
while not os.path.exists(draws_file):
    if time.time() - t0 > 600:
        raise TimeoutError("the reference wrote no draws")
    time.sleep(0.2)
DRAWS = dict(np.load(draws_file))


def host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def setup(name, case):
    dm, mm = case["mesh"]
    mesh = mesh_lib.make_mesh((dm, mm), ("data", "model"), "cpu")
    cfg = dataclasses.replace(get_config(case["arch"], reduced_variant=True),
                              compute_dtype="float32",
                              **case.get("overrides", {}))
    oac = steps.OacServerConfig(**case.get("oac", {}))
    bundle = steps.make_train_step(cfg, InputShape("t", SEQ, GB, "train"),
                                   mesh, n_micro=NM, oac=oac,
                                   sequence_parallel=case["sp"], device="cpu")
    p_specs, o_specs, s_specs = bundle.in_specs[:3]
    init = np.load(os.path.join(work, f"init_{name}.npz"))
    abs_p = steps.abstract_params(cfg)
    pairs = tu.leaves(abs_p)
    glob = tu.unflatten([p for p, _ in pairs],
                        [init[f"p{i:03d}"] for i in range(len(pairs))])
    params = steps.state_from_numpy(glob, "cpu", mesh, p_specs)
    opt_state = make_optimizer(bundle.meta["optimizer"], 1e-3).init(params)
    server = steps.init_server_state(abs_p, mesh, cfg, oac, local=True,
                                     device="cpu")
    return mesh, bundle, init, params, opt_state, server, pairs, p_specs


def draws_of(name, t):
    key = f"{name}_t{t}_r{RANK}"
    return {"noise": torch.from_numpy(DRAWS[key])} if key in DRAWS else None


def keep(arrays, params, opt_state, server, prefix=""):
    for tag, tree in (("p", params), ("o", opt_state), ("s", server)):
        for i, (_, leaf) in enumerate(tu.leaves(tree)):
            arrays[f"{prefix}{tag}{i:03d}"] = host(leaf).copy()


def save(name, arrays, extra):
    np.savez(os.path.join(work, f"port_{name}_r{RANK}.npz"), **arrays)
    with open(os.path.join(work, f"port_{name}_r{RANK}.json"), "w") as f:
        json.dump(extra, f)


for name, case in cases.items():
    mesh, bundle, init, params, opt_state, server, _, _ = setup(name, case)
    losses, arrays = [], {}
    for t in range(STEPS):
        batch = {k: torch.from_numpy(init[f"{k}{t}"]).reshape(
            NM, GB // NM, SEQ) for k in ("tokens", "labels")}
        *_, loss = bundle.fn(params, opt_state, server, batch, t,
                             draws=draws_of(name, t))
        losses.append(float(loss))
        keep(arrays, params, opt_state, server, f"t{t}_")
    leaves = [[sharding.path_str(path), not any(
                   sharding.entry_axes(e) for e in tuple(spec))]
              for (path, _), spec in zip(tu.leaves(params), sharding.spec_leaves(
                  bundle.in_specs[0]))]
    save(name, arrays,
         {"losses": losses, "leaves": leaves,
          "meta": {k: bundle.meta[k] for k in (
              "rows_sharded", "sequence_parallel", "expert_shard_axis",
              "tensor_parallel")}})

for name, case in updates.items():
    mesh, bundle, init, params, opt_state, server, pairs, p_specs = setup(
        name, case)
    for t in range(UPDATE_STEPS):
        glob = tu.unflatten([p for p, _ in pairs],
                            [init[f"g{t}_{i:03d}"] for i in range(len(pairs))])
        grads = steps.state_from_numpy(glob, "cpu", mesh, p_specs)
        bundle.update(params, opt_state, server, grads, t,
                      draws=draws_of(name, t))
    arrays = {}
    keep(arrays, params, opt_state, server)
    save(name, arrays, {})
"""



def _consts():
    return repr((SEQ, GB, NM, STEPS, UPDATE_STEPS))


def _write_inputs(work, cases):
    """Initial parameters (the port's seeded init), token batches and, for
    the update cases, global random gradients, as numpy."""
    from repro.data.tokens import lm_batch
    for name, case in cases.items():
        cfg = dataclasses.replace(get_config(case["arch"],
                                             reduced_variant=True),
                                  **case.get("overrides", {}))
        params = tr.init_lm_seeded(cfg, 0, "cpu")
        arrays = {f"p{i:03d}": leaf.numpy()
                  for i, (_, leaf) in enumerate(tree_util.leaves(params))}
        for t in range(STEPS):
            toks, labels = lm_batch(t, GB, SEQ, cfg.vocab)
            arrays[f"tokens{t}"], arrays[f"labels{t}"] = toks, labels
        rng = np.random.default_rng(11)
        for t in range(UPDATE_STEPS):
            for i, (_, leaf) in enumerate(tree_util.leaves(params)):
                arrays[f"g{t}_{i:03d}"] = (rng.normal(size=tuple(leaf.shape))
                                           * 0.01 * (1 + t)).astype("f4")
        np.savez(os.path.join(work, f"init_{name}.npz"), **arrays)


def _load(work, name, r):
    ref = np.load(os.path.join(work, f"ref_{name}.npz"))
    port = np.load(os.path.join(work, f"port_{name}_r{r}.npz"))
    return ref, port


def _float(a):
    return (a.view(np.int16).astype(np.int32) << 16).view(np.float32) \
        if a.dtype == np.uint16 else a


def _server_keys(case):
    oac = steps.OacServerConfig(**case.get("oac", {}))
    return sorted(steps.abstract_server_state(
        {"w": torch.empty(8, device="meta")}, None, None, oac))



def run(work, cases, updates):
    """Both sides over ``cases`` (whole steps) and ``updates`` (update
    phases); (work dir, the reference's losses by case)."""
    _write_inputs(work, {**cases, **updates})
    args = [json.dumps(cases), json.dumps(updates), work]
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE % {"consts": _consts()}, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env({"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}))
    store = os.path.join(work, "store")
    port_code = (RANK_PRELUDE + "import numpy as np\n"
                 + PORT % {"consts": _consts()})
    ranks = [subprocess.Popen(
        [sys.executable, "-c", port_code, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env({"RANK": str(r), "WORLD_SIZE": "8", "STORE": store}))
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
    return work, json.loads(outs[0][0].strip().splitlines()[-1])


def check_whole_step(work, ref_losses, name, case):
    """Every rank against the reference's device at its mesh coordinate,
    after every step ``t``, to ``tests/test_torch_launch.py``'s float32
    tolerances: the loss within ``case["loss_rtol"][t]`` (default 1e-5)
    and equal on every rank; the ages equal on at least 99.9%; every
    parameter within 2.2e-3·(t + 1), and within 1e-6 on at least
    ``case["agree"][t]`` (default 99.9%) of them, and every leaf on at
    least ``LEAF_AGREE`` of its own coordinates, so that a wrong update
    confined to a small leaf (a norm, a bias) cannot hide in the total.
    A leaf named in ``case["noise_leaves"]`` (its gradient is zero but
    for rounding, and AdamW scales that up to the learning rate) is held
    to the 2.2e-3 bound only."""
    keys = _server_keys(case)
    age_at = keys.index("age")
    noise = set(case.get("noise_leaves", ()))
    for r in range(8):
        with open(os.path.join(work, f"port_{name}_r{r}.json")) as f:
            got = json.load(f)
        assert np.isfinite(got["losses"]).all()
        if r:
            assert got["losses"] == first["losses"], f"rank {r}"
        else:
            first = got
            meta = got["meta"]
            assert meta["sequence_parallel"] == case["sp"]
            assert meta["rows_sharded"]
            assert meta["expert_shard_axis"] == case.get("pin", "")
            if "split" in case:
                assert meta["tensor_parallel"] == case["split"]
        ref, port = _load(work, name, r)
        for t in range(STEPS):
            np.testing.assert_allclose(
                got["losses"][t], ref_losses[name][t],
                rtol=case.get("loss_rtol", [1e-5] * STEPS)[t])
            age = f"t{t}_s{age_at:03d}"
            agree = (port[age] == ref[f"r{r}_{age}"]).mean()
            assert agree >= 0.999, (r, t, agree)
            close = total = 0
            for i, (leaf, _) in enumerate(got["leaves"]):
                k = f"t{t}_p{i:03d}"
                diff = np.abs(_float(port[k]) - _float(ref[f"r{r}_{k}"]))
                assert diff.max() <= 2.2e-3 * (t + 1), (r, t, leaf,
                                                       diff.max())
                if leaf in noise:
                    continue
                ok = int((diff <= 1e-6).sum())
                assert ok >= LEAF_AGREE * diff.size, (r, t, leaf,
                                                      ok / diff.size)
                close += ok
                total += diff.size
            want = case.get("agree", [0.999] * STEPS)[t]
            assert close >= want * total, (r, t, close / total)


def check_update(work, name, case):
    theta_at = _server_keys(case).index("theta")
    for r in range(8):
        ref, port = _load(work, name, r)
        assert sorted(port.files) == sorted(k.split("_", 1)[1]
                                            for k in ref.files
                                            if k.startswith(f"r{r}_"))
        for k in port.files:
            want = ref[f"r{r}_{k}"]
            got = port[k]
            assert got.shape == want.shape and got.dtype == want.dtype, k
            if k == f"s{theta_at:03d}":
                np.testing.assert_array_max_ulp(got[:2], want[:2], maxulp=2)
                n = len(packing.THRESHOLD_STATE_FIELDS)
                mag = slice(n, n + packing.STATS_MAG_BINS)
                np.testing.assert_array_equal(got[2:n], want[2:n])
                assert np.abs(got[mag] - want[mag]).sum() <= 1.0
                np.testing.assert_array_equal(got[mag.stop:],
                                              want[mag.stop:])
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{name} rank {r} {k}")
