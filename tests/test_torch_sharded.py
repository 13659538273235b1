"""The port's sharded engine backend, ``reduce_axes`` and meshes against
the JAX package.

* A world of one, in this process (a gloo group of one rank on a
  ``(1,)`` ``("shard",)`` mesh): the reference's sharded cases on its
  ``(1,)`` mesh, each against the live reference on the same numpy
  inputs — exact, threshold and sharded identical for four policies
  (``tests/test_engine.py:40``); the fused statistics equal on exact,
  threshold, sharded and packed (``test_fused_stats.py:57``); the mesh,
  divisibility and one-bit errors (``test_engine.py:176``,
  ``test_error_feedback.py:138``); the traced split
  (``test_controller.py:111``); error feedback
  (``test_error_feedback.py:61``); 100 warm rounds from the summed
  statistics and the per-shard bootstrap (``test_fused_stats.py:274``
  and ``:301``).  All bit for bit, counts and histograms exactly.
* 8 gloo ranks on the CPU against the reference on 8 placeholder host
  devices, in subprocesses: the sharded engine equal to exact on tie-free
  ages and to threshold under heavy integer-age ties, with equal
  ``n_selected`` (``test_sharded.py:169``); 3 warm ``fused_stats`` rounds
  with the reference's per-shard noise (``normal(fold_in(key, my))``)
  handed over — ages, counts and histograms exactly; the warm thresholds
  within 2 ulps (θ_M is an ``exp2`` of the histogram estimate, and XLA's
  float32 ``exp2`` is not correctly rounded: ``tests/test_torch_
  launch.py``); each round from the reference's ``g_prev`` and ages,
  ``g_t`` bit for bit on the coordinates not selected, and on the
  selected ones within 2 ulps of ``noise_std / n_clients · z`` plus 2
  ulps of the result: the compiled reference folds the scale into the
  normal draw's constant and contracts the sum into one FMA, which the
  handed-over draw cannot reproduce (ROADMAP, "Reference defects"),
  with noise scales 0.5/4 and 0.3/5; the packed engine with
  ``reduce_axes=("data", "model")`` on a (2, 4) mesh (fused warm and legacy routes, 3 rounds each): per-shard
  ``g_t`` and ages bit for bit, counts and histograms exactly, and the
  ``pmean``'d bootstrap thresholds within 1 ulp (the ranks' values are
  summed in another order in the two libraries).
* The production meshes, (16, 16) and (2, 16, 16), built on a fake
  process group of 256 and 512 ranks, and the engine's divisibility error
  on 256 ranks.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from rankutil import run_jax, run_python, run_ranks

from repro.core import engine as jax_engine
from repro.core import packing as jax_packing
from repro_torch.core import engine, packing
from repro_torch.core import collectives
from repro_torch.launch import mesh as mesh_lib

pytestmark = pytest.mark.sharded


def _tie_free(d, seed):
    """(g, g_prev, age, residual): distinct |g|, distinct integer ages."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=d).astype("f4"), rng.normal(size=d).astype("f4"),
            rng.permutation(d).astype("f4"), rng.normal(size=d).astype("f4"))


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _same(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _stats_equal(a, b, keys=("n_selected", "n_sel_m", "mag_hist",
                             "age_hist")):
    for key in keys:
        _same(a[key], b[key])


# ---------------------------------------------------------------------------
# a world of one, in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield mesh_lib.make_mesh((1,), ("shard",), device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jmesh1():
    return jax.make_mesh((1,), ("shard",))


def _pair(mesh1, jmesh1, backend, d, **kw):
    """(reference engine, port engine) of one backend."""
    jkw, tkw = {}, {}
    if backend == "sharded":
        jkw["mesh"], tkw["mesh"] = jmesh1, mesh1
    if backend == "packed":
        jkw["layout"] = jax_packing.PackedLayout.from_tree([jnp.zeros((d,))])
        tkw["layout"] = packing.PackedLayout.from_tree([torch.zeros(d)])
    return (jax_engine.SelectionEngine(
                jax_engine.EngineConfig(backend=backend, **kw), d, **jkw),
            engine.SelectionEngine(
                engine.EngineConfig(backend=backend, **kw), d, **tkw))


@pytest.mark.parametrize("policy,k_m_frac,seed", [
    ("fairk", 0.75, 1), ("fairk", 0.25, 2), ("topk", 1.0, 3),
    ("roundrobin", 0.0, 4)])
def test_exact_threshold_sharded_identical(mesh1, jmesh1, policy, k_m_frac,
                                           seed):
    d = 4096
    g, gp, age, _ = _tie_free(d, seed)
    common = dict(policy=policy, rho=0.1, k_m_frac=k_m_frac,
                  exact_theta=True)
    jex, tex = _pair(mesh1, jmesh1, "exact", d, **common)
    jsh, tsh = _pair(mesh1, jmesh1, "sharded", d, **common)
    _, tth = _pair(mesh1, jmesh1, "threshold", d, **common)
    j1 = jax.jit(jex.select_and_merge)(g, gp, age)
    j3 = jax.jit(jsh.select_and_merge)(g, gp, age)
    k = tex.budgets()[0]
    for out in (tex.select_and_merge(_t(g), _t(gp), _t(age)),
                tth.select_and_merge(_t(g), _t(gp), _t(age)),
                tsh.select_and_merge(_t(g), _t(gp), _t(age))):
        for ref in (j1, j3):
            _same(out[0], ref[0])
            _same(out[1], ref[1])
        assert float(out[2]["n_selected"]) == k
    assert float(j3[2]["n_selected"]) == k


def test_fused_stats_agree_on_every_backend(mesh1, jmesh1):
    d = 4096
    g, gp, age, _ = _tie_free(d, 0)
    common = dict(policy="fairk", rho=0.1, k_m_frac=0.75, exact_theta=True,
                  fused_stats=True)
    jex, _ = _pair(mesh1, jmesh1, "exact", d, **common)
    want = jax.jit(jex.select_and_merge)(g, gp, age)
    jsh, tsh = _pair(mesh1, jmesh1, "sharded", d, **common)
    jsharded = jax.jit(jsh.select_and_merge)(g, gp, age)
    outs = [_pair(mesh1, jmesh1, b, d, **common)[1].select_and_merge(
        _t(g), _t(gp), _t(age)) for b in ("exact", "threshold", "sharded",
                                           "packed")]
    for g_t, age_next, stats in outs:
        for ref in (want, jsharded):
            _same(g_t, ref[0])
            _same(age_next, ref[1])
            _stats_equal(stats, ref[2])
    # the sharded backend's carried state: the summed statistics
    ts, jts = outs[2][2]["tstate"], jsharded[2]["tstate"]
    assert set(ts) == set(jts)
    for key in jts:
        _same(ts[key], jts[key])


def test_sharded_errors(mesh1, jmesh1):
    with pytest.raises(ValueError, match="needs a mesh"):
        engine.make_engine("fairk", "sharded", d=128)
    with pytest.raises(ValueError):
        jax_engine.make_engine("fairk", "sharded", d=128)
    with pytest.raises(ValueError):
        engine.SelectionEngine(engine.EngineConfig(backend="fancy"), 128,
                               mesh=mesh1)
    eng = engine.SelectionEngine(engine.EngineConfig(
        backend="sharded", rho=0.1, exact_theta=True), 256, mesh=mesh1)
    z = torch.zeros(256)
    with pytest.raises(ValueError, match="one-bit"):
        eng.select_and_merge(z, z, z, fresh=z)
    with pytest.raises(ValueError, match="expected shape"):
        eng.select_and_merge(torch.zeros(128), z, z)
    # reduce_axes: the reference fails at trace time on an unbound axis
    # name; the port needs the mesh to resolve the names, and says so when
    # the engine is built
    lay = packing.PackedLayout.from_tree(torch.zeros(256), lane=1)
    with pytest.raises(ValueError, match="pass the mesh"):
        engine.SelectionEngine(engine.EngineConfig(
            backend="packed", reduce_axes=("shard",)), 256, layout=lay)
    with pytest.raises(ValueError, match="not axes of the mesh"):
        engine.SelectionEngine(engine.EngineConfig(
            backend="packed", reduce_axes=("data",)), 256, mesh=mesh1,
            layout=lay)


def test_traced_split_equals_static_on_sharded(mesh1, jmesh1):
    d = 4096
    g, gp, age, _ = _tie_free(d, 13)
    common = dict(policy="fairk", rho=0.1, k_m_frac=0.75, exact_theta=True,
                  fused_stats=True)
    jsh, tsh = _pair(mesh1, jmesh1, "sharded", d, **common)
    want = jax.jit(lambda g, gp, age, f: jsh.select_and_merge(
        g, gp, age, k_m_frac=f))(g, gp, age, jnp.float32(0.75))
    static = tsh.select_and_merge(_t(g), _t(gp), _t(age))
    traced = tsh.select_and_merge(_t(g), _t(gp), _t(age),
                                  k_m_frac=torch.tensor(0.75))
    for out in (static, traced):
        _same(out[0], want[0])
        _same(out[1], want[1])
        assert float(out[2]["n_selected"]) == float(want[2]["n_selected"])
    _same(traced[2]["n_sel_m"], want[2]["n_sel_m"])


def test_error_feedback_bit_exact_on_sharded(mesh1, jmesh1):
    d = 4096
    g, gp, age, res = _tie_free(d, 3)
    common = dict(policy="fairk", rho=0.1, k_m_frac=0.75, exact_theta=True)
    jex, _ = _pair(mesh1, jmesh1, "exact", d, **common)
    jsh, tsh = _pair(mesh1, jmesh1, "sharded", d, **common)
    want = jax.jit(jex.select_and_merge)(g, gp, age, residual=res)
    jsharded = jax.jit(jsh.select_and_merge)(g, gp, age, residual=res)
    got = tsh.select_and_merge(_t(g), _t(gp), _t(age), residual=_t(res))
    for ref in (want, jsharded):
        _same(got[0], ref[0])
        _same(got[1], ref[1])
        _same(got[2]["residual"], ref[2]["residual"])


def test_warm_start_from_summed_statistics(mesh1, jmesh1):
    """100 rounds carrying ``tstate`` on the sharded backend: the warm
    thresholds come from last round's summed statistics; counts track the
    global budget, round by round as the reference's."""
    d = 16384
    kw = dict(policy="fairk", rho=0.1, k_m_frac=0.75, warm_start=True,
              fused_stats=True)
    jsh, tsh = _pair(mesh1, jmesh1, "sharded", d, **kw)
    k = tsh.budgets()[0]
    rng = np.random.default_rng(11)
    gs = [rng.normal(size=d).astype("f4") for _ in range(100)]
    jstep = jax.jit(lambda g, gp, ag, ts:
                    jsh.select_and_merge(g, gp, ag, tstate=ts))
    jgp, jag, jts = (jnp.zeros((d,)), jnp.zeros((d,)),
                     jax_packing.init_threshold_state())
    gp, ag, ts = torch.zeros(d), torch.zeros(d), \
        packing.init_threshold_state("cpu")
    sels, jsels = [], []
    for g in gs:
        jgp, jag, jst = jstep(g, jgp, jag, jts)
        jts = jst["tstate"]
        gp, ag, st = tsh.select_and_merge(_t(g), gp, ag, tstate=ts)
        ts = st["tstate"]
        sels.append(float(st["n_selected"]))
        jsels.append(float(jst["n_selected"]))
    assert sels == jsels
    _same(ag, jag)
    _same(gp, jgp)
    assert sels[0] == d                          # round-0 full refresh
    assert abs(np.mean(sels[60:]) - k) < 0.2 * k
    assert float(ts["n_sel_m"]) > 0


def test_per_shard_bootstrap_without_tstate(mesh1, jmesh1):
    d = 8192
    g, gp, age, _ = _tie_free(d, 13)
    kw = dict(policy="fairk", rho=0.1, k_m_frac=0.75, fused_stats=True)
    jsh, tsh = _pair(mesh1, jmesh1, "sharded", d, **kw)
    want = jax.jit(jsh.select_and_merge)(g, gp, age)
    got = tsh.select_and_merge(_t(g), _t(gp), _t(age))
    _same(got[0], want[0])
    _same(got[1], want[1])
    _stats_equal(got[2], want[2])
    k = tsh.budgets()[0]
    assert abs(float(got[2]["n_selected"]) - k) < 0.2 * k
    assert float(got[2]["mag_hist"].sum()) > 0


# ---------------------------------------------------------------------------
# the production meshes on a fake process group
# ---------------------------------------------------------------------------

_FAKE = r"""
import json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.core import engine
from repro_torch.core import collectives
from repro_torch.launch import mesh as mesh_lib
out = {}
for world, multi in ((256, False), (512, True)):
    rank = world - 3
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    m = mesh_lib.make_production_mesh(multi_pod=multi, device_type="cpu")
    try:
        engine.make_engine("fairk", "sharded", d=1000, mesh=m)
        err = None
    except ValueError as e:
        err = str(e)
    out[str(world)] = {
        "shape": list(m.shape), "axes": list(collectives.axis_names(m)),
        "batch": list(mesh_lib.batch_axes(m)),
        "fsdp": list(mesh_lib.fsdp_axes(m)),
        "n_batch": collectives.axis_size(m, mesh_lib.batch_axes(m)),
        "my": collectives.axis_index(m),
        "my_model": collectives.axis_index(m, ("model",)),
        "n_local": engine.make_engine("fairk", "sharded", d=world * 64,
                                      mesh=m).n_local,
        "error": err}
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_meshes():
    return json.loads(run_python(_FAKE, timeout=120).strip().splitlines()[-1])


@pytest.mark.parametrize("world", [256, 512])
def test_production_mesh_on_a_fake_group(fake_meshes, world):
    got = fake_meshes[str(world)]
    multi = world == 512
    assert got["shape"] == ([2, 16, 16] if multi else [16, 16])
    assert got["axes"] == (["pod", "data", "model"] if multi
                           else ["data", "model"])
    assert got["batch"] == got["fsdp"] == got["axes"][:-1]
    assert got["n_batch"] == world // 16
    assert got["my"] == world - 3            # row-major: the rank itself
    assert got["my_model"] == (world - 3) % 16
    assert got["n_local"] == 64
    assert got["error"] == f"d=1000 not divisible by {world} devices"


# ---------------------------------------------------------------------------
# 8 gloo ranks against 8 placeholder host devices
# ---------------------------------------------------------------------------

D8 = 4096            # the tie-free and tied cases (n_local 512)
D_WARM = 16384       # warm fused rounds with noise (n_local 2048)
WARM_ROUNDS = 3
NOISES = {"pow2": dict(noise_std=0.5, n_clients=4),    # scale 1/8
          "odd": dict(noise_std=0.3, n_clients=5)}
PACKED_LEAVES = (3000, 1000)
PACKED_ROUNDS = 3
PACKED_ROUTES = {"fused": dict(fused_stats=True, warm_start=True),
                 "legacy": dict(fused_stats=False, warm_start=True)}

_JAX8 = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.core import packing
from repro.core.engine import EngineConfig, SelectionEngine
from jax.sharding import PartitionSpec as P

D8, D_WARM, WARM_ROUNDS, NOISES, LEAVES, ROUNDS, ROUTES = json.loads(
    sys.argv[2])
out = {}
rng = np.random.default_rng(0)
g = rng.normal(size=D8).astype("f4")
gp = rng.normal(size=D8).astype("f4")
age = rng.permutation(D8).astype("f4")
age_t = rng.integers(0, 8, D8).astype("f4")
out.update(g=g, gp=gp, age=age, age_t=age_t)
common = dict(policy="fairk", rho=0.1, k_m_frac=0.75, exact_theta=True)
mesh = jax.make_mesh((8,), ("shard",))
ex = SelectionEngine(EngineConfig(backend="exact", **common), D8)
th = SelectionEngine(EngineConfig(backend="threshold", **common), D8)
sh = SelectionEngine(EngineConfig(backend="sharded", **common), D8,
                     mesh=mesh)
for tag, a in (("free", age), ("tied", age_t)):
    for name, e in (("exact", ex), ("threshold", th), ("sharded", sh)):
        with mesh:
            g_t, a_n, st = jax.jit(e.select_and_merge)(g, gp, a)
        out[f"{tag}_{name}_g"] = np.asarray(g_t)
        out[f"{tag}_{name}_age"] = np.asarray(a_n)
        out[f"{tag}_{name}_n"] = np.asarray(st["n_selected"])

# warm fused rounds with noise
n_local = D_WARM // 8
for nz, noise_kw in NOISES.items():
    warm = SelectionEngine(EngineConfig(
        backend="sharded", policy="fairk", rho=0.1, k_m_frac=0.75,
        fused_stats=True, warm_start=True, **noise_kw), D_WARM, mesh=mesh)
    step = jax.jit(lambda g, gp, ag, ts, key: warm.select_and_merge(
        g, gp, ag, tstate=ts, key=key))
    gp_w, ag_w = jnp.zeros((D_WARM,)), jnp.zeros((D_WARM,))
    ts = packing.init_threshold_state()
    for t in range(WARM_ROUNDS):
        g_w = rng.normal(size=D_WARM).astype("f4")
        key = jax.random.PRNGKey(100 + t)
        with mesh:
            gp_w, ag_w, st = step(g_w, gp_w, ag_w, ts, key)
        ts = st["tstate"]
        pre = f"warm_{nz}_{t}_"
        out[pre + "in"] = g_w
        out[pre + "noise"] = np.concatenate([np.asarray(jax.random.normal(
            jax.random.fold_in(key, my), (n_local,), jnp.float32))
            for my in range(8)])
        out[pre + "g"] = np.asarray(gp_w)
        out[pre + "age"] = np.asarray(ag_w)
        for k in ("n_selected", "n_sel_m", "mag_hist", "age_hist",
                  "theta_m", "theta_a"):
            out[pre + k] = np.asarray(st[k])

# the packed engine with reduce_axes on a (2, 4) mesh
mesh24 = jax.make_mesh((2, 4), ("data", "model"))
axes = ("data", "model")
lay = packing.PackedLayout.from_tree([jnp.zeros((n,)) for n in LEAVES])
dp = lay.d_packed
out["packed_d"] = np.asarray(dp)
def leaves(size_rng, scale=1.0):
    return [jnp.asarray((size_rng.normal(size=n) * scale).astype("f4"))
            for n in LEAVES]
g_sh = np.concatenate([np.asarray(lay.pack(leaves(rng))) for _ in range(8)])
gp_sh = np.concatenate([np.asarray(lay.pack(leaves(rng))) for _ in range(8)])
ag_sh = np.concatenate([np.asarray(lay.pack_age(
    [jnp.asarray(rng.integers(0, 40, n).astype("f4")) for n in LEAVES]))
    for _ in range(8)])
out.update(packed_g0=g_sh, packed_gp=gp_sh, packed_age=ag_sh)
vec = P(axes)
for route, kw in ROUTES.items():
    eng = SelectionEngine(EngineConfig(
        backend="packed", policy="fairk", rho=0.1, k_m_frac=0.75,
        reduce_axes=axes, **kw), dp, layout=lay)
    def body(g, gp, ag, ts):
        g_t, a_n, st = eng.select_and_merge(g, gp, ag, tstate=ts)
        return g_t, a_n, st["tstate"]
    def body0(g, gp, ag):
        g_t, a_n, st = eng.select_and_merge(g, gp, ag)
        return g_t, a_n, st["tstate"]
    f = jax.jit(compat.shard_map(body, mesh24, in_specs=(vec, vec, vec, P()),
                                 out_specs=(vec, vec, P())))
    f0 = jax.jit(compat.shard_map(body0, mesh24, in_specs=(vec, vec, vec),
                                  out_specs=(vec, vec, P())))
    gp_p, ag_p, ts = jnp.asarray(gp_sh), jnp.asarray(ag_sh), None
    for t in range(ROUNDS):
        g_p = g_sh if t == 0 else np.concatenate(
            [np.asarray(lay.pack(leaves(rng))) for _ in range(8)])
        out[f"{route}_{t}_in"] = g_p
        with mesh24:
            gp_p, ag_p, ts = (f0(g_p, gp_p, ag_p) if ts is None
                              else f(g_p, gp_p, ag_p, ts))
        out[f"{route}_{t}_g"] = np.asarray(gp_p)
        out[f"{route}_{t}_age"] = np.asarray(ag_p)
        for k in packing.THRESHOLD_STATE_FIELDS + ("mag_hist", "age_hist"):
            out[f"{route}_{t}_{k}"] = np.asarray(ts[k])
np.savez(sys.argv[1], **out)
print("done")
"""

_PORT8 = r"""
import json, sys
import numpy as np
from repro_torch.core import packing
from repro_torch.core.engine import EngineConfig, SelectionEngine
from repro_torch.core import collectives
from repro_torch.launch import mesh as mesh_lib

D8, D_WARM, WARM_ROUNDS, NOISES, LEAVES, ROUNDS, ROUTES = json.loads(
    sys.argv[3])
ref = np.load(sys.argv[1])
out = {}
t_ = lambda a: torch.from_numpy(np.array(a))
mesh = mesh_lib.make_mesh((8,), ("shard",), device_type="cpu")
my = collectives.axis_index(mesh)

def part(x, n):
    return t_(x[my * n:(my + 1) * n])

common = dict(policy="fairk", rho=0.1, k_m_frac=0.75, exact_theta=True)
sh = SelectionEngine(EngineConfig(backend="sharded", **common), D8,
                     mesh=mesh)
n = sh.n_local
for tag, a in (("free", "age"), ("tied", "age_t")):
    g_t, a_n, st = sh.select_and_merge(part(ref["g"], n), part(ref["gp"], n),
                                       part(ref[a], n))
    out[f"{tag}_g"], out[f"{tag}_age"] = g_t.numpy(), a_n.numpy()
    out[f"{tag}_n"] = st["n_selected"].numpy()

for nz, noise_kw in NOISES.items():
    warm = SelectionEngine(EngineConfig(
        backend="sharded", policy="fairk", rho=0.1, k_m_frac=0.75,
        fused_stats=True, warm_start=True, **noise_kw), D_WARM, mesh=mesh)
    n = warm.n_local
    gp, ag = torch.zeros(n), torch.zeros(n)
    ts = packing.init_threshold_state("cpu")
    for t in range(WARM_ROUNDS):
        pre = f"warm_{nz}_{t}_"
        if t:
            # the reference's merged values: each round held on its own
            prev = f"warm_{nz}_{t - 1}_"
            gp, ag = part(ref[prev + "g"], n), part(ref[prev + "age"], n)
        gp, ag, st = warm.select_and_merge(
            part(ref[pre + "in"], n), gp, ag, tstate=ts,
            noise=part(ref[pre + "noise"], n))
        ts = st["tstate"]
        out[pre + "g"], out[pre + "age"] = gp.numpy(), ag.numpy()
        for k in ("n_selected", "n_sel_m", "mag_hist", "age_hist",
                  "theta_m", "theta_a"):
            out[pre + k] = st[k].numpy()

mesh24 = mesh_lib.make_test_mesh(2, 4, device_type="cpu")
lay = packing.PackedLayout.from_tree([torch.zeros(k) for k in LEAVES])
dp = lay.d_packed
assert dp == int(ref["packed_d"])
for route, kw in ROUTES.items():
    eng = SelectionEngine(EngineConfig(
        backend="packed", policy="fairk", rho=0.1, k_m_frac=0.75,
        reduce_axes=("data", "model"), **kw), dp, mesh=mesh24, layout=lay)
    gp, ag, ts = part(ref["packed_gp"], dp), part(ref["packed_age"], dp), None
    for t in range(ROUNDS):
        gp, ag, st = eng.select_and_merge(part(ref[f"{route}_{t}_in"], dp),
                                          gp, ag, tstate=ts)
        ts = st["tstate"]
        out[f"{route}_{t}_g"], out[f"{route}_{t}_age"] = gp.numpy(), ag.numpy()
        for k, v in ts.items():
            out[f"{route}_{t}_{k}"] = v.numpy()
np.savez(sys.argv[2] + f"/port_{my}.npz", **out)
print(my)
"""


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    """The reference on 8 host devices and the port on 8 gloo ranks, run
    once for the module; the port's shards concatenated in mesh order."""
    tmp = tmp_path_factory.mktemp("sharded8")
    ref_path = str(tmp / "ref.npz")
    consts = json.dumps([D8, D_WARM, WARM_ROUNDS, NOISES, PACKED_LEAVES,
                         PACKED_ROUNDS, PACKED_ROUTES])
    run_jax(_JAX8, [ref_path, consts], timeout=400)
    outs = run_ranks(_PORT8, 8, str(tmp), [ref_path, str(tmp), consts],
                     timeout=400)
    assert sorted(int(o.strip().splitlines()[-1]) for o in outs) == list(
        range(8))
    parts = [dict(np.load(str(tmp / f"port_{r}.npz"))) for r in range(8)]
    port = {}
    for key, v in parts[0].items():
        if v.ndim == 1 and not key.endswith("_hist"):
            port[key] = np.concatenate([p[key] for p in parts])
        else:
            for p in parts[1:]:             # replicated: equal everywhere
                np.testing.assert_array_equal(p[key], v, err_msg=key)
            port[key] = v
    return dict(np.load(ref_path)), port


@pytest.mark.parametrize("tag,backend", [("free", "exact"),
                                         ("free", "sharded"),
                                         ("tied", "threshold"),
                                         ("tied", "sharded")])
def test_eight_ranks_equal_the_reference(ranks8, tag, backend):
    """(a) tie-free ages: sharded == exact; (b) heavy integer-age ties:
    sharded == threshold (the global-index jitter)."""
    ref, port = ranks8
    _same(port[f"{tag}_g"], ref[f"{tag}_{backend}_g"])
    _same(port[f"{tag}_age"], ref[f"{tag}_{backend}_age"])
    assert float(port[f"{tag}_n"]) == float(ref[f"{tag}_{backend}_n"])


@pytest.mark.parametrize("t", range(WARM_ROUNDS))
@pytest.mark.parametrize("noise", list(NOISES))
def test_eight_ranks_warm_fused_rounds_with_noise(ranks8, noise, t):
    ref, port = ranks8
    pre = f"warm_{noise}_{t}_"
    for key in ("age", "n_selected", "n_sel_m", "mag_hist", "age_hist"):
        _same(port[pre + key], ref[pre + key])
    for key in ("theta_m", "theta_a"):
        np.testing.assert_array_max_ulp(port[pre + key], ref[pre + key], 2)
    sel = ref[pre + "age"] == 0.0
    assert sel.sum() > 0
    _same(port[pre + "g"][~sel], ref[pre + "g"][~sel])
    scale = NOISES[noise]["noise_std"] / NOISES[noise]["n_clients"]
    bound = 2 * (np.spacing(np.abs(np.float32(scale) * ref[pre + "noise"]))
                 + np.spacing(np.abs(ref[pre + "g"])))
    err = np.abs(port[pre + "g"] - ref[pre + "g"])
    assert np.all(err[sel] <= bound[sel]), err[sel].max()


@pytest.mark.parametrize("t", range(PACKED_ROUNDS))
@pytest.mark.parametrize("route", list(PACKED_ROUTES))
def test_eight_ranks_packed_reduce_axes(ranks8, route, t):
    ref, port = ranks8
    pre = f"{route}_{t}_"
    _same(port[pre + "g"], ref[pre + "g"])
    _same(port[pre + "age"], ref[pre + "age"])
    for key in ("n_sel", "n_sel_m", "mag_hist", "age_hist", "init",
                "streak"):
        _same(port[pre + key], ref[pre + key])
    # the pmean'd bootstrap: 8 float32 thresholds summed in another order
    for key in ("theta_m", "theta_a"):
        np.testing.assert_array_max_ulp(port[pre + key].astype("f4"),
                                        ref[pre + key].astype("f4"), 1)
