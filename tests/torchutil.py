"""Shared harness for the PyTorch port's tests (``tests/test_torch_*.py``).

Builds identical numpy inputs for the JAX package and the port from a
seed, draws the reference's random numbers from its named key ladder
(``repro.core.keys.split_named``) so both sides see the same fading and
noise, and moves arrays between the frameworks as numpy.  Importing it
caps torch at two threads: the suite runs under several xdist workers.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import keys as keys_mod
from repro.core import oac as jax_oac
from repro.data import partition as jax_partition
from repro.data import synthetic as jax_synthetic
from repro.fl import trainer as jax_trainer
from repro.models import cnn as jax_cnn
from repro_torch.models import cnn

torch.set_num_threads(2)

D_KERNEL = 5000          # not a multiple of 256: the ragged tail matters


def to_torch(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fairk_inputs(seed: int, d: int = D_KERNEL) -> Dict[str, np.ndarray]:
    """Server-pass inputs: heavy-tailed g (exact zeros and ±0.0 included),
    integer ages 0..130 (past AGE_CAP) with interior pad runs (PAD_AGE),
    a residual, and ±1 one-bit ``fresh`` values with a few zeros."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_t(3, size=d) * 0.1).astype(np.float32)
    g[rng.choice(d, 20, replace=False)] = 0.0
    g[rng.choice(d, 20, replace=False)] = -0.0
    age = rng.integers(0, 131, size=d).astype(np.float32)
    for start in (137, 1024, 2999):
        age[start:start + 41] = -1.0
    age[-7:] = -1.0
    fresh = np.where(rng.random(d) < 0.5, 1.0, -1.0).astype(np.float32)
    fresh[rng.choice(d, 10, replace=False)] = 0.0
    return {"g": g,
            "g_prev": rng.normal(size=d).astype(np.float32),
            "age": age,
            "residual": (rng.normal(size=d) * 0.05).astype(np.float32),
            "fresh": fresh}


def inject_nonfinite(x: np.ndarray, seed: int, n: int = 30) -> np.ndarray:
    """A copy of ``x`` with NaN, +Inf and -Inf at ``n`` positions each."""
    rng = np.random.default_rng(seed)
    out = x.copy()
    pos = rng.choice(x.shape[0], 3 * n, replace=False)
    out[pos[:n]] = np.nan
    out[pos[n:2 * n]] = np.inf
    out[pos[2 * n:]] = -np.inf
    return out


def theta_cases(g: np.ndarray, age: np.ndarray) -> Dict[str, Tuple[float,
                                                                      float]]:
    """θ pairs: both 0 (full refresh), finite quantiles, and each stage
    switched off with inf."""
    mag = np.abs(g[np.isfinite(g)])
    tm = float(np.quantile(mag, 0.9))
    ta = float(np.quantile(age[age >= 0], 0.8)) + 0.5
    return {"zero": (0.0, 0.0), "finite": (tm, ta),
            "inf_m": (float("inf"), ta), "inf_a": (tm, float("inf")),
            "inf_both": (float("inf"), float("inf"))}


def edge_samples(score: np.ndarray, weight: np.ndarray) -> int:
    """How many weighted samples lie within 1e-5 of a quarter-octave bin
    edge: only these may land one bin apart when two libraries' ``log2``
    differ in the last place."""
    with np.errstate(divide="ignore", invalid="ignore"):
        q = 4.0 * np.log2(np.abs(score.astype(np.float64)))
        near = np.isfinite(q) & (np.abs(q - np.round(q)) < 1e-5)
    return int((near & weight).sum())


def round_draws(key, n_clients: int, d: int, channel
                ) -> Dict[str, np.ndarray]:
    """The JAX trainer's draws for one round key: fading ``h`` from
    ``sel`` and the standard-normal channel noise ``z`` from ``ch``."""
    ks = keys_mod.split_named(key, ("sel", "ch"))
    h = jax_oac.sample_fading(ks["sel"], n_clients, channel)
    z = jax.random.normal(ks["ch"], (d,), jnp.float32)
    return {"h": np.asarray(h), "z": np.asarray(z)}


def exact_round_draws(key, fl, d: int) -> Dict[str, np.ndarray]:
    """The JAX trainer's draws on the exact backend for one round key:
    ``u`` (d,) from ``sel`` for toprand / randk; on the coherent uplink
    fading ``h`` and noise ``z`` (k,) from the two halves of ``ch``, on
    the one-bit uplink ``z`` (k,) from ``ch`` itself."""
    ks = keys_mod.split_named(key, ("sel", "ch"))
    k = fl.budgets(d)[0]
    draws = {}
    if fl.policy in ("toprand", "randk"):
        draws["u"] = np.asarray(jax.random.uniform(ks["sel"], (d,),
                                                   jnp.float32))
    if fl.one_bit:
        draws["z"] = np.asarray(jax.random.normal(ks["ch"], (k,),
                                                  jnp.float32))
    else:
        key_h, key_z = jax.random.split(ks["ch"])
        draws["h"] = np.asarray(jax_oac.sample_fading(key_h, fl.n_clients,
                                                      fl.channel))
        draws["z"] = np.asarray(jax.random.normal(key_z, (k,), jnp.float32))
    return draws


def scenario_round_draws(key, fl, d: int) -> Dict[str, np.ndarray]:
    """The JAX trainer's draws for one round key of a faults / population /
    wireless / watchdog round, by the port's ``draw_round`` names: the
    named split ``round_key_names(base=("sel", "ch"), chaos=…, pop=…,
    wl=…)``; on the dense route the fading ``h`` from ``sel`` (not on a
    wireless round) and the noise ``z`` (d,) — from ``ch`` on threshold,
    packed and the one-bit detection, from the second half of ``ch`` on
    the exact engine (``engine._exact_update``'s split); a watchdog-only
    exact round takes ``exact_round_draws``.  Then ``av`` (N,), ``fd``,
    ``nz`` (d,), ``pop`` and ``participants`` (``population_round``'s
    inner split into chain and cohort keys), ``er``, ``fad`` (N, 2) and
    ``csi`` (N,), as the round uses them."""
    chaos = fl.faults.enabled
    pop, wl = fl.population is not None, fl.wireless is not None
    if not (chaos or pop or wl):
        return exact_round_draws(key, fl, d) if fl.backend == "exact" \
            else round_draws(key, fl.n_clients, d, fl.channel)
    ks = keys_mod.split_named(key, keys_mod.round_key_names(
        base=("sel", "ch"), chaos=chaos, pop=pop, wl=wl))
    n, f32 = fl.n_clients, jnp.float32
    draws = {}
    if not fl.one_bit and not wl:
        draws["h"] = jax_oac.sample_fading(ks["sel"], n, fl.channel)
    key_z = ks["ch"]
    if fl.backend == "exact" and not fl.one_bit:
        key_z = jax.random.split(ks["ch"])[1]
    draws["z"] = jax.random.normal(key_z, (d,), f32)
    fc = fl.faults
    if chaos and not pop:
        draws["av"] = jax.random.uniform(ks["av"], (n,))
    if fc.fade > 0.0:
        draws["fd"] = jax.random.uniform(ks["fd"], (-(-d // fc.fade_block),))
    if fc.nan_rate > 0.0:
        draws["nz"] = jax.random.uniform(ks["nz"], (d,))
    if pop:
        pc = fl.population
        key_t, key_p = jax.random.split(ks["pop"])
        draws["pop"] = jax.random.uniform(key_t, (pc.n_clients,), f32)
        draws["participants"] = jax.random.randint(
            key_p, (pc.participants,), 0, pc.n_clients)
        draws["er"] = jax.random.uniform(ks["er"],
                                         (-(-d // pc.erase_block),))
    if wl:
        draws["fad"] = jax.random.normal(ks["fad"], (n, 2), f32)
        if fl.wireless.csi_err > 0.0:
            draws["csi"] = jax.random.normal(ks["csi"], (n,), f32)
    return {k: np.asarray(v) for k, v in draws.items()}


def fault_state_draws(fl) -> Dict[str, np.ndarray]:
    """The draws of the JAX ``init_fault_state`` (key ``seed + 0x5EED``)
    by the port's names: ``av0`` (N,), ``pop0`` (n_virtual,) and ``fad0``
    (N, 2) standard normals."""
    key = jax.random.PRNGKey(fl.seed + 0x5EED)
    out = {"av0": jax.random.uniform(key, (fl.n_clients,))}
    if fl.population is not None:
        out["pop0"] = jax.random.uniform(jax.random.fold_in(key, 0x404),
                                         (fl.population.n_clients,),
                                         jnp.float32)
    if fl.wireless is not None:
        out["fad0"] = jax.random.normal(jax.random.fold_in(key, 0xC4A),
                                        (fl.n_clients, 2), jnp.float32)
    return {k: np.asarray(v) for k, v in out.items()}


def engine_draws(key, d: int) -> Dict[str, np.ndarray]:
    """The exact engine's draws for one key: the uniform ``u`` of the
    random policies from the selection half, the standard-normal noise
    ``noise`` (d,) from the other."""
    key_sel, key_noise = jax.random.split(key)
    return {"u": np.asarray(jax.random.uniform(key_sel, (d,), jnp.float32)),
            "noise": np.asarray(jax.random.normal(key_noise, (d,),
                                                  jnp.float32))}


# --- the FL slice on a narrow prototype CNN --------------------------------

def small_fl_task(rounds: int, n_clients: int = 4):
    """(params, batches): a narrow prototype CNN (16x16x1 input, widths
    (4, 6, 8), fc 16, 10 classes, d = 1400) and ``rounds`` rounds of client
    batches for ``n_clients`` clients (4 unless given), H = 2, B = 3 over a
    Dir(0.3) split of max(400, 100 N) samples."""
    # 400 training samples, more for many clients (every Dirichlet shard
    # needs a few)
    spec = jax_synthetic.DatasetSpec("t", (16, 16, 1), 10,
                                     max(400, 100 * n_clients), 50,
                                     sparsity=0.1)
    (xtr, ytr), _ = jax_synthetic.make_dataset(spec, seed=0)
    parts = jax_partition.dirichlet_partition(ytr, n_clients, 0.3, seed=0)
    params = jax_cnn.init_prototype_cnn(jax.random.PRNGKey(1), (16, 16, 1),
                                        10, (4, 6, 8), 16)
    batches = [jax_partition.client_batches(xtr, ytr, parts, 3, 2, seed=t)
               for t in range(rounds)]
    return params, batches


def jax_loss(p, x, y):
    return jax_cnn.softmax_xent(jax_cnn.prototype_cnn(p, x), y)


def torch_loss(p, x, y):
    return cnn.softmax_xent(cnn.prototype_cnn(p, x), y)


def torch_params(params):
    return cnn.params_from_numpy(jax.tree_util.tree_map(np.asarray, params))


def run_jax_rounds(jfl, params, batches, draws_fn: Callable,
                   spies: Sequence[Tuple[object, str, str, int]] = ()):
    """The JAX trainer's loop over ``batches``; per round the state before
    and after it, the draws (``draws_fn(key, d)``), the controller state
    after it (``ctrl``), the round's metrics and the values recorded from
    inside the compiled round.  ``spies``: (module, function name,
    record name, argument position or keyword name) — the argument is
    recorded with ``jax.debug.callback`` every time the round calls the
    function (a keyword not passed records nothing).  A faults /
    population / wireless / watchdog config runs the extended step: the
    carried fault state before and after each round is ``fstate`` and
    ``fstate_after``."""
    state, unravel = jax_trainer.init_server(params, jfl)
    d = state.w.shape[0]
    captured = {}
    originals = [(mod, name, getattr(mod, name))
                 for mod, name, _, _ in spies]
    stateful = (jfl.chaos or jfl.watchdog is not None
                or jfl.population is not None or jfl.wireless is not None)
    fstate = jax_trainer.init_fault_state(jfl, state) if stateful else None

    def spy(orig, record, pos):
        def wrapped(*a, **kw):
            v = kw.get(pos) if isinstance(pos, str) else a[pos]
            if v is not None:
                jax.debug.callback(
                    lambda v: captured.__setitem__(record, np.asarray(v)),
                    v)
            return orig(*a, **kw)
        return wrapped

    for mod, name, record, pos in spies:
        setattr(mod, name, spy(getattr(mod, name), record, pos))
    try:
        step = jax_trainer.make_fl_step(jfl, unravel, jax_loss, d)
        key = jax.random.PRNGKey(jfl.seed)
        carry = (state.w, state.g, state.age, state.sel_count,
                 state.residual, state.theta, state.ctrl)
        out = []
        for xs, ys in batches:
            key, sub = jax.random.split(key)
            w, g, age, sc, res, ts, cs = carry
            args = (sub, w, g, age, sc, jnp.asarray(xs), jnp.asarray(ys),
                    res, ts, cs)
            if stateful:
                (w2, g2, age2, sc2, res2, _, ts2, cs2, metrics,
                 fstate2) = step(*args, fstate)
            else:
                (w2, g2, age2, sc2, res2, _, ts2, cs2, metrics) = step(*args)
                fstate2 = None
            jax.effects_barrier()
            out.append({"before": carry,
                        "after": (w2, g2, age2, sc2, res2, ts2),
                        "draws": draws_fn(sub, d),
                        "ctrl": cs2, "metrics": metrics,
                        "fstate": fstate, "fstate_after": fstate2,
                        "captured": dict(captured)})
            carry = (w2, g2, age2, sc2, res2, ts2, cs2)
            fstate = fstate2
    finally:
        for mod, name, orig in reversed(originals):
            setattr(mod, name, orig)
    return out, d


# --- the scenario layers -----------------------------------------------------

def jax_sweep_lane_draws(cfg, seeds) -> Dict[str, np.ndarray]:
    """Each sweep lane's draws as the JAX grid takes them from its seed,
    by the port's ``draw_lanes`` names: ``w_stars``, per round ``h``,
    ``z``, ``u`` and the scenario's (``av``, ``fd``, ``nz``, ``pop`` and
    ``participants``, ``er``, ``fad``, ``csi``; population lanes replace
    the dropout draw), with the initial ``pop0`` and ``fad0`` from
    ``fold_in(PRNGKey(seed), 0x404 / 0xC4A)``."""
    fc, pc, wc = cfg.faults, cfg.population, cfg.wireless
    chaos, f32 = fc.enabled, jnp.float32
    names = keys_mod.round_key_names(base=("pol", "h", "z"), chaos=chaos,
                                     pop=pc is not None, wl=wc is not None,
                                     av_with_pop=False)
    lanes = []
    for s in seeds:
        key0 = jax.random.PRNGKey(int(s))
        key_shared, key_init, key_run = jax.random.split(key0, 3)
        lane = {"w_stars": cfg.shared * jax.random.normal(
            key_shared, (cfg.d,), f32)[None, :] + cfg.hetero
            * jax.random.normal(key_init, (cfg.n_clients, cfg.d), f32)}
        if pc is not None:
            lane["pop0"] = jax.random.uniform(jax.random.fold_in(key0, 0x404),
                                              (pc.n_clients,), f32)
        if wc is not None:
            lane["fad0"] = jax.random.normal(jax.random.fold_in(key0, 0xC4A),
                                             (cfg.n_clients, 2), f32)
        per = {}
        for key in jax.random.split(key_run, cfg.rounds):
            ks = keys_mod.split_named(key, names)
            r = {"u": jax.random.uniform(ks["pol"], (cfg.d,)),
                 "h": jax.random.rayleigh(
                     ks["h"], cfg.fading_mean / np.sqrt(np.pi / 2.0),
                     shape=(cfg.n_clients,), dtype=f32),
                 "z": jax.random.normal(ks["z"], (cfg.d,), f32)}
            if "av" in ks:
                r["av"] = jax.random.uniform(ks["av"], (cfg.n_clients,))
            if chaos and fc.fade > 0.0:
                r["fd"] = jax.random.uniform(
                    ks["fd"], (-(-cfg.d // fc.fade_block),))
            if chaos and fc.nan_rate > 0.0:
                r["nz"] = jax.random.uniform(ks["nz"], (cfg.d,))
            if pc is not None:
                key_t, key_p = jax.random.split(ks["pop"])
                r["pop"] = jax.random.uniform(key_t, (pc.n_clients,), f32)
                r["participants"] = jax.random.randint(
                    key_p, (pc.participants,), 0, pc.n_clients)
                r["er"] = jax.random.uniform(
                    ks["er"], (-(-cfg.d // pc.erase_block),))
            if wc is not None:
                r["fad"] = jax.random.normal(ks["fad"], (cfg.n_clients, 2),
                                             f32)
                if wc.csi_err > 0.0:
                    r["csi"] = jax.random.normal(ks["csi"],
                                                 (cfg.n_clients,), f32)
            for k, v in r.items():
                per.setdefault(k, []).append(np.asarray(v))
        lane.update({k: np.stack(v) for k, v in per.items()})
        lanes.append(lane)
    return {k: np.stack([np.asarray(lane[k]) for lane in lanes])
            for k in lanes[0]}


def port_age_hist(eng, d: int, erase_fn: Callable, *, rounds: int = 600,
                  burn_in: int = 150, seed: int = 0, tstate=None,
                  count_erased: bool = False) -> np.ndarray:
    """``statutil.accumulate_age_hist`` on the port's engine: iid N(0, 1)
    scores from a ``torch.Generator`` seeded ``seed``, the (d,) erasure
    mask ``erase_fn(r)`` (or None) each round through the sanitized
    ``select_and_merge``, the emitted ``age_hist`` summed after burn-in
    (with ``count_erased``, the erased sampled coordinates' exact ages
    added on rounds whose histogram misses them)."""
    from repro_torch.core import packing as t_packing
    gen = torch.Generator().manual_seed(seed)
    gp = torch.zeros(d)
    ag = torch.zeros(d)
    acc = np.zeros(t_packing.STATS_AGE_BINS)
    stride = t_packing.hist_stride(d)
    for r in range(rounds):
        g = torch.randn(d, generator=gen)
        noise = torch.randn(d, generator=gen)
        erase = erase_fn(r)
        erase = None if erase is None else torch.as_tensor(
            np.asarray(erase, np.float32))
        g_t, ag, stats = eng.select_and_merge(
            g, gp, ag, noise=noise, tstate=tstate, erase=erase,
            sanitize=True)
        if tstate is not None:
            tstate = stats["tstate"]
        gp = g_t
        if r >= burn_in:
            h = to_np(stats["age_hist"]).astype(np.float64)
            if count_erased and erase is not None:
                samp = to_np(ag)[::stride]
                erased = to_np(erase)[::stride] > 0.0
                valid = samp >= 0.0
                if h.sum() < valid.sum() - 0.5:
                    bins = np.clip(samp[erased & valid], 0,
                                   t_packing.STATS_AGE_BINS - 1).astype(int)
                    h = h + np.bincount(
                        bins, minlength=t_packing.STATS_AGE_BINS)
            acc += h
    return acc


def to_port(tree):
    """A JAX/numpy nest (dicts, tuples, arrays, None) as torch tensors."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_port(v) for v in tree)
    return to_torch(tree)


def scenario_fl_pair(backend: str, jax_kw: dict, port_kw: dict, *,
                     one_bit: bool = False, n_clients: int = 4,
                     noise_std: float = 0.0, rounds: int = 3, **extra):
    """(JAX FLConfig, port FLConfig) of a scenario round on the narrow
    CNN task: N clients in chunks of 2, H = 2, B = 3, ρ 0.2; Rayleigh
    fading with ``noise_std`` on the coherent uplink, no fading and noise
    2.0 on the one-bit one; ``jax_kw`` / ``port_kw`` the scenario fields
    built from each package's configs."""
    from repro_torch.core import oac as t_oac
    from repro_torch.fl import trainer as t_trainer
    base = dict(dict(n_clients=n_clients, local_steps=2, batch_size=3,
                     local_lr=0.05, global_lr=0.05, rounds=rounds,
                     backend=backend, client_chunk=2, compression_ratio=0.2,
                     seed=0, one_bit=one_bit), **extra)
    ch = (dict(fading="none", mean=1.0, noise_std=2.0) if one_bit else
          dict(fading="rayleigh", mean=1.0, noise_std=noise_std))
    return (jax_trainer.FLConfig(**base, channel=jax_oac.ChannelConfig(**ch),
                                 **jax_kw),
            t_trainer.FLConfig(**base, channel=t_oac.ChannelConfig(**ch),
                               **port_kw))


def scenario_step_parity(jfl, tfl, params, batches, spies=()):
    """Run the JAX trainer's rounds (``scenario_round_draws`` recorded),
    then the port's round from JAX's state, fault state and draws before
    each round -> ``(jax_rounds, d, [(port outputs, jax round), ...])``."""
    from repro_torch.fl import trainer as t_trainer
    jax_rounds, d = run_jax_rounds(
        jfl, params, batches,
        lambda key, dd: scenario_round_draws(key, jfl, dd), spies)
    _, unravel = cnn.ravel_params(torch_params(params))
    step = t_trainer.make_fl_step(tfl, unravel, torch_loss, d, device="cpu")
    pairs = []
    for t, rnd in enumerate(jax_rounds):
        w, g, age, sc, res, ts, cs = to_port(rnd["before"])
        xs, ys = batches[t]
        out = step(w, g, age, sc, to_torch(xs), to_torch(ys), res, ts,
                   to_port(rnd["draws"]), cs, to_port(rnd["fstate"]))
        pairs.append((out, rnd))
    return jax_rounds, d, step, pairs


def assert_step_parity(pairs, *, agree_min: float = 0.9999,
                       w_atol: float = 1e-6, fad_atol: float = 2.4e-7):
    """Per round: ages equal on at least ``agree_min`` of the coordinates,
    ``w`` within ``w_atol``, the availability and population states
    exactly, the fading chain within ``fad_atol`` (the fading step's last
    place), the watchdog's trips exactly and its EMAs within rtol 1e-5."""
    for t, (out, rnd) in enumerate(pairs):
        jw, _, jage, _, _, _ = rnd["after"]
        agree = float((to_np(out[2]) == np.asarray(jage)).mean())
        assert agree >= agree_min, f"round {t}: ages agree on {agree}"
        np.testing.assert_allclose(to_np(out[0]), np.asarray(jw), rtol=0,
                                   atol=w_atol, err_msg=f"round {t} w")
        fs, jfs = out[9], rnd["fstate_after"]
        if "avail" in jfs:
            np.testing.assert_array_equal(to_np(fs["avail"]),
                                          np.asarray(jfs["avail"]))
        if "pop" in jfs:
            np.testing.assert_array_equal(to_np(fs["pop"]["avail"]),
                                          np.asarray(jfs["pop"]["avail"]))
            assert int(fs["pop"]["t"]) == int(jfs["pop"]["t"])
        if "chan" in jfs:
            np.testing.assert_allclose(to_np(fs["chan"]["fad"]),
                                       np.asarray(jfs["chan"]["fad"]),
                                       rtol=0, atol=fad_atol)
        if "wd" in jfs:
            assert float(fs["wd"]["trips"]) == float(jfs["wd"]["trips"])
            for key in ("ema_loss", "ema_norm", "obs", "cooldown"):
                np.testing.assert_allclose(to_np(fs["wd"][key]),
                                           np.asarray(jfs["wd"][key]),
                                           rtol=1e-5, err_msg=key)
