"""The port's optimizers against the jitted reference (``repro.optim``) on
float32 inputs: ``sgd``, ``sgdm`` (with Nesterov and weight decay) and
``adamw`` (with weight decay), several steps, on a parameter tree with a
list and a tuple in it.

Both forms of the reference step are held: ``update`` jitted alone
(the updates and the state) and ``update`` fused with the parameter add
in one jitted function, as the launch step runs it (the port's in-place
``apply_``).  Bit for bit, with one exception named: on
the fused form XLA contracts ``p + (−lr)·u`` into one fused multiply-add,
which the port forms in float64 and rounds once — a double rounding that
can differ in the last place where ``u·lr + p`` falls within 2^-53 of a
float32 rounding boundary; none does on these inputs.  The schedules are
held within rtol 1e-6 and atol 1e-10: the two libraries' ``cos`` differ
in the last place, and near π ``1 + cos`` cancels (33 ulps of the floor
value at the last step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import to_np

from repro import optim as joptim
from repro_torch import optim
from repro_torch import tree as tree_util
from repro_torch.launch.steps import state_from_numpy

CASES = {
    "sgd": ("sgd", {}),
    "sgdm": ("sgdm", {}),
    "sgdm_nesterov_wd": ("sgdm", dict(nesterov=True, weight_decay=0.01)),
    "adamw": ("adamw", {}),
    "adamw_wd": ("adamw", dict(weight_decay=0.05, b2=0.99)),
}


def _tree(rng, scale):
    def a(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"w": a(64, 33), "blocks": [{"b": a(7), "k": a(3, 5)}],
            "t": (a(11), a(2, 2))}


def _bits_equal(t, j, what):
    t = to_np(t)
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, what
    if t.dtype == np.float32:
        np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(t, j, err_msg=what)


def _trees_equal(t_tree, j_tree, what):
    tl = tree_util.leaves(t_tree)
    jl = jax.tree_util.tree_leaves(j_tree)
    assert len(tl) == len(jl), what
    for (path, t), j in zip(tl, jl):
        _bits_equal(t, j, f"{what} {path}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_and_fused_step_bit_for_bit(case):
    name, kw = CASES[case]
    rng = np.random.default_rng(0)
    params = _tree(rng, 1.0)
    jopt = joptim.make_optimizer(name, 1e-3, **kw)
    topt = optim.make_optimizer(name, 1e-3, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = state_from_numpy(params, "cpu")
    js = jopt.init(jp)
    ts = topt.init(tp)
    assert set(ts) == set(js)
    j_update = jax.jit(jopt.update)

    @jax.jit
    def j_step(p, s, g):
        u, s2 = jopt.update(g, s, p)
        return jax.tree.map(lambda a, b: a + b.astype(a.dtype), p, u), s2

    for step in range(6):
        grads = _tree(rng, 0.1 * (1 + step))
        jg = jax.tree.map(jnp.asarray, grads)
        tg = state_from_numpy(grads, "cpu")
        # update alone (functional): the updates and the state
        j_u, j_s1 = j_update(jg, js, jp)
        t_u, t_s1 = topt.update(tg, ts, tp)
        _trees_equal(t_u, j_u, f"{case} step {step} updates")
        _trees_equal(t_s1, j_s1, f"{case} step {step} state")
        _trees_equal(optim.apply_updates(tp, t_u),
                     jax.tree.map(lambda a, b: a + b, jp, j_u),
                     f"{case} step {step} unfused add")
        # the fused step in place
        jp, js = j_step(jp, js, jg)
        topt.apply_(tg, ts, tp)
        _trees_equal(tp, jp, f"{case} step {step} params")
        _trees_equal(ts, js, f"{case} step {step} opt state")
    if name == "sgd":
        assert ts["mu"] is None and js["mu"] is None


def test_schedules():
    from repro.optim import schedule as jsched
    from repro_torch.optim import schedule
    steps = np.arange(0, 130, 7, dtype=np.int32)
    for tfn, jfn in (
            (schedule.constant(3e-4), jsched.constant(3e-4)),
            (schedule.cosine_decay(1e-3, 100, 1e-5),
             jsched.cosine_decay(1e-3, 100, 1e-5)),
            (schedule.linear_warmup_cosine(1e-3, 10, 100),
             jsched.linear_warmup_cosine(1e-3, 10, 100))):
        want = np.asarray(jax.vmap(jax.jit(jfn))(jnp.asarray(steps)))
        got = np.array([float(tfn(torch.tensor(int(s)))) for s in steps],
                       np.float32)
        np.testing.assert_allclose(got, want.astype(np.float32),
                                   rtol=1e-6, atol=1e-10)


def test_schedule_drives_the_step_and_unknown_name():
    sched = optim.linear_warmup_cosine(1e-2, 2, 10)
    opt = optim.sgd(sched)
    p = {"w": torch.ones(3)}
    s = opt.init(p)
    opt.apply_({"w": torch.ones(3)}, s, p)      # step 0: warm-up lr 0
    assert torch.equal(p["w"], torch.ones(3)) and int(s["step"]) == 1
    opt.apply_({"w": torch.ones(3)}, s, p)      # step 1: lr 5e-3
    assert float(p["w"][0]) == pytest.approx(1 - 5e-3)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer("lion", 1e-3)
