"""SGD (with momentum) and AdamW on parameter trees
(``repro.optim.optimizers``).

An optimizer is ``(init, update, apply_)``: ``update(grads, state,
params) -> (updates, state')`` returns the updates that are *added* to
the parameters, as the reference does; ``apply_(grads, state, params)``
computes the same new parameters and state and writes them in place (the
launch path's step, so that a full-width model never holds two copies of
its optimizer state).  The state keeps the reference's keys (``step``,
``m``, ``v``, ``mu``; ``mu`` is ``None`` without momentum), so
checkpoints carry across.

The arithmetic is the compiled reference's, held bit for bit against it
on float32 inputs: XLA on the CPU contracts a product and a sum into a
fused multiply-add, formed here in float64 and rounded once (``_fma``):
the moment updates ``fma(b, m, round(c·g))``, the momentum ``fma(μ, m,
g)``, the parameter update ``fma(u, −lr, p)``; and it rewrites AdamW's
``(m / bc1) / (√(v / bc2) + ε)`` as ``m / (bc1 · (√(v / bc2) + ε))``,
with a correctly rounded square root.
The bias corrections ``b ** step`` are a float32 power of the carried
step, on the state's device (no host sync).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util

Tensor = torch.Tensor
Params = Any
State = Any
Schedule = Callable[[Tensor], Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], State]
    update: Callable[[Any, State, Params], Tuple[Params, State]]
    apply_: Callable[[Any, State, Params], None]


def _f32(x: float) -> float:
    """A Python float as the float32 the reference multiplies by."""
    return float(np.float32(x))


def _fma(a, b, c: Tensor) -> Tensor:
    """``a·b + c`` rounded once to float32 (formed in float64, where the
    product of two float32 values is exact)."""
    a = a.to(torch.float64) if isinstance(a, Tensor) else a
    b = b.to(torch.float64) if isinstance(b, Tensor) else b
    return (a * b + c.to(torch.float64)).to(torch.float32)


def _sqrt(x: Tensor) -> Tensor:
    """The correctly rounded float32 square root (taken in float64:
    ``torch.sqrt`` of a float32 on the CPU is one ulp off on about 0.6%
    of values)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _to_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    value = _f32(lr)
    return lambda step: torch.full((), value, dtype=torch.float32,
                                   device=step.device)


def _zeros_like_tree(params, dtype=None):
    return tree_util.tree_map(
        lambda p: torch.zeros_like(p, dtype=dtype or p.dtype), params)


def sgd(lr, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _to_schedule(lr)
    mom, wd = _f32(momentum), _f32(weight_decay)

    def init(params):
        mu = _zeros_like_tree(params) if momentum else None
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_util.leaves(params)[0][1].device)
        return {"step": step, "mu": mu}

    def leaf(g, p, m):
        """-> (mu', effective gradient) for one leaf."""
        if weight_decay:
            g = _fma(wd, p, g)
        if not momentum:
            return None, g
        mu = _fma(mom, m, g)
        return mu, (_fma(mom, mu, g) if nesterov else mu)

    def leaves_of(grads, state, params):
        ps = [p for _, p in tree_util.leaves(params)]
        gs = [g.to(torch.float32) for _, g in tree_util.leaves(grads)]
        ms = ([m for _, m in tree_util.leaves(state["mu"])] if momentum
              else [None] * len(ps))
        return gs, ps, ms

    def update(grads, state, params):
        step = state["step"]
        neg_lr = -lr_fn(step)
        paths = [pa for pa, _ in tree_util.leaves(params)]
        new_mu, upd = [], []
        for g, p, m in zip(*leaves_of(grads, state, params)):
            mu, eff = leaf(g, p, m)
            new_mu.append(mu)
            upd.append((neg_lr * eff).to(p.dtype))
        mu = tree_util.unflatten(paths, new_mu) if momentum else None
        return (tree_util.unflatten(paths, upd),
                {"step": step + 1, "mu": mu})

    def apply_(grads, state, params):
        with torch.no_grad():
            neg_lr = -lr_fn(state["step"])
            for g, p, m in zip(*leaves_of(grads, state, params)):
                mu, eff = leaf(g, p, m)
                if momentum:
                    m.copy_(mu)
                p.copy_(_fma(neg_lr, eff, p).to(p.dtype))
            state["step"].add_(1)

    return Optimizer(init, update, apply_)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _to_schedule(lr)
    b1f, b2f = _f32(b1), _f32(b2)
    c1, c2 = _f32(1 - b1), _f32(1 - b2)
    epsf, wd = _f32(eps), _f32(weight_decay)

    def init(params):
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_util.leaves(params)[0][1].device)
        return {"step": step,
                "m": _zeros_like_tree(params, torch.float32),
                "v": _zeros_like_tree(params, torch.float32)}

    def corrections(step: Tensor) -> Tuple[Tensor, Tensor]:
        s = step.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=s.device)
        return (1.0 - torch.pow(one * b1f, s), 1.0 - torch.pow(one * b2f, s))

    def moments(g, m, v):
        g = g.to(torch.float32)
        m = _fma(b1f, m, c1 * g)
        v = _fma(b2f, v, c2 * torch.square(g))
        return m, v

    def direction(m, v, p, bc1, bc2):
        u = m / (bc1 * (_sqrt(v / bc2) + epsf))
        if weight_decay:
            u = _fma(wd, p.to(torch.float32), u)
        return u

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        bc1, bc2 = corrections(step)
        paths = [pa for pa, _ in tree_util.leaves(params)]
        ps = [p for _, p in tree_util.leaves(params)]
        gs = [g for _, g in tree_util.leaves(grads)]
        ms = [m for _, m in tree_util.leaves(state["m"])]
        vs = [v for _, v in tree_util.leaves(state["v"])]
        new_m, new_v, upd = [], [], []
        for g, p, m, v in zip(gs, ps, ms, vs):
            m_, v_ = moments(g, m, v)
            new_m.append(m_)
            new_v.append(v_)
            upd.append(((-lr_t) * direction(m_, v_, p, bc1, bc2))
                       .to(p.dtype))
        return (tree_util.unflatten(paths, upd),
                {"step": step, "m": tree_util.unflatten(paths, new_m),
                 "v": tree_util.unflatten(paths, new_v)})

    def apply_(grads, state, params):
        with torch.no_grad():
            state["step"].add_(1)
            step = state["step"]
            neg_lr = -lr_fn(step)
            bc1, bc2 = corrections(step)
            ps = [p for _, p in tree_util.leaves(params)]
            gs = [g for _, g in tree_util.leaves(grads)]
            ms = [m for _, m in tree_util.leaves(state["m"])]
            vs = [v for _, v in tree_util.leaves(state["v"])]
            for g, p, m, v in zip(gs, ps, ms, vs):
                m_, v_ = moments(g, m, v)
                m.copy_(m_)
                v.copy_(v_)
                del m_, v_
                u = direction(m, v, p, bc1, bc2)
                p.copy_(_fma(u, neg_lr, p).to(p.dtype))

    return Optimizer(init, update, apply_)


def apply_updates(params: Params, updates: Params) -> Params:
    return tree_util.tree_map(lambda p, u: p + u.to(p.dtype), params,
                              updates)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "sgdm":
        kw.setdefault("momentum", 0.9)
        return sgd(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
