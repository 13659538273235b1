"""The reference's first rounds of a cell, from the inputs the benchmark
draws: the model's loss and gradients (train cells) or the pool's
gradient trees (the update cell), the server round and AdamW, and the
readings the comparison takes — each round's loss, every leaf's first
moment after round 1 (the gradient as the optimizer got it, times
1 − β1), every leaf's change over the rounds followed, and the carried
ages, gradient, residual and threshold state after the last.  A cell
follows three rounds unless its traffic names more (``rounds``): the
update cell follows eight, so that the rounds in which the
warm-corrected thresholds can first take over (6 on, where the trust
gates hold) are compared too."""

from __future__ import annotations

import importlib
from typing import Any, Dict

import torch

from bench.harness import inputs
from bench.reference import precision, tree
from bench.reference.server import AdamW, Layout, Server

ROUNDS = 3


def rounds(wl: Dict[str, Any]) -> int:
    """The rounds a cell's set-up drives and the reference follows."""
    return int(wl.get("rounds", ROUNDS))


def family(config: Dict[str, Any]):
    """The reference module of a configuration (its ``reference`` key)."""
    return importlib.import_module(f"bench.reference.{config['reference']}")


def step_seed(seed: int, t: int) -> int:
    """The seed the port's update takes in round ``t``."""
    return int(seed) * 4096 + t


def follow(config: Dict[str, Any], wl: Dict[str, Any], seed: int, device,
           prec: str = "float32") -> Dict[str, Any]:
    """Readings of the reference's first ``rounds(wl)`` rounds."""
    precision.no_tf32()
    model = config["model"]
    fam = family(config)
    spec = fam.param_spec(model)
    params = inputs.weights(spec, seed, device)
    leaves = [p for _, p in tree.leaves(params)]
    paths = [pa for pa, _ in tree.leaves(params)]
    layout = Layout([p.shape for p in leaves])
    server = Server(layout, wl["oac"], device)
    opt = AdamW(leaves, wl["lr"])
    p0 = [p.detach().clone() for p in leaves]
    out: Dict[str, Any] = {"loss": []}
    for t in range(rounds(wl)):
        if wl["kind"] == "train":
            grads, loss = _model_grads(fam, model, params, leaves, paths,
                                       wl, seed, t, device, prec)
            out["loss"].append(loss)
        else:
            g_tree = inputs.grad_tree(spec, wl["grad_rms"], seed,
                                      t % wl["pool"], device)
            by_path = dict(tree.leaves(g_tree))
            grads = [by_path[pa] for pa in paths]
        g_t = server.round(layout.pack(grads), step_seed(seed, t), prec)
        del grads
        opt.step(leaves, layout.unpack(g_t))
        del g_t
        if t == 0:
            out["m1"] = [float(torch.linalg.vector_norm(m, dtype=torch.float64))
                         for m in opt.m]
    out["change"] = [float(torch.linalg.vector_norm(p.detach() - q,
                                                    dtype=torch.float64))
                     for p, q in zip(leaves, p0)]
    out.update(paths=[tree.path_name(pa) for pa in paths],
               age=server.age.to(torch.int8), g=server.g, res=server.res,
               valid=server.valid, offsets=layout.offsets,
               sizes=layout.sizes, carried=server.carried,
               rounds=rounds(wl), warm_rounds=server.warm_rounds)
    return out


def first_gradient(config: Dict[str, Any], wl: Dict[str, Any], seed: int,
                   device):
    """(path names, the float32 gradient leaves) of a train cell's first
    round at the weights drawn from ``seed``."""
    precision.no_tf32()
    fam = family(config)
    model = config["model"]
    params = inputs.weights(fam.param_spec(model), seed, device)
    pairs = tree.leaves(params)
    grads, _ = _model_grads(fam, model, params, [p for _, p in pairs],
                            [pa for pa, _ in pairs], wl, seed, 0, device,
                            "float32")
    return [tree.path_name(pa) for pa, _ in pairs], grads


def _model_grads(fam, model, params, leaves, paths, wl, seed, t, device,
                 prec):
    """(the mean gradient leaves, the mean loss) of round ``t``'s batch,
    one sequence at a time."""
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    seqs = inputs.rows(inputs.train_batch(model, wl, seed, t, device))
    total = 0.0
    for row in seqs:
        loss = fam.sequence_loss(params, model, row["tokens"],
                                 row["labels"], row.get("embeds"), prec)
        (loss / len(seqs)).backward()
        total += float(loss.detach()) / len(seqs)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in leaves]
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    return grads, total
