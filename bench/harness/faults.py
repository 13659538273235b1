"""Faults planted under a cell's timed path, to show that the comparison
catches them (the tests, and the readings that set the limits' upper
ends):

* ``unchanged``: the round returns its state unchanged (``update`` does
  nothing);
* ``half_batch``: half of each microbatch's rows left out, the mean taken
  over the rest (train cells);
* ``altered``: an answer altered where it is produced: the largest
  leaf's gradient doubled as ``grads_fn`` returns it, or as ``update``
  takes it from the pool.

The exchange between chips cannot be left out of a cell on one chip."""

from __future__ import annotations

from typing import Any

from bench.reference import tree

FAULTS = ("unchanged", "half_batch", "altered")


def _double_largest(grads: Any) -> Any:
    pairs = tree.leaves(grads)
    big = max(range(len(pairs)), key=lambda i: pairs[i][1].numel())
    vals = [g * 2.0 if i == big else g for i, (_, g) in enumerate(pairs)]
    return tree.unflatten([p for p, _ in pairs], vals)


def plant(cell, fault: str) -> None:
    """Break ``cell``'s train step in place."""
    kern = cell.kern
    grads_fn, update = kern.grads_fn, kern.update
    if fault == "unchanged":
        kern.update = lambda params, opt, server, grads, seed, draws=None: (
            params, opt, server)
    elif fault == "half_batch":
        if cell.wl["kind"] != "train":
            raise ValueError("an update cell has no batch")

        def half(params, batch):
            mb = batch["tokens"].shape[1]
            return grads_fn(params, {k: v[:, :max(1, mb // 2)]
                                     for k, v in batch.items()})
        kern.grads_fn = half
    elif fault == "altered":
        if cell.wl["kind"] == "train":
            def altered(params, batch):
                loss, grads = grads_fn(params, batch)
                return loss, _double_largest(grads)
            kern.grads_fn = altered
        else:
            kern.update = lambda params, opt, server, grads, seed, draws=None: (
                update(params, opt, server, _double_largest(grads), seed, draws))
    else:
        raise ValueError(f"unknown fault {fault!r}; choose from {FAULTS}")
