"""Milliseconds per round of the output head and the loss: the own
device time of the program's spans ``model.logits`` and ``model.loss``
in the traced window, forward, recompute and backward, over the window's
rounds."""

from bench.harness import spans


def read(ctx):
    s = spans.per_round(ctx, ("model.logits", "model.loss"), "own_s")
    return None if s is None else 1e3 * s
