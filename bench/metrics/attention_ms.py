"""Milliseconds per round of the device work that the attention owns:
the own device time of the program's span ``model.attention`` (its
forward, its recompute and, through autograd's link, its backward) in
the traced window, over the window's rounds."""

from bench.harness import spans


def read(ctx):
    s = spans.per_round(ctx, ("model.attention",), "own_s")
    return None if s is None else 1e3 * s
