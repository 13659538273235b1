"""Milliseconds per round of the optimizer: the own device time of the
program's span ``optim.apply`` (the cast to the parameters' dtype and
AdamW) in the traced window, over the window's rounds."""

from bench.harness import spans


def read(ctx):
    s = spans.per_round(ctx, ("optim.apply",), "own_s")
    return None if s is None else 1e3 * s
