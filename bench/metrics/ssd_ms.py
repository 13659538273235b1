"""Milliseconds per round of the chunked SSD: the own device time of the
program's spans ``model.ssd`` and ``model.ssd.link`` (the loop over the
chunks) in the traced window, forward, recompute and backward, over the
window's rounds."""

from bench.harness import spans


def read(ctx):
    s = spans.per_round(ctx, ("model.ssd", "model.ssd.link"), "own_s")
    return None if s is None else 1e3 * s
