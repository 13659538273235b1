"""Milliseconds per round of the server phase's data movement: the own
device time of the program's spans ``server.pack``, ``server.unpack``
and ``server.carry`` (the successor state's casts and its copy into the
carried buffers) in the traced window, over the window's rounds."""

from bench.harness import spans


def read(ctx):
    s = spans.per_round(ctx, ("server.pack", "server.unpack",
                              "server.carry"), "own_s")
    return None if s is None else 1e3 * s
