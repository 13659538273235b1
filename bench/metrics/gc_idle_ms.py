"""Milliseconds per round in which the device sat idle under the host's
garbage collections: the idle time that the program's spans
``host.gc1`` and ``host.gc2`` overlap in the traced window, over the
window's rounds; 0 where no collection of generation 1 or 2 ran."""

from bench.harness import spans


def read(ctx):
    if not (ctx.get("trace") or {}).get("spans"):
        return None
    s = spans.per_round(ctx, ("host.gc1", "host.gc2"), "idle_s")
    return 0.0 if s is None else 1e3 * s
