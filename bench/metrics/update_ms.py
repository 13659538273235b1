"""Milliseconds per round of the server phase, ``update`` (pack, the
fused FAIR-k pass, one-bit vote where configured, AdamW): CUDA events
around it, summed over the window and divided by its rounds."""


def read(ctx):
    return sum(ctx["update_ms"]) / ctx["rounds"]
