"""Milliseconds per FL round: the window's host-clock length, closed by
one synchronize, over the rounds completed in it."""


def read(ctx):
    return 1e3 * ctx["window_s"] / ctx["rounds"]
