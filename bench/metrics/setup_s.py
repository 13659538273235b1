"""Seconds from the start of the process to the first timed round:
building the kernels where they are not built yet, drawing the weights
and inputs, and the three rounds that warm every shape (the rounds the
reference follows)."""


def read(ctx):
    return ctx["setup_s"]
