"""Milliseconds per round of the model phase, ``grads_fn`` (the clients'
gradients accumulated over the microbatches): CUDA events around it,
summed over the window and divided by its rounds."""


def read(ctx):
    if "grads_ms" not in ctx:
        return None
    return sum(ctx["grads_ms"]) / ctx["rounds"]
