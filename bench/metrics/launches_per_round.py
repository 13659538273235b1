"""Device launches per round from the train step: the launch calls made
while the program's span ``step.grads`` or ``step.update`` was open
(their inclusive launches) in the traced window, over the window's
rounds.  The host pays for each; the device waits where they lag."""

from bench.harness import spans


def read(ctx):
    return spans.per_round(ctx, ("step.grads", "step.update"),
                           "incl_launches")
