"""The 95th percentile of the rounds' times over the whole window: the
device-stream time between consecutive rounds' ends (CUDA events).
Left out under twenty rounds, where it would be a maximum."""

import statistics


def read(ctx):
    times = ctx["round_ms"]
    if len(times) < 20:
        return None
    return statistics.quantiles(times, n=100)[94]
