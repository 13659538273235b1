"""The whole train round's share of the card's bf16 peak: the frozen
model FLOPs (6 · parameters · tokens, no recompute) of the window's
rounds over the window's host-clock length and 989 TFLOP/s.  None where
the round's FLOPs are not counted (a family that neither the yardstick
nor its reference module counts)."""

from bench.harness import yardstick


def read(ctx):
    if ctx["workload"]["kind"] != "train" or ctx["flops_per_round"] is None:
        return None
    flops = ctx["flops_per_round"] * ctx["rounds"]
    return 100.0 * flops / ctx["window_s"] / yardstick.PEAK_BF16_FLOPS
