"""The whole train round's share of the card's bf16 peak: the frozen
model FLOPs (6 · parameters · tokens, no recompute) of the window's
rounds over the window's host-clock length and 989 TFLOP/s."""

from bench.harness import yardstick


def read(ctx):
    if ctx["workload"]["kind"] != "train":
        return None
    flops = ctx["flops_per_round"] * ctx["rounds"]
    return 100.0 * flops / ctx["window_s"] / yardstick.PEAK_BF16_FLOPS
