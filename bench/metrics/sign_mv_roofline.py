"""``sign_mv``'s share of its memory roofline inside the round: the (1, d)
vote over the packed buffer with channel noise, at 3.35 TB/s, over the
kernel's device time per call in the traced window."""

from bench.harness import trace, yardstick


def read(ctx):
    hit = trace.kernel_time(ctx["trace"], "sign_mv_kernel")
    if hit is None:
        return None
    noise = ctx["workload"]["oac"].get("noise_std", 0.0) > 0
    n_bytes = yardstick.sign_mv_bytes(1, ctx["d_packed"], noise)
    return yardstick.roofline_pct(n_bytes, hit[0] / hit[1])
