"""``fairk_update``'s share of its memory roofline inside the round: the
bytes one fused pass over the packed buffer must move, at 3.35 TB/s,
over the kernel's device time per call in the traced window."""

from bench.harness import trace, yardstick


def read(ctx):
    hit = trace.kernel_time(ctx["trace"], "fairk_kernel")
    if hit is None:
        return None
    oac = ctx["workload"]["oac"]
    n_bytes = yardstick.fairk_update_bytes(
        ctx["d_packed"], bool(oac.get("error_feedback")),
        bool(oac.get("one_bit")))
    return yardstick.roofline_pct(n_bytes, hit[0] / hit[1])
