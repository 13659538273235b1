"""The device's idle share of the traced window: one minus the union of
its operations' intervals over the window's length."""


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
