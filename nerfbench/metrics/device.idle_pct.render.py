"""The share of the traced slice of frames in which no kernel, copy or fill
runs on the device (the union of the device's intervals)."""


def read(ctx):
    if ctx.kind != "view" or ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
