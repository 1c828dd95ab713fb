"""The K-Planes sampling kernels' share of the device's busy time in the
traced slice of train steps: the device seconds of the kernels named
``kplane_sample_fwd`` and ``kplane_sample_bwd`` over the union of the
device's intervals (kernels, copies, fills). None for a program without
them."""

from nerfbench.trace import device_seconds

KERNELS = ("kplane_sample_fwd", "kplane_sample_bwd")


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    seconds = device_seconds(ctx.trace, KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * seconds / ctx.trace["busy_s"]
