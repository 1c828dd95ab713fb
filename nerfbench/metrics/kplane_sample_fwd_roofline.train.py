"""The K-Planes sampling forward kernel's share of its roofline in the
traced slice of train steps: the bytes that no version can avoid for the
slice's points, ``points * (12 + 4 S C)`` (each fp32 position read once,
the ``S C`` fp32 features written once; the field's
``plane_bytes_per_point``), at the card's HBM peak, over the device seconds
of the kernels named ``kplane_sample_fwd``. The planes' own reads are left
out (how much of them any kernel must move depends on which rows the
points share), and so are the grid updates' points, which the same kernel
samples: the count is a floor, and the share cannot pass 100%. None for a
program without the kernel or a field without the count."""

from nerfbench import peaks, spec
from nerfbench.trace import device_seconds

KERNELS = ("kplane_sample_fwd",)


def read(ctx):
    peak = peaks.peak(ctx.device_kind, "hbm_bytes_per_s")
    if ctx.kind != "train" or ctx.trace is None or peak is None:
        return None
    per_point = getattr(spec.field(ctx.cell["config"]), "plane_bytes_per_point", None)
    seconds = device_seconds(ctx.trace, KERNELS)
    if per_point is None or seconds <= 0:
        return None
    return 100.0 * per_point(ctx.cell["config"]) * ctx.traced["points"] / peak / seconds
