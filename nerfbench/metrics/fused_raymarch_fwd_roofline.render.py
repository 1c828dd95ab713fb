"""The fused forward kernel's share of its roofline in the traced slice of
frames: the forward's model work for the slice's points at the bf16 peak,
over the device seconds of the forward kernel's launches."""

from nerfbench import counts, peaks
from nerfbench.trace import device_seconds

KERNELS = ("fused_fwd_sm90", "fused_fwd_kernel")


def read(ctx):
    peak = peaks.peak(ctx.device_kind, "bf16_flops")
    if ctx.kind != "view" or ctx.trace is None or peak is None:
        return None
    seconds = device_seconds(ctx.trace, KERNELS)
    if seconds <= 0:
        return None
    work = 2.0 * counts.fwd_macs(ctx.cell["config"]["nerf"]) * ctx.traced["points"]
    return 100.0 * work / peak / seconds
