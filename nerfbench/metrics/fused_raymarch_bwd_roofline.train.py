"""The fused backward kernels' share of their roofline in the traced slice:
the model's backward work for the slice's points (``counts.bwd_macs``,
weight and activation gradients without the recomputed forward) at the
bf16 peak, over the device seconds of the kernels the backward launches
(per-ray kernel, weight-gradient products, the fixed-order reductions)."""

from nerfbench import counts, peaks
from nerfbench.trace import device_seconds

KERNELS = ("fused_bwd_kernel", "wgrad_mma_kernel", "wgrad_fma_kernel", "reduce_slices",
           "reduce_rows")


def read(ctx):
    peak = peaks.peak(ctx.device_kind, "bf16_flops")
    if ctx.kind != "train" or ctx.trace is None or peak is None:
        return None
    seconds = device_seconds(ctx.trace, KERNELS)
    if seconds <= 0:
        return None
    work = 2.0 * counts.bwd_macs(ctx.cell["config"]["nerf"]) * ctx.traced["points"]
    return 100.0 * work / peak / seconds
