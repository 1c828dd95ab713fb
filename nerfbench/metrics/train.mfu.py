"""The train step's share of the card's bf16 peak: the model FLOPs of the
window's steps (``counts.train_flops_per_ray``: per point the forward and
the backward without recompute) over the window's seconds."""

from nerfbench import counts, peaks


def read(ctx):
    peak = peaks.peak(ctx.device_kind, "bf16_flops")
    if ctx.kind != "train" or peak is None:
        return None
    flops = counts.train_flops_per_ray(ctx.cell["config"]["nerf"]) * ctx.window["rays"]
    return 100.0 * flops / ctx.window["seconds"] / peak
