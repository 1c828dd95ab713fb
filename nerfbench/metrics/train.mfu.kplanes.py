"""K-Planes' train step's share of the card's bf16 peak: the field's model
FLOPs of the window's steps (its ``train_flops_per_ray``: per point the
density and color MLPs' forward and backward, no recompute; the plane
sampling does no FLOPs of the kind) over the window's seconds."""

from nerfbench import peaks, spec


def read(ctx):
    peak = peaks.peak(ctx.device_kind, "bf16_flops")
    if ctx.kind != "train" or peak is None:
        return None
    config = ctx.cell["config"]
    flops = spec.field(config).train_flops_per_ray(config) * ctx.window["rays"]
    return 100.0 * flops / ctx.window["seconds"] / peak
