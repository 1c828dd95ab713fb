"""The view sweep's share of the card's bf16 peak: the forward's model
FLOPs of the window's frames (``counts.render_flops_per_ray``) over the
window's seconds."""

from nerfbench import counts, peaks


def read(ctx):
    peak = peaks.peak(ctx.device_kind, "bf16_flops")
    if ctx.kind != "view" or peak is None:
        return None
    flops = counts.render_flops_per_ray(ctx.cell["config"]["nerf"]) * ctx.window["rays"]
    return 100.0 * flops / ctx.window["seconds"] / peak
