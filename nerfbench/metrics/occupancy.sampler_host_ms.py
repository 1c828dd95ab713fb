"""The occupancy sampler hook's host time per call: the mean length of the
program's ``nerf.occupancy.sample`` spans (the hook's draws and its kernel's
launch) kept while the traced slices ran, in milliseconds. None for a
program without the span."""


def read(ctx):
    from minimal_nerf_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if ctx.trace is None or spans is None:
        return None
    calls = [s for s in spans() if s.name == "nerf.occupancy.sample"]
    if not calls:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in calls) / len(calls)
