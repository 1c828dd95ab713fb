"""The train step's host time per step: the total length of the program's
``nerf.train.call`` spans (a call's draws, grid updates, eager bodies or
replays, as the host enqueues them) over their steps, kept while the traced
slices of calls ran, in milliseconds. None for a program without the
span."""


def read(ctx):
    from minimal_nerf_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if ctx.kind != "train" or ctx.trace is None or spans is None:
        return None
    calls = [s for s in spans() if s.name == "nerf.train.call"]
    if not calls:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in calls) / sum(s.n for s in calls)
