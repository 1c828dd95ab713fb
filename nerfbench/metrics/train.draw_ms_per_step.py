"""The train step's host time drawing its inputs, per step: the total
length of the program's ``nerf.train.draw`` spans (every draw of a call put
on the device) over the steps of its ``nerf.train.call`` spans, kept while
the traced slices of calls ran, in milliseconds. None for a program without
the spans."""


def read(ctx):
    from minimal_nerf_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if ctx.kind != "train" or ctx.trace is None or spans is None:
        return None
    kept = spans()
    steps = sum(s.n for s in kept if s.name == "nerf.train.call")
    draws = [s for s in kept if s.name == "nerf.train.draw"]
    if not steps or not draws:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in draws) / steps
