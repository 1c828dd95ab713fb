"""The view sweep's host time per chunk: the mean length of the program's
``nerf.view.chunk`` spans (a chunk's rays, generator and render call, as
the host enqueues them) kept while the traced slices of frames ran, in
milliseconds. None for a program without the span."""


def read(ctx):
    from minimal_nerf_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if ctx.kind != "view" or ctx.trace is None or spans is None:
        return None
    chunks = [s for s in spans() if s.name == "nerf.view.chunk"]
    if not chunks:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in chunks) / len(chunks)
