"""Serving cost: the whole window over the frames delivered to the host in
it, in milliseconds."""


def read(ctx):
    if ctx.kind != "view":
        return None
    return 1e3 * ctx.window["seconds"] / ctx.window["frames"]
