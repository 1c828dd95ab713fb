"""Training rate: every ray of every step completed in the window over the
whole window, which a synchronize on the last step's outputs closes."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.window["rays"] / ctx.window["seconds"]
