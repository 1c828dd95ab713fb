"""Set-up: seconds from the run's start to its first timed unit (the
inputs made, the program built, loaded and warmed up, the output check's
first steps)."""


def read(ctx):
    return ctx.setup_s
