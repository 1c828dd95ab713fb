"""The viewer's tail: the 90th percentile of every request's latency in the
window (request sent to frame on the host), in milliseconds."""

import numpy as np


def read(ctx):
    if ctx.kind != "view":
        return None
    return 1e3 * float(np.percentile(ctx.window["latencies"], 90))
