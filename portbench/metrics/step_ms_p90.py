"""The 90th percentile of the host time of a training step, over every step
of the window, each timed to its loss read (host clock)."""

import numpy as np


def read(ctx):
    times = ctx.window.get('step_s')
    if not times:
        return None
    return 1000.0 * float(np.percentile(times, 90))
