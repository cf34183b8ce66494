"""The 95th percentile of the walls of all decompress calls in the window
(NumPy's linear interpolation), in ms: what a reader of a stored object
waits."""

import numpy as np


def read(run):
    walls = [c.wall_s for c in run.calls if c.kind == "decompress"]
    if not walls:
        return None
    return 1e3 * float(np.percentile(walls, 95))
