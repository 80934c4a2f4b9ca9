"""Mean over the window's lane steps of the batch's deepest exit less the
lane's own: the layers a lane runs past its exit because the batch runs
to its deepest lane."""

import numpy as np


def read(r):
    ex = r.get("dispatch_exits")
    if not ex:
        return None
    return float(np.mean([np.mean(np.max(e) - np.asarray(e)) for e in ex]))
