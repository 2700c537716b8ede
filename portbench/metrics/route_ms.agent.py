"""Mean host time of a `route_batch` call in the window (it returns numpy,
so it has waited for the device)."""
import numpy as np


def read(run):
    t = run.samples.get("route_s")
    return 1e3 * float(np.mean(t)) if t else None
