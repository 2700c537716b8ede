"""95th percentile of the time from an agent sending a request to the
host holding its first token, over every request finished in the window."""
import numpy as np


def read(run):
    t = run.samples.get("ttft_s")
    return 1e3 * float(np.percentile(t, 95)) if t else None
