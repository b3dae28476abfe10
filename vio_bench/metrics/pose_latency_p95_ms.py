"""The 95th percentile of pose latency over all published frames of the
window: from a frame's hand-over to the return of the first harness call
after which the trajectory holds its pose (numpy's linear percentile)."""

import numpy as np


def read(run):
    lat = run["window"]["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
