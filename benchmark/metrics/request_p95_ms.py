"""request_p95_ms: the 95th percentile of every request's latency in the
window, submit to completion on the host clock (linear interpolation
between order statistics)."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95.0)) * 1e3
