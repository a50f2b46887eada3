"""puback_p99_ms: 99th percentile, over every message acknowledged in
the window, of the time from its submit to its acknowledgement's
resolution (the harness's clock)."""

import numpy as np


def read(run):
    if len(run.latencies_ms) == 0:
        return None
    return float(np.percentile(run.latencies_ms, 99))
