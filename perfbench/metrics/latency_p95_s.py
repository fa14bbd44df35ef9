"""The 95th percentile of every request due in the window, timed from when
it was due until its result was set; a failed request counts as missing
(infinitely late)."""

import numpy as np


def read(record):
    latencies = record.get("latencies")
    if latencies is None or not len(latencies):
        return None
    return float(np.percentile(latencies, 95))
