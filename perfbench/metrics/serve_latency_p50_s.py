"""The median of the same requests as ``latency_p95_s``."""

import numpy as np


def read(record):
    latencies = record.get("latencies")
    if latencies is None or not len(latencies):
        return None
    return float(np.median(latencies))
