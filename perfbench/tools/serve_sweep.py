"""Sweep the serving cell's offered rate to find the highest it sustains.

    python3 perfbench/tools/serve_sweep.py --rates 300,400,500 [--seconds 20] [--seed 1]

One process; for each rate, one run of ``ir_patches.serve_open``'s driver at
that rate. Prints per rate: requests, answered, p50 and p95 latency, and the
backlog's growth: the median latency of the last quarter of the requests
over that of the second quarter (a queue that grows all through the run
reads well above 1). The sustained rate is the highest whose growth stays
near 1; the cell offers four fifths of it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--workload", default="ir_patches.serve_open")
    args = parser.parse_args()

    from perfbench.harness import cell

    workload = cell.load_json("workloads", args.workload)
    config = cell.load_json("configs", workload["config"])
    driver = cell.load_module("drivers", workload["driver"])
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = dict(workload["traffic"], rate_per_s=rate, check_requests=8)
        ctx = cell.Context(config, traffic, args.seed, args.seconds, False,
                           "cuda", time.perf_counter())
        record = driver.run(ctx, lambda s: print(s, file=sys.stderr, flush=True))
        lat = np.asarray(record["latencies"])
        n = len(lat)
        growth = float(np.median(lat[3 * n // 4:]) / np.median(lat[n // 4:n // 2]))
        print(json.dumps({"rate": rate, "requests": n, "failed": record["failed"],
                          "p50_s": float(np.median(lat)), "p95_s": float(np.percentile(lat, 95)),
                          "answered_per_s": (n - record["failed"]) / args.seconds,
                          "backlog_growth": growth}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
