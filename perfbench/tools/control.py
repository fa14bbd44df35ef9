"""Read a cell's compared numbers for the program and for the control.

    python3 perfbench/tools/control.py --workload <cell> --seeds 11,12,13 [--seconds 2]

For each seed, one run of the cell (``--seconds`` long, no warm-up) whose
check also puts the reference in float8 e4m3 (per-tensor scales on every
projection's input and weight: one precision step below the
configuration's bfloat16) in the program's place; for a training cell also the reference with half
of each batch left out. Prints one JSON line per seed: the program's
numbers, the control's and their limits. The benchmark's own runs never
run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args()

    from perfbench.harness import cell

    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks = cell.run(args.workload, seed, args.seconds, False, time.perf_counter(),
                                  control=True, overrides={"traffic": {"warm_s": 0}})
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": {**{k: v for k, (v, _) in checks.items()},
                                      **result["readings"]},
                          "limits": {k: lim for k, (_, lim) in checks.items()},
                          "control": result["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
