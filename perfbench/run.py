"""Run one cell of the benchmark once and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell loads and warms up (``setup_s``), measures for ``--seconds``, then
checks what the timed path produced against the plain reference
(``perfbench/reference``) and prints one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, read from a bounded stretch
under ``torch.profiler``), ``device`` and, traced, ``breakdown``; last, under
``checks``, each compared number with its limit, which also end standard
error. A run on a machine without the CUDA devices the cell asks for exits
with 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench.harness import cell

    try:
        result, checks = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                  T_START)
    except (cell.NoDevice, cell.ForbiddenImport) as exc:
        print(f"perfbench: {exc}", file=sys.stderr, flush=True)
        return 2
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
