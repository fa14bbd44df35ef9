"""On the card: every cell runs for two seconds, untraced and traced, and
prints a result line that parses and reads ``correct``; the control (the
reference in float8 in the program's place) fails each cell's limits; each
fault a cell can have, planted underneath its timed path, makes ``correct``
come out false at the cell's own size.

    python -m pytest -m cuda perfbench/tests/test_perfbench_card.py
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench.harness import cell

REPO = Path(__file__).resolve().parents[2]
with open(REPO / "BENCHMARK.json") as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]
NO_WARM_UP = {"traffic": {"warm_s": 0}}        # what the check reads needs no warm card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs(workload, trace):
    _card()
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload, "--seed",
                          str(2 ** 31 + 17), "--seconds", "2", "--trace", str(trace)], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["metrics"]
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    _card()
    result, checks = cell.run(workload, 2 ** 31 + 23, 2.0, False, time.perf_counter(),
                              control=True, overrides=NO_WARM_UP)
    control = result["control"]
    reading = control.get("fp8", control)      # a training cell also reads its faults
    failed = [name for name, (_, limit) in checks.items()
              if name in reading and reading[name] > limit]
    assert failed, control


FAULTS = {"decode_backlog": ("token_altered", "half_batch", "topk_not_best"),
          "serve_open": ("token_altered", "half_batch", "topk_not_best"),
          "train_fit": ("state_unchanged", "half_batch")}
CELL_FAULTS = [(w, f) for w in CELLS
               for f in FAULTS[cell.load_json("workloads", w)["driver"]]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", CELL_FAULTS, ids=lambda x: x)
def test_fault_not_correct(workload, fault):
    _card()
    result, _ = cell.run(workload, 2 ** 31 + 29, 2.0, False, time.perf_counter(), fault=fault,
                         overrides=NO_WARM_UP)
    assert result["correct"] is False, result["checks"]
