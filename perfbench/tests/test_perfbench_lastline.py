"""The result line's keys, and runs that must print no result."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench.harness import cell
from perfbench.tests.helpers import TINY_MODEL

REPO = Path(__file__).resolve().parents[2]
TINY = {"model": dict(TINY_MODEL), "traffic": {"batch": 4, "pool": 2, "warm_s": 0.2}}


def test_result_keys():
    result, checks = cell.run("ir_patches.decode", 2 ** 31 + 99, 0.5, False, time.perf_counter(),
                              require_device=False, overrides=json.loads(json.dumps(TINY)))
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["metrics"]) == {"setup_s", "spectra_per_s"}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == {"beam_gap_mean", "beam_order_gap"} == set(checks)
    json.loads(json.dumps(result))


def _run(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "ir_patches.decode",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_device_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure")
    out = _run(REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
