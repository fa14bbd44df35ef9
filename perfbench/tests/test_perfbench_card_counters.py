"""On the card: a traced two-second run of each decode cell prints the
beam search's own device times among its per-layer metrics, each > 0, and
a prologue shorter than the steps it starts.

    python -m pytest -m cuda perfbench/tests/test_perfbench_card_counters.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ir_patches.decode", "multimodal.decode"])
def test_traced_decode_prints_the_programs_device_times(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload, "--seed",
                          str(2 ** 31 + 43), "--seconds", "2", "--trace", "1"], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    metrics = {name: m["value"] for name, m in result["metrics"].items()}
    assert metrics["decode_prologue_ms"] > 0 and metrics["decode_step_ms"] > 0
    assert metrics["decode_prologue_ms"] < 127 * metrics["decode_step_ms"]
