"""The port's training supervisor (``cli/train_supervisor.py``), as
``tests/test_supervisor.py`` holds the JAX one.

The restart budget, the resume argument and the relaunch decisions are
driven by a fake ``Popen`` with scripted exit codes. End to end, a tiny CPU
run is killed once its first checkpoint is complete (``checkpoints/index.json``
names ``last``, which is written before the index), not on a log line
polled every 0.5 s: the supervisor relaunches it with
``model.model_checkpoint_path=<job>/checkpoints/last`` and the finished run's
parameters equal an uninterrupted control run's.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more

from multimodalanalytical_tpu_torch.cli import train_supervisor as sup  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TEST_DATA = REPO / "tests" / "test_data" / "ir_dataset"
RUN_TIMEOUT_S = 600
SMALL_RUN = [
    "data=ir/patches", f"data_path={TEST_DATA}", "data.IR.preprocessor_arguments.patch_size=125",
    "data.Formula.column=molecular_formula", "model=custom_model", "molecules=True",
    "trainer.epochs=6", "model.d_model=64", "model.encoder_layers=1", "model.decoder_layers=1",
    "model.encoder_ffn_dim=128", "model.decoder_ffn_dim=128",
    "model.encoder_attention_heads=4", "model.decoder_attention_heads=4",
    "model.batch_size=8", "model.n_beams=2", "model.dtype=float32", "+device=cpu",
]


class FakeChild:
    pid = 4242

    def __init__(self, rc):
        self.rc = rc

    def wait(self):
        return self.rc


def _fake_popen(monkeypatch, codes, on_launch=None):
    """Children that exit with ``codes`` in turn; returns the commands run."""
    calls = []

    def popen(cmd):
        calls.append(cmd)
        if on_launch is not None:
            on_launch(len(calls))
        return FakeChild(codes[len(calls) - 1])

    monkeypatch.setattr(sup.subprocess, "Popen", popen)
    return calls


def test_restart_budget(monkeypatch, tmp_path):
    calls = _fake_popen(monkeypatch, [17, 17, 17])
    rc = sup.run_supervised([f"working_dir={tmp_path}", "job_name=j"], max_restarts=2,
                            backoff_s=0.0)
    assert rc == 17
    assert len(calls) == 3  # the first launch and 2 restarts
    assert all(cmd[1:3] == ["-m", "multimodalanalytical_tpu_torch.cli.training"]
               for cmd in calls)
    assert (tmp_path / "j" / "train.pid").read_text() == "4242"


def test_relaunch_resumes_from_last_once_it_exists(monkeypatch, tmp_path):
    """A death before any checkpoint relaunches afresh; one after a
    checkpoint resumes from ``last``, replacing a stale path argument."""
    last = tmp_path / "j" / "checkpoints" / "last"

    def on_launch(n):
        if n == 2:
            last.mkdir(parents=True)

    calls = _fake_popen(monkeypatch, [3, 5, 0], on_launch)
    args = [f"working_dir={tmp_path}", "job_name=j", "model.model_checkpoint_path=/stale"]
    assert sup.run_supervised(args, max_restarts=3, backoff_s=0.0) == 0
    assert len(calls) == 3
    assert calls[1][3:] == args
    assert calls[2][3:] == args[:2] + [f"model.model_checkpoint_path={last}"]


def test_resume_argument_replaces_a_stale_one():
    args = ["working_dir=/w", "job_name=j", "model.model_checkpoint_path=/stale"]
    out = sup._with_resume(args, Path("/w/j/checkpoints/last"))
    assert "model.model_checkpoint_path=/stale" not in out
    assert "model.model_checkpoint_path=/w/j/checkpoints/last" in out
    assert sup._arg_value(out, "job_name") == "j"
    assert sup._arg_value(out, "data_path") is None


def test_main_accepts_the_jax_supervisors_flags(monkeypatch, tmp_path):
    calls = _fake_popen(monkeypatch, [0])
    with pytest.raises(SystemExit) as exit_info:
        sup.main(["--max-restarts", "1", "--no-probe", "--backoff-s", "0", "--",
                  f"working_dir={tmp_path}", "job_name=j"])
    assert exit_info.value.code == 0
    assert calls[0][3:] == [f"working_dir={tmp_path}", "job_name=j"]


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def _last_step(job_dir: Path):
    """The step of the checkpoint that ``index.json`` names ``last``, once
    the index is readable."""
    try:
        index = json.loads((job_dir / "checkpoints" / "index.json").read_text())
    except (FileNotFoundError, json.JSONDecodeError):
        return None
    return (index.get("last") or {}).get("step")


def test_supervisor_survives_a_midrun_kill_and_matches_the_control(tmp_path):
    from multimodalanalytical_tpu_torch.training.checkpoint import restore_params

    if not (TEST_DATA / "ir_data.parquet").exists():
        sys.path.insert(0, str(REPO / "tests"))
        from make_fixture import main

        main(TEST_DATA)
    control = subprocess.run(
        [sys.executable, "-m", "multimodalanalytical_tpu_torch.cli.training",
         f"working_dir={tmp_path}", "job_name=control", *SMALL_RUN],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    assert control.returncode == 0, control.stdout[-3000:] + control.stderr[-3000:]

    victim = tmp_path / "victim"
    supervisor = subprocess.Popen(
        [sys.executable, "-m", "multimodalanalytical_tpu_torch.cli.train_supervisor",
         "--max-restarts", "2", "--no-probe", "--backoff-s", "0.5", "--",
         f"working_dir={tmp_path}", "job_name=victim", *SMALL_RUN],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        killed_at = None
        deadline = time.time() + RUN_TIMEOUT_S
        while time.time() < deadline and supervisor.poll() is None:
            killed_at = _last_step(victim)
            if killed_at is not None:
                os.kill(int((victim / "train.pid").read_text()), signal.SIGKILL)
                break
            time.sleep(0.02)
        out, _ = supervisor.communicate(timeout=RUN_TIMEOUT_S)
    finally:
        if supervisor.poll() is None:
            supervisor.kill()
            supervisor.communicate()
    assert killed_at is not None, "the run finished before its first checkpoint was seen"
    assert supervisor.returncode == 0, out[-3000:]
    assert "Training died" in out and "Relaunching with resume from" in out
    assert "Resumed from step" in (victim / "training.log").read_text()

    want = restore_params(tmp_path / "control" / "checkpoints" / "last")
    got = restore_params(victim / "checkpoints" / "last")
    assert want.keys() == got.keys()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
