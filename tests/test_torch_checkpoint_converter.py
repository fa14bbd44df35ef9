"""The port's reference-checkpoint converter, end to end (the counterpart of
``tests/test_checkpoint_converter.py``).

A Lightning-style checkpoint file (``state_dict`` under the ``hf_model.``
prefix, with the wrapper's duplicate ``multimodal_embedding.`` entries and
training metadata) is written from the committed executed-reference goldens
for CustomModel, BART and T5, converted by
``python -m multimodalanalytical_tpu_torch.cli.convert_reference_checkpoint``
as a user would run it, restored through the paths the port's CLIs take
(``load_params``, ``load_finetune_params``), and must give the reference's
fp32 logits at the JAX test's tolerances.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more

from multimodalanalytical_tpu_torch.cli import convert_reference_checkpoint as converter  # noqa: E402,E501
from multimodalanalytical_tpu_torch.models.torch_mapping import detect_model_family  # noqa: E402
from multimodalanalytical_tpu_torch.training.checkpoint import (  # noqa: E402
    load_finetune_params,
    load_params,
)
from test_reference_model_parity import CASES, HF_CASES, _case_arrays  # noqa: E402
from test_torch_reference_parity import GOLDEN, hf_port_model, port_model, run_case  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CUSTOM = "preln_geglu_alignconv_sincos"   # GEGLU + conv align + sincos


def lightning_ckpt(sd, path):
    state = {f"hf_model.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    # The wrapper holds a second reference to the embedding module; its
    # duplicated keys must be ignored on convert.
    prefix = next(p for p in ("model.shared.", "shared.", "embedding.")
                  if any(k.startswith(p) for k in sd))
    for k, v in sd.items():
        if k.startswith(prefix):
            state[f"multimodal_embedding.{k[len(prefix):]}"] = torch.from_numpy(
                np.ascontiguousarray(v))
    torch.save({"state_dict": state, "epoch": 3, "global_step": 42,
                "pytorch-lightning_version": "2.0.0"}, path)


def convert(*args):
    """The converter as a user runs it, in a process of its own."""
    return subprocess.run([sys.executable, "-m",
                           "multimodalanalytical_tpu_torch.cli.convert_reference_checkpoint",
                           *map(str, args)], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ))


def model_and_case(name):
    if name in HF_CASES:
        return hf_port_model(HF_CASES[name][0]), {}
    return port_model(CASES[name]), CASES[name]


@pytest.mark.parametrize("name", [CUSTOM, *HF_CASES])
def test_lightning_ckpt_roundtrips_to_reference_logits(tmp_path, name):
    golden = np.load(GOLDEN, allow_pickle=False)
    sd, ins, outs = _case_arrays(golden, name)
    ckpt, out_dir = tmp_path / "reference.ckpt", tmp_path / "converted"
    lightning_ckpt(sd, ckpt)
    result = convert(ckpt, out_dir)
    assert result.returncode == 0, f"converter failed:\n{result.stdout}\n{result.stderr}"
    assert "param arrays" in result.stdout and (out_dir / "state.pt").is_file()
    for restore in ("load_params", "load_finetune_params"):
        model, case = model_and_case(name)
        if restore == "load_params":
            load_params(out_dir, model)
        else:
            params, dropped = load_finetune_params(out_dir, model, strip_align=False)
            model.load_state_dict(params)
            assert dropped == 0
        res = run_case(model, case, ins)
        np.testing.assert_allclose(res["logits"].double().numpy(), outs["logits"], rtol=2e-4,
                                   atol=2e-5, err_msg=f"{name} via {restore}")
        loss = "model_only_loss" if "model_only_loss" in outs else "loss"
        np.testing.assert_allclose(float(res[loss]), float(outs[loss]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name, family", [(CUSTOM, "CustomModel"),
                                          *[(n, f) for n, (f, _) in HF_CASES.items()]])
def test_family_detection_and_explicit_family(tmp_path, name, family):
    """Each family is detected from its keys; naming it gives the same
    checkpoint, bit for bit."""
    golden = np.load(GOLDEN, allow_pickle=False)
    sd, _, _ = _case_arrays(golden, name)
    assert detect_model_family(sd) == family
    ckpt = tmp_path / "reference.ckpt"
    # a bare state_dict, no Lightning wrapper
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, ckpt)
    assert converter.main([str(ckpt), str(tmp_path / "auto")]) == 0
    assert converter.main([str(ckpt), str(tmp_path / "named"), "--family", family]) == 0
    auto = torch.load(tmp_path / "auto" / "state.pt", weights_only=True)["params"]
    named = torch.load(tmp_path / "named" / "state.pt", weights_only=True)["params"]
    assert sorted(auto) == sorted(named)
    assert all(torch.equal(auto[k], named[k]) for k in auto)


def test_an_existing_output_directory_is_refused(tmp_path):
    golden = np.load(GOLDEN, allow_pickle=False)
    sd, _, _ = _case_arrays(golden, "t5_executed_graph")
    ckpt, out_dir = tmp_path / "reference.ckpt", tmp_path / "converted"
    lightning_ckpt(sd, ckpt)
    out_dir.mkdir()
    (out_dir / "keep.txt").write_text("mine")
    result = convert(ckpt, out_dir)
    assert result.returncode != 0 and "already exists" in result.stderr
    assert sorted(p.name for p in out_dir.iterdir()) == ["keep.txt"]


def test_a_checkpoint_with_pickled_metadata_falls_back_with_a_warning(tmp_path, capsys):
    """A Lightning checkpoint whose hyper_parameters are an arbitrary object
    needs the full unpickler, which runs only after a warning."""
    golden = np.load(GOLDEN, allow_pickle=False)
    sd, _, _ = _case_arrays(golden, CUSTOM)
    ckpt = tmp_path / "reference.ckpt"
    torch.save({"state_dict": {f"hf_model.{k}": torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()},
                "hyper_parameters": Path("model.yaml")}, ckpt)
    arrays = converter.load_state_dict(ckpt)
    assert "only convert checkpoints you trust" in capsys.readouterr().err
    assert sorted(arrays) == sorted(f"hf_model.{k}" for k in sd)
