"""The port's entry points end to end on the CPU: ``tests/test_run.py``'s
train-then-predict through ``multimodalanalytical_tpu_torch.cli``, the port's
predict CLI on a JAX-trained checkpoint (carried as an ``.npz`` of the JAX
param tree) against the JAX predict CLI, ``cli/serve.py``'s
``build_server(config)`` round trip as ``tests/test_serve.py`` drives it, and
train, predict and serve on each shipped BART / T5 model config, with the
predict CLI on a converted reference checkpoint of each family.
"""

import json
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more

TEST_DATA = Path(__file__).parent / "test_data" / "ir_dataset"
TINY_MODEL = [
    "model.d_model=64", "model.encoder_layers=1", "model.decoder_layers=1",
    "model.encoder_ffn_dim=128", "model.decoder_ffn_dim=128",
    "model.encoder_attention_heads=4", "model.decoder_attention_heads=4",
    "model.batch_size=8", "model.n_beams=2", "model.dtype=float32",
]
# The port's entry points run on the card unless asked for the CPU.
CPU = "+device=cpu"
DATA = ["data=ir/patches", f"data_path={TEST_DATA}", "data.IR.preprocessor_arguments.patch_size=125",
        "data.Formula.column=molecular_formula", "model=custom_model", "molecules=True"]


@pytest.fixture(scope="module")
def fixture_dataset():
    if not (TEST_DATA / "ir_data.parquet").exists():
        sys.path.insert(0, str(Path(__file__).parent))
        from make_fixture import main

        main(TEST_DATA)
    return TEST_DATA


@pytest.fixture(scope="module")
def port_run(fixture_dataset, tmp_path_factory):
    """The port's training CLI, as tests/test_run.py runs the JAX one."""
    from multimodalanalytical_tpu_torch.cli import training

    run_dir = tmp_path_factory.mktemp("port_runs")
    training.main([f"working_dir={run_dir}", "job_name=train", *DATA, "trainer.epochs=2",
                   "trainer.acc_batches=1", f"profile_dir={run_dir / 'profile'}", *TINY_MODEL,
                   CPU])
    return run_dir


@pytest.mark.e2e
def test_training_then_predict(port_run):
    from multimodalanalytical_tpu_torch.cli import predict
    from multimodalanalytical_tpu_torch.training.checkpoint import restore_params

    metrics = json.loads((port_run / "train" / "metrics_beam_2.json").read_text())
    assert "Top-1" in metrics and 0.0 <= metrics["Top-1"] <= 1.0
    assert (port_run / "train" / "preprocessor.json").exists()
    for name in ("last", "best"):
        assert (port_run / "train" / "checkpoints" / name).exists()
    logits = json.loads((port_run / "train" / "test_data_logits_beam_2.json").read_text())
    assert all(len(p) == 2 for p in logits["predictions"]) and np.isfinite(logits["avg_loss"])
    params = restore_params(port_run / "train" / "checkpoints" / "last")
    assert all(torch.isfinite(v).all() for v in params.values())

    predict.main([f"working_dir={port_run}", "job_name=predict", *DATA,
                  f"preprocessor_path={port_run}/train/preprocessor.json",
                  f"model.model_checkpoint_path={port_run}/train/checkpoints/last", *TINY_MODEL,
                  CPU])
    assert "Top-1" in json.loads((port_run / "predict" / "metrics_beam_2.json").read_text())


@pytest.mark.e2e
def test_training_cli_forwards_profile_dir(port_run):
    """``profile_dir=...`` reaches ``Trainer.fit``: the run's train steps
    from global step 2 are traced there (the JAX trainer's window is 2-6;
    this run is shorter)."""
    traces = list((port_run / "profile").glob("train_steps_2-*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


@pytest.mark.parametrize("value,want", [("null", 600.0), ("0", 0.0), ("42.5", 42.5)])
def test_training_cli_reads_checkpoint_wait_timeout(fixture_dataset, tmp_path, monkeypatch,
                                                    value, want):
    """``trainer.checkpoint_wait_timeout_s`` reaches the trainer as the JAX
    CLI maps it: a YAML null takes 600 s, 0 stays 0 (abandon a running save
    at once)."""
    from multimodalanalytical_tpu_torch.cli import training

    class Stop(Exception):
        pass

    seen = []

    class Recording(training.Trainer):
        def fit(self, *args, **kwargs):
            seen.append(self.checkpoint_wait_timeout_s)
            raise Stop

    monkeypatch.setattr(training, "Trainer", Recording)
    with pytest.raises(Stop):
        training.main([f"working_dir={tmp_path}", "job_name=t", *DATA,
                       f"trainer.checkpoint_wait_timeout_s={value}", *TINY_MODEL, CPU])
    assert seen == [want]


@pytest.mark.e2e
@pytest.mark.parametrize("mode", ["true", "exact"])
def test_guided_generation_runs(fixture_dataset, tmp_path, mode):
    """``model.guided_generation`` through both CLIs: the training CLI's
    final predict and then the predict CLI on its checkpoint decode with
    the formula guide (``true``: the surrogate; ``exact``: the host
    formulas). With the surrogate each beam returned respects rule 3's
    heavy-atom bound against its target; the exact hook counts an invalid
    prefix as no atoms (the reference's semantics), so its bound holds only
    on valid prefixes and is not checked here."""
    from multimodalanalytical_tpu_torch.chem import atom_counts
    from multimodalanalytical_tpu_torch.cli import predict, training
    from multimodalanalytical_tpu_torch.generation.guided import (
        N_LOOKAHEAD,
        build_token_atom_table,
    )

    guided = f"model.guided_generation={mode}"
    training.main([f"working_dir={tmp_path}", "job_name=train", *DATA, "trainer.epochs=1",
                   "trainer.acc_batches=1", *TINY_MODEL, guided, CPU])
    predict.main([f"working_dir={tmp_path}", "job_name=predict", *DATA,
                  f"preprocessor_path={tmp_path}/train/preprocessor.json",
                  f"model.model_checkpoint_path={tmp_path}/train/checkpoints/last",
                  *TINY_MODEL, guided, CPU])
    checked = 0
    for job in ("train", "predict"):
        logits = json.loads((tmp_path / job / "test_data_logits_beam_2.json").read_text())
        assert "Top-1" in json.loads((tmp_path / job / "metrics_beam_2.json").read_text())
        for beams, target in zip(logits["predictions"], logits["targets"]):
            want = np.asarray(atom_counts(target))[:N_LOOKAHEAD]
            assert len(beams) == 2
            for beam in beams if mode == "true" else []:
                # the guide's own attribution of atoms to tokens (H never counts)
                vocab = {t: i for i, t in enumerate(sorted(set(beam.split())))}
                table = (build_token_atom_table(vocab, ["<pad>", "<unk>", "<bos>", "<eos>"])
                         if vocab else np.zeros((1, 14)))
                got = sum((table[vocab[t]] for t in beam.split()),
                          np.zeros(table.shape[1]))[:N_LOOKAHEAD]
                assert (got <= want).all(), (beam, target)
                checked += 1
    assert checked > 0 or mode == "exact"


@pytest.mark.e2e
def test_port_predict_on_a_jax_trained_checkpoint(fixture_dataset, tmp_path):
    """JAX training CLI -> JAX restore_params -> .npz -> the port's predict
    CLI: the same beams (fp32, exact strings) and the same metrics as the
    JAX predict CLI on the orbax checkpoint."""
    from multimodalanalytical_tpu.cli import predict as jax_predict
    from multimodalanalytical_tpu.cli import training as jax_training
    from multimodalanalytical_tpu.training.checkpoint import restore_params as jax_restore
    from multimodalanalytical_tpu_torch.cli import predict
    from multimodalanalytical_tpu_torch.training.checkpoint import save_flax_npz

    jax_training.main([f"working_dir={tmp_path}", "job_name=train", *DATA, "trainer.epochs=1",
                       "trainer.acc_batches=1", *TINY_MODEL])
    checkpoint = tmp_path / "train" / "checkpoints" / "last"
    npz = save_flax_npz(tmp_path / "jax_params.npz", jax_restore(checkpoint))
    common = [*DATA, f"preprocessor_path={tmp_path}/train/preprocessor.json", *TINY_MODEL]
    jax_predict.main([f"working_dir={tmp_path}", "job_name=jax", *common,
                      f"model.model_checkpoint_path={checkpoint}"])
    predict.main([f"working_dir={tmp_path}", "job_name=port", *common,
                  f"model.model_checkpoint_path={npz}", CPU])
    want = json.loads((tmp_path / "jax" / "test_data_logits_beam_2.json").read_text())
    got = json.loads((tmp_path / "port" / "test_data_logits_beam_2.json").read_text())
    assert got["predictions"] == want["predictions"] and got["targets"] == want["targets"]
    np.testing.assert_allclose(got["avg_loss"], want["avg_loss"], rtol=1e-5)
    assert (json.loads((tmp_path / "port" / "metrics_beam_2.json").read_text())
            == json.loads((tmp_path / "jax" / "metrics_beam_2.json").read_text()))


# The model configs at the executed-reference goldens' widths
# (tests/golden/reference_model_goldens.npz: d_model 32, 2 + 2 layers, 4
# heads, FFN 64), so that a reference checkpoint of that layout fits them.
PRESET_WIDTHS = ["d_model=32", "encoder_layers=2", "decoder_layers=2", "encoder_ffn_dim=64",
                 "decoder_ffn_dim=64", "encoder_attention_heads=4", "decoder_attention_heads=4"]
PRESET_DATA = [arg for arg in DATA if not arg.startswith("model=")]


def preset_model(name):
    """The overrides of PRESET_WIDTHS; t5_small's YAML names no widths (they
    come from its checkpoint name), so there they are added keys."""
    add = "+" if name == "t5_small" else ""
    return [f"{add}model.{w}" for w in PRESET_WIDTHS] + [
        "model.batch_size=8", "model.n_beams=2", "model.dtype=float32"]


@pytest.fixture(scope="module")
def preset_run(fixture_dataset, tmp_path_factory):
    """``preset_run(name)``: the working directory of one epoch of the
    training CLI on ``model=name`` at PRESET_WIDTHS (trained once)."""
    from multimodalanalytical_tpu_torch.cli import training

    runs = {}

    def run(name):
        if name not in runs:
            run_dir = tmp_path_factory.mktemp(name)
            training.main([f"working_dir={run_dir}", "job_name=train", *PRESET_DATA,
                           f"model={name}", "trainer.epochs=1", "trainer.acc_batches=1",
                           *preset_model(name), CPU])
            runs[name] = run_dir
        return runs[name]

    return run


def _predict(run_dir, name, checkpoint, job):
    from multimodalanalytical_tpu_torch.cli import predict

    predict.main([f"working_dir={run_dir}", f"job_name={job}", *PRESET_DATA, f"model={name}",
                  f"preprocessor_path={run_dir}/train/preprocessor.json",
                  f"model.model_checkpoint_path={checkpoint}", *preset_model(name), CPU])
    logits = json.loads((run_dir / job / "test_data_logits_beam_2.json").read_text())
    assert all(len(p) == 2 for p in logits["predictions"]) and np.isfinite(logits["avg_loss"])
    assert "Top-1" in json.loads((run_dir / job / "metrics_beam_2.json").read_text())
    return logits


@pytest.mark.e2e
@pytest.mark.parametrize("name", ["bart_medium", "hf_bart_medium", "custom_hf_bart", "t5_small"])
def test_each_preset_config_trains_and_predicts(preset_run, name):
    """The training CLI (one epoch, validation, checkpoints, the final beam
    predict) and then the predict CLI on its ``last`` checkpoint, on each
    shipped BART / T5 model config cut to 2 + 2 layers."""
    from multimodalanalytical_tpu_torch.training.checkpoint import restore_params

    run_dir = preset_run(name)
    train_logits = json.loads((run_dir / "train" / "test_data_logits_beam_2.json").read_text())
    params = restore_params(run_dir / "train" / "checkpoints" / "last")
    assert all(torch.isfinite(v).all() for v in params.values())
    assert any(".rel_bias." in k for k in params) == (name == "t5_small")
    logits = _predict(run_dir, name, run_dir / "train" / "checkpoints" / "last", "predict")
    assert logits["predictions"] == train_logits["predictions"]


@pytest.mark.e2e
@pytest.mark.parametrize("name, golden_case, prefix, head", [
    ("custom_model", "preln_plain_sincos", "embedding", "token_ff"),
    ("hf_bart_medium", "bart_executed_graph", "model.shared", "lm_head"),
    ("t5_small", "t5_executed_graph", "shared", "lm_head"),
])
def test_predict_cli_on_a_converted_reference_checkpoint(preset_run, tmp_path, name,
                                                         golden_case, prefix, head):
    """A Lightning checkpoint in the reference's key layout of each family
    (the golden state_dict, its data-dependent tensors, the token tables,
    the IR patch projection and the output head, taken from the training
    CLI's model so that they fit this dataset's vocabularies) goes through
    ``python -m ...cli.convert_reference_checkpoint`` into a directory that
    the predict CLI loads with ``model.model_checkpoint_path=``."""
    import re
    import subprocess

    from multimodalanalytical_tpu_torch.training.checkpoint import restore_params

    run_dir = preset_run(name)
    trained = restore_params(run_dir / "train" / "checkpoints" / "last")
    golden = np.load(Path(__file__).parent / "golden" / "reference_model_goldens.npz")
    start = f"{golden_case}/param/"
    state = {k[len(start):]: golden[k] for k in golden.files if k.startswith(start)}
    replaced = 0
    for key in state:
        table = re.match(rf"{re.escape(prefix)}\.embedding_layer_dict\.(\w+)\.(weight|bias)$", key)
        if table:
            modality, leaf = table.groups()
            port = f"embedding.embed_{modality}.{leaf}"
            port = port if port in trained else f"embedding.embed_{modality}.proj.{leaf}"
        elif re.match(rf"{head}\.(weight|bias)$", key):
            port = "lm_head." + key.split(".")[-1]
        else:
            continue
        state[key] = trained[port].numpy()
        replaced += 1
    assert replaced >= 4
    ckpt = tmp_path / "reference.ckpt"
    torch.save({"state_dict": {f"hf_model.{k}": torch.as_tensor(v) for k, v in state.items()},
                "epoch": 1}, ckpt)
    converted = tmp_path / "converted"
    result = subprocess.run(
        [sys.executable, "-m", "multimodalanalytical_tpu_torch.cli.convert_reference_checkpoint",
         str(ckpt), str(converted)], cwd=Path(__file__).resolve().parents[1],
        capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    _predict(run_dir, name, converted, "converted")


def _post(base, records):
    req = urllib.request.Request(f"{base}/predict", data=json.dumps({"records": records}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


@pytest.mark.e2e
@pytest.mark.parametrize("name", ["bart_medium", "hf_bart_medium", "custom_hf_bart", "t5_small"])
def test_each_preset_config_serves(preset_run, name):
    """``build_server(config)`` on each BART / T5 config's checkpoint: one
    record through ``/predict`` answers with its two beams and finite
    scores."""
    import pyarrow.parquet as pq

    from multimodalanalytical_tpu_torch.cli import serve
    from multimodalanalytical_tpu_torch.cli.common import compose

    run_dir = preset_run(name)
    config = compose("config_serve", [
        f"working_dir={run_dir}",
        *[a for a in PRESET_DATA if not a.startswith(("data_path=", "molecules="))],
        f"model={name}", f"preprocessor_path={run_dir / 'train' / 'preprocessor.json'}",
        f"model.model_checkpoint_path={run_dir / 'train' / 'checkpoints' / 'last'}",
        *preset_model(name), "serve.port=0", "serve.max_wait_ms=5", CPU])
    server = serve.build_server(config)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        table = pq.read_table(TEST_DATA / "ir_data.parquet")
        row = {c: table.column(c)[1].as_py() for c in table.column_names}
        record = {"IR": row["ir_spectra"], "Formula": row["molecular_formula"]}
        results = _post(f"http://127.0.0.1:{server.server_address[1]}", [record])["results"]
        assert len(results) == 1 and len(results[0]["smiles"]) == 2
        assert all(np.isfinite(results[0]["scores"]))
    finally:
        server.shutdown()
        server.engine.close()
        thread.join(timeout=60)
    assert not thread.is_alive()


@pytest.mark.e2e
def test_serve_roundtrip(port_run):
    """``build_server(config)`` from the port's checkpoint and artifact, as
    tests/test_serve.py drives the JAX server."""
    import pyarrow.parquet as pq

    from multimodalanalytical_tpu_torch.cli import serve
    from multimodalanalytical_tpu_torch.cli.common import compose

    config = compose("config_serve", [
        f"working_dir={port_run}", "data=ir/patches",
        "data.IR.preprocessor_arguments.patch_size=125", "data.Formula.column=molecular_formula",
        f"preprocessor_path={port_run / 'train' / 'preprocessor.json'}", "model=custom_model",
        f"model.model_checkpoint_path={port_run / 'train' / 'checkpoints' / 'last'}",
        *TINY_MODEL, "serve.port=0", "serve.max_wait_ms=5", CPU])
    server = serve.build_server(config)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["batch_size"] == 8 and health["n_beams"] == 2

        table = pq.read_table(TEST_DATA / "ir_data.parquet")
        row = {c: table.column(c)[0].as_py() for c in table.column_names}
        record = {"IR": row["ir_spectra"], "Formula": row["molecular_formula"]}
        results = _post(base, [record, record])["results"]
        assert len(results) == 2
        for res in results:
            assert len(res["smiles"]) == 2 and len(res["scores"]) == 2
            assert all(isinstance(s, str) for s in res["smiles"])
        assert results[0]["smiles"] == results[1]["smiles"]

        with pytest.raises(urllib.error.HTTPError):
            _post(base, [record] * 9)
        # A malformed record fails its own request; a concurrent good one
        # still succeeds.
        good_out = {}
        good = threading.Thread(target=lambda: good_out.update(_post(base, [record])))
        good.start()
        with pytest.raises(urllib.error.HTTPError):
            _post(base, [{"IR": "not-a-spectrum", "Formula": 42}])
        good.join(timeout=60)
        assert not good.is_alive()
        assert good_out["results"][0]["smiles"] == results[0]["smiles"]
    finally:
        server.shutdown()
        server.engine.close()
        thread.join(timeout=60)


@pytest.mark.parametrize("entry", ["training", "predict", "serve"])
def test_entry_points_refuse_to_fall_back_to_the_cpu(entry, tmp_path, monkeypatch):
    """With no CUDA device and no ``+device=cpu``, each entry point raises
    an error that names the override, before it reads any data: every path
    below is missing, so a read would fail otherwise."""
    import importlib

    from multimodalanalytical_tpu_torch.cli.common import compose

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = tmp_path / "missing"
    args = [f"working_dir={tmp_path}", "data=ir/patches", f"data_path={missing}",
            "model=custom_model", *TINY_MODEL, f"preprocessor_path={missing}/preprocessor.json",
            f"model.model_checkpoint_path={missing}/checkpoints/last"]
    if entry == "serve":
        args = [a for a in args if not a.startswith("data_path=")]
    config = compose({"training": "config_train", "predict": "config_predict",
                      "serve": "config_serve"}[entry], args)
    module = importlib.import_module(f"multimodalanalytical_tpu_torch.cli.{entry}")
    run = module.build_server if entry == "serve" else module.run
    with pytest.raises(RuntimeError, match=r"\+device=cpu"):
        run(config)
    assert not missing.exists()
    cpu = compose({"training": "config_train", "predict": "config_predict",
                   "serve": "config_serve"}[entry], args + [CPU])
    with pytest.raises((FileNotFoundError, OSError, ValueError)):
        run(cpu)   # with the override it goes on to the (missing) data
