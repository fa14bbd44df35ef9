"""The multimodal slice through the port against the JAX package.

Formula + 1H-NMR multiplets + 13C-NMR peaks + IR patches -> SMILES on a
tiny model with ragged masks (each NMR modality padded to the collator's
fixed width, one row without carbon data): fp32 beams token for token at K
1 / 4 / 30, with the multiplets as token ids and as XVal dicts; the
trainer's ``device_batch`` and ``modality_segments`` on dict inputs;
``InferenceEngine.decode_batch`` on dict payloads; train steps on an XVal
batch against the JAX ``Trainer``; and the training and predict CLIs on
``data=multimodal/*`` and on the align recipe, with ``+device=cpu``, from a
small parquet of seeded peaks written into the test's directory.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
jnp = jax.numpy

from multimodalanalytical_tpu.generation.beam_search import beam_search as jax_beam_search  # noqa: E402,E501
from multimodalanalytical_tpu.models import ModelConfig as JaxConfig  # noqa: E402
from multimodalanalytical_tpu.models import Seq2SeqModel as JaxModel  # noqa: E402
from multimodalanalytical_tpu.parallel.mesh import make_mesh, shard_batch  # noqa: E402
from multimodalanalytical_tpu.training import trainer as jax_trainer  # noqa: E402
from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine  # noqa: E402
from multimodalanalytical_tpu_torch.generation.beam_search import beam_search  # noqa: E402
from multimodalanalytical_tpu_torch.models.config import ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.models.weights import load_flax_params  # noqa: E402
from multimodalanalytical_tpu_torch.training.trainer import (  # noqa: E402
    Trainer,
    device_batch,
    modality_segments,
)
from test_torch_embedding import to_torch  # noqa: E402
from test_torch_model import random_params  # noqa: E402
from test_torch_train import OPTIMISER, _check, load_params_as_numpy  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
IR_DATA = REPO / "tests" / "test_data" / "ir_dataset" / "ir_data.parquet"
VOCAB = 64                 # > 30: the first expansion offers K 30 candidates
FORMULA, MULTIPLETS, CARBON, PATCHES, PATCH = 6, 15, 8, 4, 16
MAX_LENGTH = 14
ORDER = ["Formula", "Multiplets", "Carbon", "IR", "Smiles"]


def data_config():
    def tokens(mtype, vocab):
        return {"type": mtype, "column": mtype, "target": False, "vocab_size": vocab,
                "pad_token_id": 0, "preprocessor_arguments": {}}
    return {"Formula": tokens("text", 20), "Multiplets": tokens("multiplets", 40),
            "Carbon": tokens("carbon", 30),
            "IR": {"type": "1D_patches", "column": "ir", "target": False,
                   "preprocessor_arguments": {"patch_size": PATCH}},
            "Smiles": {"type": "text", "column": "s", "target": True, "vocab_size": VOCAB,
                       "pad_token_id": 0, "preprocessor_arguments": {}}}


def multimodal_batch(batch=3, xval=False, seed=0, target_len=10):
    """Collator-style batch: each source padded to its fixed width, ragged
    rows masked, row 1 without carbon data (its span fully masked)."""
    rng = np.random.default_rng(seed)
    widths = {"Formula": FORMULA, "Multiplets": MULTIPLETS, "Carbon": CARBON}
    vocab = {"Formula": 20, "Multiplets": 40, "Carbon": 30}
    inputs, masks = {}, []
    for name, width in widths.items():
        lengths = rng.integers(2, width + 1, batch)
        if name == "Carbon":
            lengths[1] = 0
        keep = np.arange(width)[None, :] < lengths[:, None]
        inputs[name] = np.where(keep, rng.integers(4, vocab[name], (batch, width)),
                                0).astype(np.int32)
        masks.append(keep)
    if xval:
        values = np.where(masks[1], rng.normal(1.0, 0.4, (batch, MULTIPLETS)), 1.0)
        inputs["Multiplets"] = {"tokenized_input": inputs["Multiplets"],
                                "numerical_values": values.astype(np.float32)}
    inputs["IR"] = rng.random((batch, PATCHES, PATCH)).astype(np.float32)
    masks.append(np.ones((batch, PATCHES), bool))
    labels = rng.integers(4, VOCAB, (batch, target_len)).astype(np.int32)
    labels[0, 7:] = -100
    return {"encoder_inputs": inputs,
            "encoder_mask": np.concatenate(masks, axis=1).astype(np.int32),
            "decoder_ids": rng.integers(4, VOCAB, (batch, target_len)).astype(np.int32),
            "decoder_mask": (labels != -100).astype(np.int32), "labels": labels,
            "n_valid": batch}


def model_pair(layers=2, dropout=0.0, seed=1):
    cfg = JaxConfig(d_model=32, encoder_layers=layers, decoder_layers=layers,
                    encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
                    decoder_ffn_dim=64, vocab_size=VOCAB, dropout=dropout,
                    max_target_length=MAX_LENGTH)
    jmodel = JaxModel(config=cfg, data_config=data_config(), target_modality="Smiles")
    b = multimodal_batch(xval=True)
    shapes = jax.eval_shape(lambda key: jmodel.init(
        key, b["encoder_inputs"], b["encoder_mask"], b["decoder_ids"], b["decoder_mask"],
        b["labels"], deterministic=True), jax.random.PRNGKey(0))
    params = random_params(shapes["params"], seed)
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 4.0
    model = Seq2SeqModel(ModelConfig(**dataclasses.asdict(cfg)), data_config(), "Smiles")
    load_flax_params(model, params)
    return jmodel, {"params": params}, model


@pytest.fixture(scope="module")
def pair():
    return model_pair()


@pytest.mark.parametrize("xval", [False, True], ids=["ids", "xval"])
@pytest.mark.parametrize("beams", [1, 4, 30])
def test_beams_match_jax_token_for_token(pair, beams, xval):
    jmodel, variables, model = pair
    b = multimodal_batch(xval=xval, seed=2)
    want_seqs, want_scores = jax_beam_search(jmodel, variables, b["encoder_inputs"],
                                             jnp.asarray(b["encoder_mask"]), num_beams=beams,
                                             max_length=MAX_LENGTH)
    t = to_torch(b)
    seqs, scores = beam_search(model, t["encoder_inputs"], t["encoder_mask"], num_beams=beams,
                               max_length=MAX_LENGTH)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("xval", [False, True], ids=["ids", "xval"])
def test_forward_matches_jax(pair, xval):
    jmodel, variables, model = pair
    b = multimodal_batch(xval=xval, seed=3)
    keys = ("encoder_mask", "decoder_ids", "decoder_mask", "labels")
    want = jax.jit(lambda v, e, *a: jmodel.apply(v, e, *a, deterministic=True))(
        variables, b["encoder_inputs"], *(b[k] for k in keys))
    t = to_torch({k: b[k] for k in ("encoder_inputs",) + keys})
    with torch.no_grad():
        got = model(t["encoder_inputs"], *(t[k] for k in keys))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)


def test_device_batch_and_segments_on_dict_inputs():
    b = multimodal_batch(xval=True)
    b["align_target"] = np.ones((3, 7), np.float32)
    b["target_strings"] = ["C", "CC", "CCC"]
    dev = device_batch(b, torch.device("cpu"))
    assert set(dev) == {"encoder_inputs", "encoder_mask", "decoder_ids", "decoder_mask",
                        "labels", "align_target"}
    payload = dev["encoder_inputs"]["Multiplets"]
    assert isinstance(payload, dict) and set(payload) == {"tokenized_input", "numerical_values"}
    assert all(isinstance(x, torch.Tensor) for x in payload.values())
    np.testing.assert_array_equal(payload["numerical_values"].numpy(),
                                  b["encoder_inputs"]["Multiplets"]["numerical_values"])
    want = jax_trainer._modality_segments(b["encoder_inputs"], order=ORDER)
    assert modality_segments(b["encoder_inputs"], ORDER) == want
    assert modality_segments(dev["encoder_inputs"], ORDER) == want
    assert want[1] == ("Multiplets", FORMULA, FORMULA + MULTIPLETS)
    assert want[-1][2] == b["encoder_mask"].shape[1]


def test_modality_dropout_on_a_dict_batch():
    """Train steps with modality dropout over Multiplets, Carbon and IR on
    an XVal batch: the dropped spans are the dict-aware segments, every
    loss finite."""
    _, _, model = model_pair(layers=1, dropout=0.1)
    trainer = Trainer(model, optimiser="adamw", lr=1e-3, num_steps=4, seed=0,
                      modality_dropout=["Multiplets", "Carbon", "IR"])
    seen = []
    original = trainer.model.forward

    def spy(encoder_inputs, encoder_mask, *args, **kwargs):
        seen.append(encoder_mask.clone())
        return original(encoder_inputs, encoder_mask, *args, **kwargs)

    trainer.model.forward = spy
    b = multimodal_batch(xval=True, seed=4)
    losses = [float(trainer.train_step(b)["loss"]) for _ in range(4)]
    assert np.isfinite(losses).all()
    mask = torch.as_tensor(b["encoder_mask"])
    spans = {m: (s, e) for m, s, e in modality_segments(b["encoder_inputs"], ORDER)}
    dropped_any = False
    for got in seen:
        assert torch.equal(got[:, :FORMULA], mask[:, :FORMULA])
        for name in ("Multiplets", "Carbon", "IR"):
            s, e = spans[name]
            kept = torch.equal(got[:, s:e], mask[:, s:e])
            assert kept or not got[:, s:e].any(), name
            dropped_any |= not kept
    assert dropped_any


@pytest.fixture(scope="module")
def xval_run():
    """3 steps of the JAX Trainer and the port's on XVal batches (dropout 0)."""
    jmodel, _, model = model_pair(layers=1)
    batches = [multimodal_batch(batch=2, xval=True, seed=20 + i) for i in range(3)]
    mesh = make_mesh(devices=jax.devices()[:1])
    jt = jax_trainer.Trainer(jmodel, None, mesh=mesh, seed=0, **OPTIMISER)
    state = jax.jit(jt.init_state)(batches[0])
    init_params = jax.device_get(state.params)
    step = jt._build_train_step(jax_trainer._modality_segments(
        batches[0]["encoder_inputs"], order=ORDER))
    want_losses, want_params = [], []
    for batch in batches:
        state, metrics = step(state, shard_batch(jax_trainer._device_batch(batch), mesh), {})
        want_losses.append(float(metrics["loss"]))
        want_params.append(load_params_as_numpy(jax.device_get(state.params)))
    load_flax_params(model, init_params)
    trainer = Trainer(model, seed=0, **OPTIMISER)
    got_losses, got_params = [], []
    for batch in batches:
        got_losses.append(float(trainer.train_step(batch)["loss"]))
        got_params.append({k: p.detach().numpy().copy() for k, p in model.named_parameters()})
    return want_losses, want_params, got_losses, got_params


@pytest.mark.parametrize("steps", [1, 3])
def test_xval_trainer_matches_jax_trainer(xval_run, steps):
    _check(xval_run, steps)


def test_decode_batch_takes_dict_payloads(pair):
    """The serving engine on numpy batches with XVal dicts (as the collator
    gives them): the JAX beams, and a second request with another encoder
    length decodes through its own shape."""
    jmodel, variables, model = pair
    engine = InferenceEngine(model, n_beams=4, batch_size=3)
    for seed, carbon in ((5, CARBON), (6, CARBON - 3)):
        b = multimodal_batch(xval=True, seed=seed)
        b["encoder_inputs"]["Carbon"] = b["encoder_inputs"]["Carbon"][:, :carbon]
        b["encoder_mask"] = np.delete(b["encoder_mask"],
                                      np.s_[FORMULA + MULTIPLETS + carbon:
                                            FORMULA + MULTIPLETS + CARBON], axis=1)
        seqs, scores = engine.decode_batch(b["encoder_inputs"], b["encoder_mask"])
        want_seqs, want_scores = jax_beam_search(
            jmodel, variables, b["encoder_inputs"], jnp.asarray(b["encoder_mask"]),
            num_beams=4, max_length=MAX_LENGTH)
        np.testing.assert_array_equal(seqs, np.asarray(want_seqs))
        np.testing.assert_allclose(scores, np.asarray(want_scores), rtol=1e-5, atol=1e-6)
    assert len(engine.decoder._decodes) == 2


# ------------------------------------------------------------------- CLIs
TINY_MODEL = [
    "model.d_model=32", "model.encoder_layers=1", "model.decoder_layers=1",
    "model.encoder_ffn_dim=64", "model.decoder_ffn_dim=64",
    "model.encoder_attention_heads=4", "model.decoder_attention_heads=4",
    "model.batch_size=8", "model.n_beams=2", "model.dtype=float32", "+device=cpu",
    "trainer.epochs=1", "trainer.acc_batches=1",
]
CATEGORIES = ["s", "d", "t", "q", "m", "dd"]


@pytest.fixture(scope="module")
def multimodal_data(tmp_path_factory):
    """The IR test dataset's molecules with seeded multiplets (2-5 each) and
    carbon peaks (3-8 each), as a parquet in a fresh directory."""
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    src = pq.read_table(IR_DATA).to_pydict()
    rng = np.random.default_rng(0)
    h_nmr, c_nmr = [], []
    for _ in src["smiles"]:
        peaks = []
        for _ in range(int(rng.integers(2, 6))):
            high = round(float(rng.uniform(0.5, 12.0)), 2)
            peaks.append({"rangeMax": high, "rangeMin": round(high - float(rng.uniform(0, .3)), 2),
                          "category": CATEGORIES[int(rng.integers(len(CATEGORIES)))],
                          "nH": int(rng.integers(1, 4)), "j_values": None})
        h_nmr.append(peaks)
        c_nmr.append([{"delta (ppm)": round(float(rng.uniform(0, 230)), 1),
                       "intensity": float(rng.uniform(0.1, 1.0))}
                      for _ in range(int(rng.integers(3, 9)))])
    directory = tmp_path_factory.mktemp("multimodal_data")
    pq.write_table(pa.table({**{k: src[k] for k in ("smiles", "molecular_formula",
                                                     "ir_spectra")},
                             "h_nmr_peaks": h_nmr, "c_nmr_peaks": c_nmr}),
                   directory / "multimodal.parquet")
    return directory


def _train(tmp_path, overrides):
    from multimodalanalytical_tpu_torch.cli import training

    training.main([f"working_dir={tmp_path}", "job_name=train", *overrides, *TINY_MODEL])
    return tmp_path / "train"


@pytest.mark.parametrize("data", ["multimodal", "hnmr", "carbon"])
def test_training_cli_on_the_multimodal_configs(multimodal_data, tmp_path, data):
    from multimodalanalytical_tpu_torch.training.checkpoint import restore_params

    dropout = {"multimodal": "[Multiplets,Carbon,IR]", "hnmr": "[Multiplets]",
               "carbon": "[Carbon]"}[data]
    run = _train(tmp_path, [f"data=multimodal/{data}", f"data_path={multimodal_data}",
                            "model=custom_model", f"modality_dropout={dropout}"])
    metrics = json.loads((run / "metrics_beam_2.json").read_text())
    assert "Top-1" in metrics
    params = restore_params(run / "checkpoints" / "best")
    modalities = {"multimodal": ["Multiplets", "Carbon", "IR"], "hnmr": ["Multiplets"],
                  "carbon": ["Carbon"]}[data]
    for name in modalities:
        assert any(k.startswith(f"embedding.embed_{name}.") for k in params)
    if data == "multimodal":
        from multimodalanalytical_tpu_torch.cli import predict

        predict.main([f"working_dir={tmp_path}", "job_name=predict",
                      f"data=multimodal/{data}", f"data_path={multimodal_data}",
                      f"preprocessor_path={run / 'preprocessor.json'}",
                      f"model.model_checkpoint_path={run / 'checkpoints' / 'best'}",
                      *TINY_MODEL])
        predictions = json.loads((tmp_path / "predict" / "test_data_logits_beam_2.json")
                                 .read_text())
        assert all(len(p) == 2 for p in predictions["predictions"])


MIXTURE = ["mixture=ir/binary", "mixture.balanced.train_max_n_samples=16",
           "mixture.balanced.validation_max_n_samples=8",
           "mixture.balanced.test_max_n_samples=8", "mixture.balanced.parallel_samples=8"]
ALIGN_HEAD = ["model.align_config.hidden_dimension=16", "model.align_config.conv_channels=8"]


def test_training_cli_on_the_align_recipe_then_finetuning_without_it(tmp_path):
    """``model=custom_model_align data=ir/patches_mixture_text_align``: the
    fit's loss carries the align term and its checkpoint the head; then a
    finetuning run without align starts from that checkpoint, the head's
    keys stripped."""
    from multimodalanalytical_tpu_torch.training.checkpoint import restore_params

    run = _train(tmp_path / "align", ["data=ir/patches_mixture_text_align",
                                      f"data_path={IR_DATA.parent}", "model=custom_model_align",
                                      *MIXTURE, *ALIGN_HEAD])
    params = restore_params(run / "checkpoints" / "best")
    assert params["align_network.conv1.weight"].shape == (8, 16, 5)
    log = (run / "training.log").read_text()
    align_terms = [float(line.split("align ")[1].split(")")[0]) for line in log.splitlines()
                   if "train_loss" in line]
    assert align_terms and all(a > 0 for a in align_terms)
    tuned = _train(tmp_path / "finetune", [
        "data=ir/patches_mixture_text", f"data_path={IR_DATA.parent}", "model=custom_model",
        *MIXTURE, "finetuning=True", f"model.model_checkpoint_path={run / 'checkpoints' / 'best'}",
        f"preprocessor_path={run / 'preprocessor.json'}"])
    assert "Loaded finetuning checkpoint" in (tuned / "training.log").read_text()
    assert not any(k.startswith("align_network.")
                   for k in restore_params(tuned / "checkpoints" / "best"))
