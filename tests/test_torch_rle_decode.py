"""Serving a run-length-encoded IR model: the port's beam decode against the
JAX package's, and the serve engine with an RLE collator.

A tiny model (2 + 2 layers, d_model 128, 2 heads of head_dim 64, RLE
vocabulary 105) on an RLE source at L 2100 >= 2048: the encoder
self-attention goes through flash attention in both packages (the Pallas
kernels in interpret mode, the port's kernels' plain versions; flash
takes head_dim a multiple of 64, hence 2 heads at this width). K 4 beams,
max length 16, fp32, on the JAX package's params carried by
``load_flax_params``: beams token for token, scores within rtol 1e-5. The
self-attention cache is not quantized: with the int8 cache the JAX
package's CPU route dequantizes K and V to bf16 before its dots, where its
kernel (and the port, on any device) scales the logits and probabilities
instead, and the two routes' scores differ by ~1e-3. The cross attention
over the 2100 encoder tokens runs its plain version here;
``tests/test_torch_cuda.py`` holds its kernels to it on the card.
"""

import dataclasses
import functools
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
from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine  # noqa: E402
from multimodalanalytical_tpu_torch.generation.beam_search import beam_search  # noqa: E402
from multimodalanalytical_tpu_torch.models.config import ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.models.weights import load_flax_params  # noqa: E402
from multimodalanalytical_tpu_torch.ops import flash_attention  # noqa: E402
from test_torch_model import random_params  # noqa: E402
from test_torch_shared_layers import SMILES_REGEX  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
IR_DATA = REPO / "tests" / "test_data" / "ir_dataset" / "ir_data.parquet"
RLE_VOCAB = 105        # the RLE vocabulary fitted on tests/test_data/ir_dataset
TARGET_VOCAB = 64
RLE_LEN = 2100
BEAMS, MAX_LENGTH = 4, 16
DATA_CONFIG = {
    "RLE": {"type": "run_length_encoding", "vocab_size": RLE_VOCAB, "target": False,
            "pad_token_id": 0},
    "Smiles": {"type": "text", "vocab_size": TARGET_VOCAB, "target": True, "pad_token_id": 0},
}


def _rle_request(seed=0, batch=3):
    """RLE ids tail-padded to RLE_LEN: one full row, one ragged, one short."""
    rng = np.random.default_rng(seed)
    lengths = np.array([RLE_LEN, 1733, 912])[:batch]
    keep = np.arange(RLE_LEN)[None, :] < lengths[:, None]
    ids = np.where(keep, rng.integers(4, RLE_VOCAB, (batch, RLE_LEN)), 0).astype(np.int32)
    return {"RLE": ids}, keep.astype(np.int32)


@pytest.fixture(scope="module")
def rle_pair():
    cfg = JaxConfig(d_model=128, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2,
                    decoder_attention_heads=2, encoder_ffn_dim=256, decoder_ffn_dim=256,
                    vocab_size=TARGET_VOCAB, dropout=0.0, dtype="float32",
                    max_position_embeddings=4096, max_target_length=MAX_LENGTH,
                    kv_cache_dtype="bfloat16")
    jmodel = JaxModel(config=cfg, data_config=DATA_CONFIG, target_modality="Smiles")
    inputs, mask = _rle_request()
    dec = np.full((3, 4), 4, np.int32)
    shapes = jax.eval_shape(lambda key: jmodel.init(
        key, inputs, mask, dec, np.ones_like(dec), dec, deterministic=True),
        jax.random.PRNGKey(0))
    params = random_params(shapes["params"], seed=3)
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 4.0
    model = Seq2SeqModel(ModelConfig(**dataclasses.asdict(cfg)), DATA_CONFIG, "Smiles")
    load_flax_params(model, params)
    return jmodel, {"params": params}, model


def test_rle_beams_match_jax_token_for_token(rle_pair, monkeypatch):
    """K 4 beams of the RLE model at L 2100 (rows of 2100, 1733 and 912
    tokens): the port's beam search against the JAX package's (jitted),
    with the encoder's self-attention through flash in the port (each call
    counted, padded to 2304)."""
    jmodel, variables, model = rle_pair
    inputs, mask = _rle_request()
    search = jax.jit(functools.partial(jax_beam_search, jmodel, num_beams=BEAMS,
                                       max_length=MAX_LENGTH))
    want_seqs, want_scores = search(variables, inputs, jnp.asarray(mask))
    calls = []
    original = flash_attention.flash_attention_fwd_plain

    def counting(*args):
        calls.append(args[0].shape)
        return original(*args)

    monkeypatch.setattr(flash_attention, "flash_attention_fwd_plain", counting)
    with torch.no_grad():
        seqs, scores = beam_search(model, {"RLE": torch.from_numpy(inputs["RLE"])},
                                   torch.from_numpy(mask), num_beams=BEAMS,
                                   max_length=MAX_LENGTH)
    assert len(calls) == 2 and all(shape[2] == 2304 for shape in calls)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def rle_collator():
    """An RLE preprocessor and a SMILES tokenizer fitted on the IR test
    dataset, as the training CLI fits them, and their collator padded to 4
    rows."""
    pytest.importorskip("tokenizers")
    pq = pytest.importorskip("pyarrow.parquet")
    from multimodalanalytical_tpu_torch.data.collator import MultiModalCollator
    from multimodalanalytical_tpu_torch.data.data_utils import fit_preprocessors

    data = pq.read_table(IR_DATA).to_pydict()
    columns = {"IR": data["ir_spectra"], "Smiles": data["smiles"]}
    config = {"IR": {"type": "run_length_encoding", "column": "IR", "target": False,
                     "preprocessor_arguments": {}},
              "Smiles": {"type": "text", "column": "Smiles", "target": True,
                         "preprocessor_arguments": {"tokenizer_regex": SMILES_REGEX}}}
    config, preps = fit_preprocessors(columns, config)
    collator = MultiModalCollator(preps, config, pad_to_batch_size=4)
    collator.fit_lengths(columns)
    return collator, preps, config, columns


def test_rle_collator_masks_a_missing_row(rle_collator):
    """A record without the RLE value (the serve engine's warm batch sends
    one) collates to a fully masked row of pad ids at the preprocessor's
    fixed length; the other rows are what the preprocessor gives them, and
    a batch without a missing row is the JAX package's collator's batch."""
    from multimodalanalytical_tpu.data.collator import MultiModalCollator as JaxCollator

    collator, preps, config, columns = rle_collator
    width = preps["IR"].max_sequence_length
    spectra = columns["IR"][:3]
    got = collator({"IR": [spectra[0], None, spectra[2]], "Smiles": ["C", "", "CC"]})
    ids, mask = got["encoder_inputs"]["IR"], got["encoder_mask"]
    assert ids.shape == (4, width) and mask.shape == (4, width)
    assert not mask[1].any() and (ids[1] == preps["IR"].tokenizer.pad_token_id).all()
    want = preps["IR"]([spectra[0], spectra[2]])
    np.testing.assert_array_equal(ids[[0, 2]], want["input_ids"])
    np.testing.assert_array_equal(mask[[0, 2]], want["attention_mask"])
    full = {"IR": spectra, "Smiles": ["C", "CC", "CCC"]}
    jax_batch = JaxCollator(preps, config, max_source_length=collator.max_source_length,
                            max_target_length=collator.max_target_length,
                            pad_to_batch_size=4)(full)
    np.testing.assert_array_equal(collator(full)["encoder_inputs"]["IR"],
                                  jax_batch["encoder_inputs"]["IR"])


def test_engine_with_an_rle_collator_answers_requests(rle_collator):
    """``InferenceEngine`` built as the serve CLI builds it (a collator and
    a tokenizer) on a CPU model of the RLE recipe: its constructor decodes
    the warm batch (a missing RLE value, fully masked), and the record path
    answers two records with the beams ``decode_batch`` gives the same
    collated batch."""
    collator, preps, config, columns = rle_collator
    width = preps["IR"].max_sequence_length
    model = Seq2SeqModel(ModelConfig(
        d_model=32, encoder_layers=1, decoder_layers=1, encoder_attention_heads=4,
        decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
        vocab_size=config["Smiles"]["vocab_size"], dropout=0.0, dtype="float32",
        max_position_embeddings=max(1024, width), max_target_length=12),
        {"IR": {**config["IR"]}, "Smiles": config["Smiles"]}, "Smiles",
        generator=torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, n_beams=2, batch_size=4, collator=collator,
                             tokenizer=preps["Smiles"])
    assert engine.warm_stats["steps"] > 0
    records = [{"IR": columns["IR"][i], "Smiles": ""} for i in (4, 9)]
    engine.start()
    try:
        pendings = [engine.submit(r) for r in records]
        for p in pendings:
            assert p.event.wait(60) and p.error is None, p.error
    finally:
        engine.close()
    batch = collator({"IR": [r["IR"] for r in records], "Smiles": ["", ""]})
    seqs, scores = engine.decode_batch(batch["encoder_inputs"], batch["encoder_mask"])
    decoded = preps["Smiles"].batch_decode(seqs[:2].reshape(-1, seqs.shape[-1]),
                                           skip_special_tokens=True)
    for i, p in enumerate(pendings):
        assert p.result["smiles"] == decoded[2 * i: 2 * i + 2]
        np.testing.assert_allclose(p.result["scores"], scores[i], rtol=1e-6)
        assert p.result["scores"][0] >= p.result["scores"][1]
