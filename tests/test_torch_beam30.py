"""Beam 30 (the mixture paper's Table 4 predict recipe) and the beam golden
file through the port's beam search, on JAX-initialised weights (CPU, fp32).

Mirrors ``tests/test_beam30.py`` (distinct sorted beams, staged equals
unstaged) and adds token-for-token equality with the JAX ``beam_search`` at
K 30; ``tests/golden/beam_golden.npz`` (``tests/test_beam_golden.py``'s
fixed-seed flagship-family model) is decoded by the port.
"""

import dataclasses
import sys
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
from multimodalanalytical_tpu_torch.generation import beam_search as port_beam  # noqa: E402
from multimodalanalytical_tpu_torch.models.config import ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.models.weights import load_flax_params  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

VOCAB = 64  # > 30: the first expansion must offer at least K candidates
GOLDEN = Path(__file__).parent / "golden" / "beam_golden.npz"


def _port_model(jmodel, params):
    model = Seq2SeqModel(ModelConfig(**dataclasses.asdict(jmodel.config)), jmodel.data_config,
                         jmodel.target_modality)
    load_flax_params(model, params)
    return model


@pytest.fixture(scope="module")
def beam30_pair():
    """tests/test_beam30.py's model and batch, with the port's copy."""
    data_config = {
        "IR": {"type": "1D_patches", "column": "ir", "target": False,
               "preprocessor_arguments": {"patch_size": 8}},
        "Smiles": {"type": "text", "column": "s", "target": True, "vocab_size": VOCAB,
                   "pad_token_id": 0, "preprocessor_arguments": {}},
    }
    cfg = JaxConfig(d_model=32, encoder_layers=1, decoder_layers=2, encoder_attention_heads=4,
                    decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
                    vocab_size=VOCAB, dropout=0.0)
    jmodel = JaxModel(config=cfg, data_config=data_config, target_modality="Smiles")
    rng = np.random.default_rng(5)
    batch = {
        "encoder_inputs": {"IR": rng.random((2, 6, 8)).astype(np.float32)},
        "encoder_mask": np.ones((2, 6), np.int32),
        "decoder_ids": rng.integers(4, VOCAB, (2, 10)).astype(np.int32),
        "decoder_mask": np.ones((2, 10), np.int32),
        "labels": rng.integers(4, VOCAB, (2, 10)).astype(np.int32),
    }
    variables = jax.jit(lambda key: jmodel.init(
        key, batch["encoder_inputs"], batch["encoder_mask"], batch["decoder_ids"],
        batch["decoder_mask"], batch["labels"], deterministic=True))(jax.random.PRNGKey(0))
    return jmodel, variables, _port_model(jmodel, jax.device_get(variables["params"])), batch


def _port_search(model, batch, **kw):
    return port_beam.beam_search(model, {"IR": torch.from_numpy(batch["encoder_inputs"]["IR"])},
                                 torch.from_numpy(batch["encoder_mask"]), **kw)


def test_beam30_matches_jax_token_for_token(beam30_pair):
    jmodel, variables, model, batch = beam30_pair
    want_seqs, want_scores = jax_beam_search(jmodel, variables, batch["encoder_inputs"],
                                             jnp.asarray(batch["encoder_mask"]), num_beams=30,
                                             max_length=16)
    seqs, scores = _port_search(model, batch, num_beams=30, max_length=16)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-5)
    # 30 distinct hypotheses per row, sorted, each from BOS to an EOS.
    assert seqs.shape == (2, 30, 16)
    assert (np.diff(scores.numpy(), axis=1) <= 0).all()
    assert (seqs[:, :, 0] == 2).all() and (seqs == 3).any(dim=-1).all()
    for row in seqs.numpy():
        assert len({tuple(r) for r in row}) == 30


def test_beam30_staged_equals_unstaged(beam30_pair):
    _, _, model, batch = beam30_pair
    staged, s_scores = _port_search(model, batch, num_beams=30, max_length=32, stage_size=8)
    full, f_scores = _port_search(model, batch, num_beams=30, max_length=32, stage_size=None)
    assert torch.equal(staged, full)
    np.testing.assert_allclose(s_scores.numpy(), f_scores.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("beams,length,want", [(30, 128, True), (30, 16, True), (33, 128, False)])
def test_int8_cache_decision_at_beam30(beams, length, want):
    """At the flagship width the port picks the int8 cache at K 30, L 128,
    as the JAX ``beam_search`` does (``beam_search.py:87-97``)."""
    assert port_beam.kv_cache_quantized(ModelConfig(d_model=512), beams, length) is want


def test_beam_golden_through_the_port():
    """tests/golden/beam_golden.npz: sequences exactly, scores at rtol 1e-4."""
    from __graft_entry__ import _example_batch, _flagship

    jmodel = _flagship(d_model=64, layers=2, ffn=128, vocab=24)
    batch = _example_batch(batch=4, target_len=10, vocab=24)
    variables = jax.jit(lambda key: jmodel.init(
        key, batch["encoder_inputs"], batch["encoder_mask"], batch["decoder_ids"],
        batch["decoder_mask"], batch["labels"], deterministic=True))(jax.random.PRNGKey(7))
    model = _port_model(jmodel, jax.device_get(variables["params"]))
    seqs, scores = port_beam.beam_search(
        model, {k: torch.from_numpy(v) for k, v in batch["encoder_inputs"].items()},
        torch.from_numpy(batch["encoder_mask"]), num_beams=5, max_length=16)
    golden = np.load(GOLDEN)
    np.testing.assert_array_equal(seqs.numpy(), golden["seqs"])
    np.testing.assert_allclose(scores.numpy(), golden["scores"], rtol=1e-4, atol=1e-5)
