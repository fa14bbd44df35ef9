"""Which route a decode shape's prologue and steps take, in every search's
``stats``: ``prologue_flash_launches`` (the flash forward's launches in the
prologue) and ``cross_forms`` (the beam cross-attention's calls by form in a
step of the first stage).

A tiny run-length-encoded IR model (2 + 2 layers, d_model 128, 2 heads of
head_dim 64, RLE vocabulary 105) on rows of 2100 tokens, past the flash
gate of 2048. On the CPU the plain versions launch nothing, so both read
zero; with the two kernel wrappers stood in for by plain versions that count
as the wrappers do, the search records one flash launch per encoder layer
and one cross-attention call per decoder layer, once per shape. On the card
(marked ``cuda``; without JAX run it without the JAX conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_beam_routes.py``)
the bf16 model reads one flash launch per encoder layer and the stream form,
through the graphs and eagerly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more

from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine  # noqa: E402
from multimodalanalytical_tpu_torch.generation.beam_search import BeamDecoder  # noqa: E402
from multimodalanalytical_tpu_torch.models.config import ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.ops import attention, beam_attention, flash_attention  # noqa: E402,E501

RLE_LEN, LAYERS, BEAMS, MAX_LENGTH = 2100, 2, 4, 16
DATA_CONFIG = {
    "RLE": {"type": "run_length_encoding", "vocab_size": 105, "target": False,
            "pad_token_id": 0},
    "Smiles": {"type": "text", "vocab_size": 64, "target": True, "pad_token_id": 0},
}
ROUTE_KEYS = ("prologue_flash_launches", "cross_forms")


def _model(device="cpu", dtype="float32"):
    cfg = ModelConfig(d_model=128, encoder_layers=LAYERS, decoder_layers=LAYERS,
                      encoder_attention_heads=2, decoder_attention_heads=2,
                      encoder_ffn_dim=256, decoder_ffn_dim=256, vocab_size=64, dropout=0.0,
                      dtype=dtype, max_position_embeddings=4096, max_target_length=MAX_LENGTH,
                      kv_cache_dtype="int8")
    return Seq2SeqModel(cfg, DATA_CONFIG, "Smiles", device=torch.device(device),
                        generator=torch.Generator(device=device).manual_seed(0))


def _request(batch=2):
    """RLE ids tail-padded to RLE_LEN: one full row, one of 1733 tokens."""
    rng = np.random.default_rng(0)
    lengths = np.array([RLE_LEN, 1733])[:batch]
    keep = np.arange(RLE_LEN)[None, :] < lengths[:, None]
    ids = np.where(keep, rng.integers(4, 105, (batch, RLE_LEN)), 0).astype(np.int32)
    return {"RLE": ids}, keep.astype(np.int32)


def test_cpu_searches_carry_zero_routes():
    """Through ``InferenceEngine.decode_batch``, and the decoder's eager
    route: both keys in every search's stats, nothing launched."""
    engine = InferenceEngine(_model(), n_beams=BEAMS, batch_size=2)
    inputs, mask = _request()
    for _ in range(2):
        engine.decode_batch(inputs, mask)
        stats = engine.last_stats
        assert stats["prologue_flash_launches"] == 0
        assert stats["cross_forms"] == dict.fromkeys(beam_attention.CROSS_FORMS, 0)
    stats = {}
    engine.decoder.search({"RLE": torch.as_tensor(inputs["RLE"])}, torch.as_tensor(mask),
                          BEAMS, max_length=MAX_LENGTH, cuda_graph=False, stats=stats)
    assert all(key in stats for key in ROUTE_KEYS)


def test_counted_routes_per_layer(monkeypatch):
    """The two wrappers replaced by plain versions that count their calls
    as the kernels' wrappers do (a launch; a call by form): the prologue
    records one flash launch per encoder layer, a step one cross call per
    decoder layer, each search the same however many steps it ran."""
    plain_flash = flash_attention.flash_attention_fwd_plain
    plain_cross = beam_attention.beam_cross_attention_plain

    def flash_fwd(*args):
        flash_fwd.launches += 1
        return plain_flash(*args)

    def cross(*args):
        cross.forms["stream"] += 1
        return plain_cross(*args)

    flash_fwd.launches = 0
    cross.forms = dict.fromkeys(beam_attention.CROSS_FORMS, 0)
    monkeypatch.setattr(flash_attention, "flash_attention_fwd", flash_fwd)
    monkeypatch.setattr(beam_attention, "beam_cross_attention", cross)
    monkeypatch.setattr(attention, "beam_cross_attention", cross)
    decoder = BeamDecoder(_model().eval())
    inputs, mask = _request()
    want = {**dict.fromkeys(beam_attention.CROSS_FORMS, 0), "stream": LAYERS}
    for _ in range(2):
        stats = {}
        decoder.search({"RLE": torch.as_tensor(inputs["RLE"])}, torch.as_tensor(mask), BEAMS,
                       max_length=MAX_LENGTH, stats=stats)
        assert stats["prologue_flash_launches"] == LAYERS
        assert stats["cross_forms"] == want
        assert stats["replays"] > 1
    assert flash_fwd.launches == 2 * LAYERS


@pytest.mark.cuda
def test_card_routes_at_an_rle_shape():
    """On the card, bf16 at L 2100: one flash launch per encoder layer in
    the captured prologue and the stream form in every step, through the
    engine (graphs) and the decoder's eager route; replays add the graphs'
    launches to the flash wrapper's count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    engine = InferenceEngine(_model("cuda", "bfloat16"), n_beams=BEAMS, batch_size=2)
    inputs, mask = _request()
    want = {**dict.fromkeys(beam_attention.CROSS_FORMS, 0), "stream": LAYERS}
    engine.decode_batch(inputs, mask)
    before = flash_attention.flash_attention_fwd.launches
    engine.decode_batch(inputs, mask)
    stats = engine.last_stats
    assert stats["graph"] and stats["prologue_flash_launches"] == LAYERS, stats
    assert stats["cross_forms"] == want, stats
    assert flash_attention.flash_attention_fwd.launches - before == LAYERS
    eager = {}
    engine.decoder.search({"RLE": torch.as_tensor(inputs["RLE"], device="cuda")},
                          torch.as_tensor(mask, device="cuda"), BEAMS, max_length=MAX_LENGTH,
                          cuda_graph=False, stats=eager)
    assert not eager["graph"] and eager["prologue_flash_launches"] == LAYERS, eager
    assert eager["cross_forms"] == want, eager
