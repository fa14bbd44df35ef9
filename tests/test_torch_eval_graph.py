"""The decode's prologue and epilogue and the evaluation step, on the route a
CUDA graph captures, against the JAX package (CPU, fp32).

``BeamDecoder.search`` copies each request into its shape's static inputs
and runs three parts on static buffers: the prologue (encoder, cross K/V
projection, state reset), the steps and the epilogue (the final merge into
static outputs). On the card each part is a replayed CUDA graph; here the
same functions run eagerly. Beams token for token and scores at rtol 1e-5
against the JAX ``beam_search`` on carried weights, at K 1, 4 and 30, for
an IR-patch model, a multimodal model whose multiplets are an XVal dict
payload, and an RLE model at L 2100, whose encoder takes flash attention
in both packages (the Pallas kernel in interpret mode, as the JAX tests run
it). Requests of different shapes in a row through one decoder, and a
planted fault that skips one leaf's input copy, which the comparison must
reject. ``Trainer.eval_step`` (the body its graph captures) against the JAX
``Trainer``'s jitted ``eval_step`` at rtol 1e-6.
"""

import dataclasses
import functools
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
jnp = jax.numpy

from multimodalanalytical_tpu.generation.beam_search import beam_search as jax_beam_search  # noqa: E402,E501
from multimodalanalytical_tpu.models import ModelConfig as JaxConfig  # noqa: E402
from multimodalanalytical_tpu.models import Seq2SeqModel as JaxModel  # noqa: E402
from multimodalanalytical_tpu.ops import flash_attention as jax_flash  # noqa: E402
from multimodalanalytical_tpu.parallel.mesh import make_mesh  # noqa: E402
from multimodalanalytical_tpu.training import trainer as jax_trainer  # noqa: E402
from multimodalanalytical_tpu_torch.generation import beam_search as port_beam  # noqa: E402
from multimodalanalytical_tpu_torch.models.config import ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.models.weights import load_flax_params  # noqa: E402
from multimodalanalytical_tpu_torch.ops import flash_attention  # noqa: E402
from multimodalanalytical_tpu_torch.training import Trainer  # noqa: E402
from multimodalanalytical_tpu_torch.training.trainer import device_batch  # noqa: E402
from test_torch_model import random_params, to_torch  # noqa: E402
from test_torch_multimodal import model_pair as multimodal_pair  # noqa: E402
from test_torch_multimodal import multimodal_batch  # noqa: E402
from test_torch_rle_decode import DATA_CONFIG as RLE_DATA_CONFIG  # noqa: E402
from test_torch_rle_decode import RLE_LEN, RLE_VOCAB  # noqa: E402

VOCAB = 64          # > 30: the first expansion offers K 30 candidates
MAX_LENGTH = 14
PATCH = 8
IR_DATA_CONFIG = {
    "IR": {"type": "1D_patches", "column": "ir", "target": False,
           "preprocessor_arguments": {"patch_size": PATCH}},
    "Smiles": {"type": "text", "column": "s", "target": True, "vocab_size": VOCAB,
               "pad_token_id": 0, "preprocessor_arguments": {}},
}


def _pair(cfg, data_config, sample, seed):
    """(jax model, variables, port model) on one seeded param tree."""
    jmodel = JaxModel(config=cfg, data_config=data_config, target_modality="Smiles")
    shapes = jax.eval_shape(lambda key: jmodel.init(
        key, sample["encoder_inputs"], sample["encoder_mask"], sample["decoder_ids"],
        sample["decoder_mask"], sample["labels"], deterministic=True), jax.random.PRNGKey(0))
    params = random_params(shapes["params"], seed)
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 4.0
    model = Seq2SeqModel(ModelConfig(**dataclasses.asdict(cfg)), data_config, "Smiles")
    load_flax_params(model, params)
    return jmodel, {"params": params}, model


def ir_request(batch=3, patches=6, seed=0, target_len=10):
    """IR patches with ragged masks (row 1 shorter), and teacher-forcing fields."""
    rng = np.random.default_rng(seed)
    mask = np.ones((batch, patches), np.int32)
    mask[1, patches // 2:] = 0
    labels = rng.integers(4, VOCAB, (batch, target_len)).astype(np.int32)
    labels[0, 6:] = -100
    return {"encoder_inputs": {"IR": rng.random((batch, patches, PATCH)).astype(np.float32)},
            "encoder_mask": mask,
            "decoder_ids": rng.integers(4, VOCAB, (batch, target_len)).astype(np.int32),
            "decoder_mask": (labels != -100).astype(np.int32), "labels": labels}


def rle_request(seed=0, batch=3, target_len=8):
    """RLE ids tail-padded to RLE_LEN (rows of 2100, 1733 and 912 tokens)."""
    rng = np.random.default_rng(seed)
    lengths = np.array([RLE_LEN, 1733, 912])[:batch]
    keep = np.arange(RLE_LEN)[None, :] < lengths[:, None]
    ids = np.where(keep, rng.integers(4, RLE_VOCAB, (batch, RLE_LEN)), 0).astype(np.int32)
    labels = rng.integers(4, VOCAB, (batch, target_len)).astype(np.int32)
    return {"encoder_inputs": {"RLE": ids}, "encoder_mask": keep.astype(np.int32),
            "decoder_ids": rng.integers(4, VOCAB, (batch, target_len)).astype(np.int32),
            "decoder_mask": np.ones((batch, target_len), np.int32), "labels": labels}


@functools.lru_cache(maxsize=None)
def _models(kind):
    """(jax model, variables, port model, request maker) of each kind."""
    if kind == "ir":
        cfg = JaxConfig(d_model=32, encoder_layers=2, decoder_layers=2,
                        encoder_attention_heads=4, decoder_attention_heads=4,
                        encoder_ffn_dim=64, decoder_ffn_dim=64, vocab_size=VOCAB, dropout=0.0,
                        max_target_length=MAX_LENGTH)
        return (*_pair(cfg, IR_DATA_CONFIG, ir_request(), seed=5), ir_request)
    if kind == "xval":
        return (*multimodal_pair(), functools.partial(multimodal_batch, xval=True))
    cfg = JaxConfig(d_model=128, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2,
                    decoder_attention_heads=2, encoder_ffn_dim=256, decoder_ffn_dim=256,
                    vocab_size=VOCAB, dropout=0.0, dtype="float32", max_position_embeddings=4096,
                    max_target_length=MAX_LENGTH, kv_cache_dtype="bfloat16")
    data_config = dict(RLE_DATA_CONFIG, Smiles=dict(RLE_DATA_CONFIG["Smiles"], vocab_size=VOCAB))
    return (*_pair(cfg, data_config, rle_request(), seed=3), rle_request)


def _jax_beams(jmodel, variables, request, beams):
    search = jax.jit(functools.partial(jax_beam_search, jmodel, num_beams=beams,
                                       max_length=MAX_LENGTH))
    seqs, scores = search(variables, request["encoder_inputs"],
                          jnp.asarray(request["encoder_mask"]))
    return np.asarray(seqs), np.asarray(scores)


def _spy(monkeypatch, owner, name):
    """Count the calls of ``owner.name`` (patched for this test)."""
    calls = []
    original = getattr(owner, name)

    def counting(*args, **kwargs):
        calls.append(args)
        return original(*args, **kwargs)

    static = isinstance(inspect.getattr_static(owner, name), staticmethod)
    monkeypatch.setattr(owner, name, staticmethod(counting) if static else counting)
    return calls


def _port_beams(decoder, request, beams, stats=None):
    seqs, scores = decoder.search(to_torch(request["encoder_inputs"]),
                                  torch.as_tensor(request["encoder_mask"]), beams,
                                  max_length=MAX_LENGTH, stats=stats)
    return seqs.numpy(), scores.numpy()


def _require_jax_beams(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("beams", [1, 4, 30])
@pytest.mark.parametrize("kind", ["ir", "xval", "rle"])
def test_factored_search_matches_jax(monkeypatch, kind, beams):
    """One request through the prologue, the steps and the epilogue (each
    run once per search, on the static buffers) against the JAX beam
    search; the RLE encoder through flash in both packages."""
    jmodel, variables, model, make = _models(kind)
    request = make(seed=2)
    jax_calls = _spy(monkeypatch, jax_flash, "_fwd")
    want = _jax_beams(jmodel, variables, request, beams)
    decoder = port_beam.BeamDecoder(model)
    prologues = _spy(monkeypatch, port_beam.BeamDecoder, "_prologue")
    epilogues = _spy(monkeypatch, port_beam.BeamDecoder, "_epilogue")
    flash_calls = _spy(monkeypatch, flash_attention, "flash_attention_fwd_plain")
    stats = {}
    got = _port_beams(decoder, request, beams, stats)
    _require_jax_beams(got, want)
    assert len(prologues) == len(epilogues) == 1
    assert not stats["graph"] and stats["eager_reason"] == "cpu device"
    assert not stats["recaptured"]
    (decode,) = decoder._decodes.values()
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(decode.inputs),
        jax.tree_util.tree_leaves(to_torch(request["encoder_inputs"]))))
    if kind == "rle":
        assert jax_flash._interpret() and len(jax_calls) >= 1
        assert len(flash_calls) == 2 and all(c[0].shape[2] == 2304 for c in flash_calls)
    else:
        assert not jax_calls and not flash_calls


def test_requests_of_two_shapes_in_a_row_match_jax():
    """Requests of one shape, another (more patches, fewer rows), then the
    first again through one decoder: each equal to the JAX beam search, the
    third decoded through the first's static buffers."""
    jmodel, variables, model, _ = _models("ir")
    decoder = port_beam.BeamDecoder(model)
    requests = [ir_request(3, 6, seed=10), ir_request(2, 9, seed=11), ir_request(3, 6, seed=12)]
    decodes = []
    for request in requests:
        _require_jax_beams(_port_beams(decoder, request, 4),
                           _jax_beams(jmodel, variables, request, 4))
        decodes.append(next(d for d in decoder._decodes.values()
                            if d.mask.shape == request["encoder_mask"].shape))
    assert len(decoder._decodes) == 2
    assert decodes[0] is decodes[2] and decodes[0] is not decodes[1]


def test_a_skipped_input_copy_is_rejected(monkeypatch):
    """The planted fault: a decode shape's second request keeps the first
    request's IR patches (its copy into the static inputs skipped). The
    comparison with the JAX beam search of the second request must fail,
    and pass once the copy is back."""
    jmodel, variables, model, _ = _models("ir")
    first, second = ir_request(seed=20), ir_request(seed=21)
    want = _jax_beams(jmodel, variables, second, 4)
    decoder = port_beam.BeamDecoder(model)
    _port_beams(decoder, first, 4)
    load = port_beam._Decode.load

    def skipping(self, encoder_inputs, encoder_mask, hook_init):
        load(self, dict(encoder_inputs, IR=self.inputs["IR"]), encoder_mask, hook_init)

    monkeypatch.setattr(port_beam._Decode, "load", skipping)
    stale = _port_beams(decoder, second, 4)
    with pytest.raises(AssertionError):
        _require_jax_beams(stale, want)
    monkeypatch.setattr(port_beam._Decode, "load", load)
    _require_jax_beams(_port_beams(decoder, second, 4), want)


@functools.lru_cache(maxsize=None)
def _jax_eval_step(kind):
    jmodel, _, _, make = _models(kind)
    jt = jax_trainer.Trainer(jmodel, None, mesh=make_mesh(devices=jax.devices()[:1]), seed=0)
    return jt._build_eval_step()


@pytest.mark.parametrize("kind", ["ir", "xval", "rle"])
def test_eval_step_matches_jax_trainer(kind):
    """The port's ``eval_step`` (the body its graph captures) on two batches
    of different shapes against the JAX ``Trainer``'s: the losses at rtol
    1e-6, the argmax ids exactly."""
    jmodel, variables, model, make = _models(kind)
    trainer = Trainer(model)
    step = _jax_eval_step(kind)
    batches = [make(seed=30)]
    batches.append(ir_request(2, 9, seed=31, target_len=12) if kind == "ir"
                   else make(seed=31, batch=2))
    for batch in batches:
        want = jax.tree_util.tree_map(np.asarray, step(variables["params"], batch))
        got = trainer.eval_step(device_batch(batch, trainer.device))
        assert got.keys() == want.keys()
        for name in ("loss", "model_only_loss", "alignment_loss"):
            np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got["predicted_ids"].numpy(), want["predicted_ids"])
    assert trainer.eval_stats["eager_steps"] == 2 and not trainer.eval_stats["graph"]
