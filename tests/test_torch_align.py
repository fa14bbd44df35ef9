"""The port's alignment head against the JAX package's.

The loss functions, ``AlignNetwork`` (mlp and convolutional) and
``Seq2SeqModel.forward`` with an align target (with and without fully
masked batch-padding rows) run in both packages on the same carried
params and seeded inputs, fp32 on the CPU; then 1 and 3 ``Trainer`` steps
on an align model against the JAX ``Trainer`` (dropout 0), as
``tests/test_torch_train.py`` holds the patch model.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
jnp = jax.numpy

from multimodalanalytical_tpu.models import AlignConfig as JaxAlignConfig  # noqa: E402
from multimodalanalytical_tpu.models import ModelConfig as JaxConfig  # noqa: E402
from multimodalanalytical_tpu.models import Seq2SeqModel as JaxModel  # noqa: E402
from multimodalanalytical_tpu.models import align as jax_align  # noqa: E402
from multimodalanalytical_tpu.parallel.mesh import make_mesh, shard_batch  # noqa: E402
from multimodalanalytical_tpu.training import trainer as jax_trainer  # noqa: E402
from multimodalanalytical_tpu_torch.generation.beam_search import (  # noqa: E402
    BeamDecoder,
    beam_search,
    decode_model,
)
from multimodalanalytical_tpu_torch.models import align  # noqa: E402
from multimodalanalytical_tpu_torch.models.config import AlignConfig, ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.models.weights import load_flax_params  # noqa: E402
from multimodalanalytical_tpu_torch.training.trainer import Trainer  # noqa: E402
from test_torch_embedding import random_params, to_torch  # noqa: E402
from test_torch_train import OPTIMISER, _check, load_params_as_numpy  # noqa: E402

VOCAB, OUT_DIM, PATCH = 24, 40, 16
NETWORKS = ["convolutional", "mlp"]
LOSSES = ["mse", "mae", "sid"]
# tests/test_reference_model_parity.py's tolerances (fp32, both packages).
LOGITS_TOL = dict(rtol=2e-4, atol=2e-5)
CE_TOL = dict(rtol=1e-5, atol=1e-6)
ALIGN_TOL = dict(rtol=1e-4, atol=1e-6)
TOTAL_TOL = dict(rtol=1e-5, atol=1e-5)


def align_config(network="convolutional", loss="mae", cls=AlignConfig):
    return cls(align_network=network, hidden_dimension=16, conv_channels=12, kernel_size=5,
               output_dimension=OUT_DIM, loss_lambda=3.0, loss_function=loss)


def spectra(rng, shape):
    """Positive, spectrum-like rows (sid needs them)."""
    return rng.random(shape).astype(np.float32) + 0.05


# ------------------------------------------------------------ the losses


@pytest.mark.parametrize("name", ["kl_div_batchmean", "sid", "mse", "mae"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(0)
    p, q = spectra(rng, (5, OUT_DIM)), spectra(rng, (5, OUT_DIM))
    q[1, :7] = 0.0                      # clipped at 1e-16 on both sides
    if name in ("kl_div_batchmean", "sid"):
        want_fn, got_fn = getattr(jax_align, name), getattr(align, name)
    else:
        want_fn, got_fn = jax_align.ALIGN_LOSSES[name], align.ALIGN_LOSSES[name]
    want = float(jax.jit(want_fn)(p, q))
    got = float(got_fn(torch.as_tensor(p), torch.as_tensor(q)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------- the head


def _head_pair(network, d_model=32, seed=1):
    cfg = align_config(network)
    jhead = jax_align.AlignNetwork(align_config(network, cls=JaxAlignConfig))
    pooled = np.random.default_rng(seed).normal(size=(4, d_model)).astype(np.float32)
    shapes = jax.eval_shape(lambda key: jhead.init(key, pooled), jax.random.PRNGKey(0))
    params = random_params(shapes["params"], seed)
    head = align.AlignNetwork(cfg, d_model, generator=torch.Generator())
    load_flax_params(head, params)
    return jhead, params, head, pooled


@pytest.mark.parametrize("network", NETWORKS)
def test_align_network_matches_jax(network):
    jhead, params, head, pooled = _head_pair(network)
    want = jax.jit(lambda p, x: jhead.apply({"params": p}, x))(params, pooled)
    with torch.no_grad():
        got = head(torch.as_tensor(pooled))
    assert got.shape == (4, OUT_DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_carried_conv_kernel_is_applied_whole():
    """The flax Conv kernel (k, in, out) carried by ``load_flax_params``
    (``.T``: all axes reversed) is ``conv1d``'s (out, in, k): on inputs 9
    positions wide every tap of the kernel meets data, and the port's
    convolution equals flax's there, not only at the centre tap that the
    head's singleton axis reaches."""
    import flax.linen as nn

    _, params, head, _ = _head_pair("convolutional")
    kernel = np.asarray(params["conv1"]["kernel"])
    assert kernel.shape == (5, 16, 12)
    np.testing.assert_array_equal(head.conv1.weight.detach().numpy(), kernel.transpose(2, 1, 0))
    x = np.random.default_rng(2).normal(size=(3, 9, 16)).astype(np.float32)   # NWC
    conv = nn.Conv(12, kernel_size=(5,), padding=[(2, 2)])
    want = conv.apply({"params": params["conv1"]}, x)
    with torch.no_grad():
        got = head.conv1(torch.as_tensor(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the model


def data_config():
    return {
        "Formula": {"type": "text", "column": "f", "target": False, "vocab_size": 20,
                    "pad_token_id": 0, "preprocessor_arguments": {}},
        "IR": {"type": "1D_patches", "column": "ir", "target": False,
               "preprocessor_arguments": {"patch_size": PATCH}},
        "Smiles": {"type": "text", "column": "s", "target": True, "vocab_size": VOCAB,
                   "pad_token_id": 0, "preprocessor_arguments": {}},
    }


def align_batch(batch=4, dummies=0, seed=3, target_len=9):
    """Seeded batch with ragged Formula masks, an align target and
    ``dummies`` trailing batch-padding rows (fully masked, labels -100,
    zero targets), as the collator pads a short batch."""
    rng = np.random.default_rng(seed)
    rows = batch + dummies
    formula = rng.integers(1, 20, (rows, 6)).astype(np.int32)
    mask = np.ones((rows, 6 + 5), np.int32)
    mask[0, 4:6] = 0
    formula[0, 4:] = 0
    labels = rng.integers(4, VOCAB, (rows, target_len)).astype(np.int32)
    labels[1, 6:] = -100
    out = {"encoder_inputs": {"Formula": formula,
                              "IR": rng.random((rows, 5, PATCH)).astype(np.float32)},
           "encoder_mask": mask,
           "decoder_ids": rng.integers(4, VOCAB, (rows, target_len)).astype(np.int32),
           "decoder_mask": np.ones((rows, target_len), np.int32), "labels": labels,
           "align_target": spectra(rng, (rows, OUT_DIM)), "n_valid": batch}
    if dummies:
        out["encoder_mask"][batch:] = 0
        out["labels"][batch:] = -100
        out["align_target"][batch:] = 0.0
    return out


def model_pair(network="convolutional", loss="mae", dropout=0.0, layers=2, seed=4):
    cfg = JaxConfig(d_model=32, encoder_layers=layers, decoder_layers=layers,
                    encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
                    decoder_ffn_dim=64, vocab_size=VOCAB, dropout=dropout, max_target_length=12,
                    align_config=align_config(network, loss, JaxAlignConfig))
    jmodel = JaxModel(config=cfg, data_config=data_config(), target_modality="Smiles")
    b = align_batch()
    shapes = jax.eval_shape(lambda key: jmodel.init(
        key, b["encoder_inputs"], b["encoder_mask"], b["decoder_ids"], b["decoder_mask"],
        b["labels"], b["align_target"], deterministic=True), jax.random.PRNGKey(0))
    params = random_params(shapes["params"], seed)
    port_cfg = dataclasses.asdict(cfg)
    port_cfg["align_config"] = align_config(network, loss)
    model = Seq2SeqModel(ModelConfig(**port_cfg), data_config(), "Smiles")
    load_flax_params(model, params)
    return jmodel, params, model


def _forward_both(jmodel, params, model, b):
    keys = ("encoder_mask", "decoder_ids", "decoder_mask", "labels", "align_target")
    want = jax.jit(lambda p, e, *a: jmodel.apply({"params": p}, e, *a, deterministic=True))(
        params, b["encoder_inputs"], *(b[k] for k in keys))
    t = to_torch({k: b[k] for k in ("encoder_inputs",) + keys})
    with torch.no_grad():
        got = model(t["encoder_inputs"], *(t[k] for k in keys))
    return want, got


@pytest.mark.parametrize("dummies", [0, 2])
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("network", NETWORKS)
def test_forward_with_align_target_matches_jax(network, loss, dummies):
    jmodel, params, model = model_pair(network, loss)
    want, got = _forward_both(jmodel, params, model, align_batch(dummies=dummies))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **LOGITS_TOL)
    np.testing.assert_allclose(float(got["model_only_loss"]), float(want["model_only_loss"]),
                               **CE_TOL)
    np.testing.assert_allclose(float(got["alignment_loss"]), float(want["alignment_loss"]),
                               **ALIGN_TOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **TOTAL_TOL)
    assert float(got["alignment_loss"]) > 0
    np.testing.assert_allclose(float(got["loss"]), float(got["model_only_loss"])
                               + 3.0 * float(got["alignment_loss"]), rtol=1e-6)


@pytest.mark.parametrize("loss", LOSSES)
def test_dummy_rows_leave_the_align_loss_unchanged(loss):
    """Fully masked rows are zeroed in prediction and target and the mean
    is rescaled to the valid rows: the padded batch's align loss is the
    unpadded batch's."""
    _, _, model = model_pair("mlp", loss)
    padded = to_torch(align_batch(dummies=3))
    valid = to_torch(align_batch(dummies=3))
    for key in ("encoder_mask", "decoder_ids", "decoder_mask", "labels", "align_target"):
        valid[key] = valid[key][:4]
    valid["encoder_inputs"] = {m: x[:4] for m, x in valid["encoder_inputs"].items()}
    losses = []
    with torch.no_grad():
        for b in (padded, valid):
            losses.append(float(model(b["encoder_inputs"], b["encoder_mask"], b["decoder_ids"],
                                      b["decoder_mask"], b["labels"],
                                      b["align_target"])["alignment_loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


def test_forward_without_target_or_head_has_no_align_loss():
    _, _, model = model_pair()
    b = to_torch(align_batch())
    args = (b["encoder_inputs"], b["encoder_mask"], b["decoder_ids"], b["decoder_mask"],
            b["labels"])
    with torch.no_grad():
        out = model(*args)
    assert float(out["alignment_loss"]) == 0.0 and torch.equal(out["loss"],
                                                               out["model_only_loss"])


# ---------------------------------------------------------- decoding


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoding_leaves_the_align_head_out(dtype):
    """The decode copy of a bf16 model holds no align network (a float32
    model decodes as it is); a refresh copies the weights it has; beams
    equal those of the same model built without the head."""
    _, params, model = model_pair()
    cfg = dataclasses.replace(model.config, dtype=dtype)
    model = Seq2SeqModel(cfg, data_config(), "Smiles")
    load_flax_params(model, params)
    plain = Seq2SeqModel(dataclasses.replace(cfg, align_config=None), data_config(), "Smiles")
    load_flax_params(plain, {k: v for k, v in params.items() if k != "align_network"})
    decoder = BeamDecoder(model)
    if dtype == "bfloat16":
        assert decoder.dmodel.align_network is None
        assert not any(n.startswith("align_network") for n, _ in
                       decoder.dmodel.named_parameters())
        assert model.align_network is not None
    else:
        assert decoder.dmodel is model
    decoder.refresh()
    b = to_torch(align_batch())
    seqs, scores = decoder.search(b["encoder_inputs"], b["encoder_mask"], 3, max_length=12)
    want_seqs, want_scores = beam_search(plain, b["encoder_inputs"], b["encoder_mask"],
                                         num_beams=3, max_length=12)
    assert torch.equal(seqs, want_seqs) and torch.equal(scores, want_scores)
    assert decode_model(plain).align_network is None


# ---------------------------------------------------------- the trainer


@pytest.fixture(scope="module")
def align_run():
    """Losses and params of 3 steps of the JAX Trainer and the port's on
    the same initial params and align batches (dropout 0, fp32)."""
    jmodel, _, model = model_pair("convolutional", "mae", layers=1)
    batches = [align_batch(batch=3, dummies=1, seed=10 + i) for i in range(3)]
    mesh = make_mesh(devices=jax.devices()[:1])
    jt = jax_trainer.Trainer(jmodel, None, mesh=mesh, seed=0, **OPTIMISER)
    state = jax.jit(jt.init_state)(batches[0])
    init_params = jax.device_get(state.params)
    step = jt._build_train_step(jax_trainer._modality_segments(
        batches[0]["encoder_inputs"], order=list(data_config())))
    want_losses, want_align, want_params = [], [], []
    for batch in batches:
        state, metrics = step(state, shard_batch(jax_trainer._device_batch(batch), mesh), {})
        want_losses.append(float(metrics["loss"]))
        want_align.append(float(metrics["alignment_loss"]))
        want_params.append(load_params_as_numpy(jax.device_get(state.params)))
    load_flax_params(model, init_params)
    trainer = Trainer(model, seed=0, **OPTIMISER)
    got_losses, got_align, got_params = [], [], []
    for batch in batches:
        metrics = trainer.train_step(batch)
        got_losses.append(float(metrics["loss"]))
        got_align.append(float(metrics["alignment_loss"]))
        got_params.append({k: p.detach().numpy().copy() for k, p in model.named_parameters()})
    return (want_losses, want_params, got_losses, got_params), want_align, got_align


@pytest.mark.parametrize("steps", [1, 3])
def test_align_trainer_matches_jax_trainer(align_run, steps):
    run, want_align, got_align = align_run
    np.testing.assert_allclose(got_align[:steps], want_align[:steps], **ALIGN_TOL)
    assert all(a > 0 for a in got_align)
    _check(run, steps)


@pytest.mark.parametrize("positions", ["sin_cos", "learned"])
def test_the_shipped_align_config_reaches_the_model(positions):
    """``configs/model/custom_model_align.yaml`` through the port's config
    composer and ``build_model``: every field of its align block, the
    pre-LN flag and the position type arrive in the model, as the JAX
    ``resolve_model_config`` resolves them."""
    pytest.importorskip("yaml")
    from multimodalanalytical_tpu.models.config import resolve_model_config as jax_resolve
    from multimodalanalytical_tpu_torch.cli.common import build_model
    from multimodalanalytical_tpu_torch.config import compose_config
    from multimodalanalytical_tpu_torch.ops.positional import (
        LearnedPositionalEncoding,
        SinCosPositionalEncoding,
    )

    class Tokenizer:
        vocab_size, pad_token_id, bos_token_id, eos_token_id = VOCAB, 0, 2, 3

    root = Path(__file__).resolve().parents[1]
    config = compose_config(root / "configs", "config_train", [
        "model=custom_model_align", "working_dir=/tmp/x", "model.d_model=32",
        "model.encoder_layers=1", "model.decoder_layers=1", "model.encoder_ffn_dim=64",
        "model.decoder_ffn_dim=64", f"model.positional_encoding_type={positions}"])
    model_config = dict(config["model"])
    model, cfg = build_model(model_config, data_config(), "Smiles", Tokenizer(),
                             torch.device("cpu"))
    ids = dict(vocab_size=VOCAB, pad_token_id=0, bos_token_id=2, eos_token_id=3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_resolve(model_config, **ids))
    assert dataclasses.asdict(cfg.align_config) == dict(model_config["align_config"])
    assert cfg.post_layer_normalisation is True and cfg.positional_encoding_type == positions
    head = model.align_network
    assert head.conv1.weight.shape == (512, 256, 5) and head.conv2.weight.shape == (1800, 512)
    assert head.fc1.weight.shape == (256, 32)
    kind = LearnedPositionalEncoding if positions == "learned" else SinCosPositionalEncoding
    assert isinstance(model.embedding.pos_enc, kind)
    assert model.encoder.layer_0.norm_first and model.decoder.layer_0.norm_first
