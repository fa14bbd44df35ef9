"""The BART and T5 presets through the port against the JAX package.

The HF-name derivation of the BART / T5 dimensions and ``resolve_model_config``
on every shipped model config; T5's RMSNorm, relative-position buckets and
bias; and, on each of the four shipped BART / T5 configs (``bart_medium``,
``hf_bart_medium``, ``custom_hf_bart``, ``t5_small``) cut to 2 + 2 layers at
d_model 64, the fp32 forward, teacher-forced beam decode steps and the full
beam search at K 4 on the same seeded weights (the JAX param tree, carried by
``load_flax_params``), on the CPU.
"""

import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
jnp = jax.numpy
yaml = pytest.importorskip("yaml")

import flax.linen as flax_nn  # noqa: E402

from multimodalanalytical_tpu.generation.beam_search import beam_search as jax_beam_search  # noqa: E402,E501
from multimodalanalytical_tpu.models import Seq2SeqModel as JaxModel  # noqa: E402
from multimodalanalytical_tpu.models import config as jax_config  # noqa: E402
from multimodalanalytical_tpu.ops import positional as jax_positional  # noqa: E402
from multimodalanalytical_tpu_torch.generation import beam_search as port_beam  # noqa: E402
from multimodalanalytical_tpu_torch.models import config as port_config  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.models.weights import load_flax_params  # noqa: E402
from multimodalanalytical_tpu_torch.ops import attention as port_attention  # noqa: E402
from multimodalanalytical_tpu_torch.ops import positional as port_positional  # noqa: E402
from multimodalanalytical_tpu_torch.ops.layers import RMSNorm  # noqa: E402
from test_torch_model import (  # noqa: E402
    VOCAB,
    _decode_steps_jax,
    _decode_steps_torch,
    data_config,
    example_batch,
    random_params,
    to_torch,
)

REPO = Path(__file__).resolve().parents[1]
MODEL_DIR = REPO / "configs" / "model"
PRESET_CONFIGS = ("bart_medium", "hf_bart_medium", "custom_hf_bart", "t5_small")
SMALL = dict(d_model=64, encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
             decoder_attention_heads=4, encoder_ffn_dim=128, decoder_ffn_dim=128)
IDS = dict(vocab_size=VOCAB, pad_token_id=0, bos_token_id=2, eos_token_id=3)
MAX_LENGTH = 16


def shipped(name):
    return yaml.safe_load((MODEL_DIR / f"{name}.yaml").read_text())


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("name", sorted(jax_config._HF_OFFLINE_ARCHITECTURES))
def test_hf_architecture_kwargs_match_jax_for_the_offline_table(name):
    got = port_config.hf_architecture_kwargs(name)
    assert got == jax_config.hf_architecture_kwargs(name)
    assert port_config._HF_OFFLINE_ARCHITECTURES[name] == jax_config._HF_OFFLINE_ARCHITECTURES[name]


T5_ATTRS = dict(model_type="t5", d_model=512, d_ff=1024, num_layers=8, num_decoder_layers=8,
                num_heads=8, d_kv=64, dropout_rate=0.1, feed_forward_proj="relu")
BART_ATTRS = dict(model_type="bart", d_model=256, encoder_layers=3, decoder_layers=2,
                  encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=512,
                  decoder_ffn_dim=1024, dropout=0.2, activation_function="relu",
                  max_position_embeddings=512)


@pytest.mark.parametrize("attrs", [
    BART_ATTRS,
    dict(T5_ATTRS, feed_forward_proj="gated-gelu"),
    dict(T5_ATTRS, feed_forward_proj="gated-relu"),
    dict(T5_ATTRS, feed_forward_proj="gelu"),
    dict(T5_ATTRS, num_decoder_layers=0),
    dict(T5_ATTRS, num_decoder_layers=None),
], ids=["bart", "t5-gated-gelu", "t5-gated-relu", "t5-gelu", "t5-zero-decoder", "t5-none"])
def test_hf_architecture_kwargs_match_jax_for_attr_dicts(attrs):
    got = port_config.hf_architecture_kwargs(dict(attrs))
    assert got == jax_config.hf_architecture_kwargs(dict(attrs))


def test_hf_architecture_kwargs_details():
    """gated-gelu is the tanh GELU; only None falls back to num_layers."""
    gated = port_config.hf_architecture_kwargs(dict(T5_ATTRS, feed_forward_proj="gated-gelu"))
    assert gated["gated_linear"] and gated["activation_function"] == "gelu_new"
    plain = port_config.hf_architecture_kwargs(dict(T5_ATTRS, feed_forward_proj="gelu"))
    assert not plain["gated_linear"] and plain["activation_function"] == "gelu"
    assert port_config.hf_architecture_kwargs(dict(T5_ATTRS, num_decoder_layers=0))[
        "decoder_layers"] == 0
    assert port_config.hf_architecture_kwargs(dict(T5_ATTRS, num_decoder_layers=None))[
        "decoder_layers"] == 8


@pytest.mark.parametrize("attrs, match", [
    (dict(T5_ATTRS, d_kv=128), "d_kv"),
    (dict(T5_ATTRS, relative_attention_num_buckets=64), "relative-bias"),
    (dict(T5_ATTRS, relative_attention_max_distance=256), "relative-bias"),
    (dict(T5_ATTRS, feed_forward_proj="gated-silu"), "feed_forward_proj"),
    (dict(BART_ATTRS, activation_function="swish"), "activation_function"),
    (dict(BART_ATTRS, model_type="gpt2"), "model_type"),
], ids=["d_kv", "buckets", "max-distance", "silu", "swish", "gpt2"])
def test_hf_architecture_kwargs_refuse_what_jax_refuses(attrs, match):
    with pytest.raises(ValueError, match=match) as got:
        port_config.hf_architecture_kwargs(dict(attrs))
    with pytest.raises(ValueError) as want:
        jax_config.hf_architecture_kwargs(dict(attrs))
    assert str(got.value) == str(want.value)


def test_an_unknown_checkpoint_names_the_offline_table(monkeypatch):
    """A name outside the table goes to ``transformers.AutoConfig`` (stubbed
    here: it must not reach a hub) and its failure names the table."""
    def from_pretrained(name):
        raise OSError(f"{name} is not a local folder")

    stub = types.ModuleType("transformers")
    stub.AutoConfig = types.SimpleNamespace(from_pretrained=from_pretrained)
    monkeypatch.setitem(sys.modules, "transformers", stub)
    with pytest.raises(ValueError, match="offline architecture table") as err:
        port_config.hf_architecture_kwargs("nonexistent/model-name")
    assert "google-t5/t5-small" in str(err.value) and "not a local folder" in str(err.value)


def test_a_transformers_style_config_object_is_read():
    class T5Like:
        model_type = "t5"

        def to_dict(self):
            return {k: v for k, v in T5_ATTRS.items() if k != "model_type"}

    got = port_config.hf_architecture_kwargs(T5Like())
    assert got == jax_config.hf_architecture_kwargs(T5Like())
    assert got == port_config.hf_architecture_kwargs(dict(T5_ATTRS))


@pytest.mark.parametrize("name", sorted(p.stem for p in MODEL_DIR.glob("*.yaml")))
def test_every_shipped_model_config_resolves_as_in_jax(name):
    model = shipped(name)
    got = port_config.resolve_model_config(model, **IDS)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jax_config.resolve_model_config(model, **IDS))


def test_the_four_preset_configs_resolve_to_the_published_widths():
    """Each at d_model 512, 6 + 6 layers, 8 heads, FFN 2048; hf_bart_medium's
    explicit keys override bart-base's 768 / 12 / 3072 and it is post-LN
    without final norms; t5_small takes everything from the table."""
    for name in PRESET_CONFIGS:
        cfg = port_config.resolve_model_config(shipped(name), **IDS)
        assert (cfg.d_model, cfg.encoder_layers, cfg.decoder_layers,
                cfg.encoder_attention_heads, cfg.decoder_attention_heads,
                cfg.encoder_ffn_dim, cfg.decoder_ffn_dim) == (512, 6, 6, 8, 8, 2048, 2048), name
    hf_bart = port_config.resolve_model_config(shipped("hf_bart_medium"), **IDS)
    assert not hf_bart.post_layer_normalisation and not hf_bart.final_layer_norm
    t5 = port_config.resolve_model_config(shipped("t5_small"), **IDS)
    assert (t5.norm_type, t5.activation_function, t5.relative_position_bias,
            t5.attention_scale, t5.dropout) == ("rmsnorm", "relu", True, False, 0.1)


def test_chip_smoke_config_literals_equal_the_yaml_files():
    """chip_smoke.py carries the four configs as literals (the card's machine
    has no yaml): each equals the model config the port's loader composes."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from multimodalanalytical_tpu_torch.config import compose_config

    assert sorted(chip_smoke.PRESET_MODEL_CONFIGS) == sorted(PRESET_CONFIGS)
    for name, literal in chip_smoke.PRESET_MODEL_CONFIGS.items():
        composed = compose_config(REPO / "configs", "config_train",
                                  ["working_dir=/tmp/x", f"model={name}"])
        assert literal == composed["model"] == shipped(name), name


def test_chip_smoke_mixture_literals_equal_the_yaml_files():
    """Phase 10's model, data and mixture configs as chip_smoke.py carries
    them equal what the port's loader composes from the files."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from multimodalanalytical_tpu_torch.config import compose_config

    for mixture, literal in chip_smoke.MIXTURE_CONFIGS.items():
        composed = compose_config(REPO / "configs", "config_train", [
            "working_dir=/tmp/x", "model=custom_model_align",
            "data=ir/patches_mixture_text_align", f"mixture={mixture}"])
        assert composed["mixture"] == literal, mixture
        assert composed["model"] == chip_smoke.ALIGN_MODEL_CONFIG
        assert composed["data"] == chip_smoke.MIX_DATA_CONFIG


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_rmsnorm_matches_flax(dtype):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.normal(size=(3, 5, 64)) + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = flax_nn.RMSNorm(dtype=jnp.float32).apply({"params": {"scale": scale}}, jx)
    norm = RMSNorm(64)
    with torch.no_grad():
        norm.weight.copy_(torch.as_tensor(scale))
        got = norm(torch.as_tensor(np.asarray(jx.astype(jnp.float32))).to(
            torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["encoder", "decoder"])
def test_relative_buckets_equal_jax_over_4096_offsets(bidirectional):
    rel = np.arange(-4096, 4097, dtype=np.int32)
    want = np.asarray(jax_positional.t5_relative_bucket(jnp.asarray(rel), bidirectional))
    for dtype in (torch.int32, torch.int64):
        got = port_positional.t5_relative_bucket(torch.as_tensor(rel).to(dtype), bidirectional)
        np.testing.assert_array_equal(got.numpy(), want)
    # The offsets next to a bucket edge, where fp32 truncation decides.
    edges = {16: 26, -16: 10, 32: 28, -32: 12, 64: 30, -64: 14} if bidirectional else {
        -16: 16, -32: 21, -64: 26, -128: 31, 5: 0}
    for offset, bucket in edges.items():
        assert int(want[offset + 4096]) == bucket


@pytest.mark.parametrize("bidirectional", [True, False], ids=["encoder", "decoder"])
def test_relative_position_bias_matches_jax(bidirectional):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(32, 4)).astype(np.float32)
    module = port_positional.RelativePositionBias(4, bidirectional,
                                                  generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        module.rel_bias.weight.copy_(torch.as_tensor(table))
    jmodule = jax_positional.RelativePositionBias(4, bidirectional)
    variables = {"params": {"rel_bias": {"embedding": table}}}
    for q, k in ((np.arange(300), np.arange(300)), (np.array([37]), np.arange(64))):
        want = jmodule.apply(variables, jnp.asarray(q), jnp.asarray(k))
        with torch.no_grad():
            got = module(torch.as_tensor(q), torch.as_tensor(k))
        assert got.shape == (1, 4, len(q), len(k))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The decode form: a 0-d position tensor, never read on the host.
    with torch.no_grad():
        got = module(torch.tensor(37, dtype=torch.int32)[None], torch.arange(64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jmodule.apply(variables, jnp.asarray([37]), jnp.arange(64))))


# ------------------------------------------------------------ models
def preset_pair(name, dtype="float32", lm_sharpen=4.0, **overrides):
    """(jax model, variables, port model) of a shipped config cut to SMALL,
    on the same seeded weights; the two resolved configs equal field for
    field."""
    model_config = dict(shipped(name), **SMALL, dtype=dtype)
    model_config.update({"max_target_length": MAX_LENGTH, **overrides})
    jcfg = jax_config.resolve_model_config(model_config, **IDS)
    cfg = port_config.resolve_model_config(model_config, **IDS)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    norm = model_config.get("multimodal_norm", True)
    jmodel = JaxModel(config=jcfg, data_config=data_config(), target_modality="Smiles",
                      multimodal_norm=norm)
    batch = example_batch()
    shapes = jax.eval_shape(lambda key: jmodel.init(
        key, batch["encoder_inputs"], batch["encoder_mask"], batch["decoder_ids"],
        batch["decoder_mask"], batch["labels"], deterministic=True), jax.random.PRNGKey(0))
    params = random_params(shapes["params"])
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * lm_sharpen
    model = Seq2SeqModel(cfg, data_config(), "Smiles", multimodal_norm=norm)
    load_flax_params(model, params)
    return jmodel, {"params": params}, model


@pytest.fixture(scope="module", params=PRESET_CONFIGS)
def fp32_pair(request):
    # T5's tied logits scale (d ** -0.5) shrinks the logits: sharpen more.
    sharpen = 32.0 if request.param == "t5_small" else 4.0
    return request.param, preset_pair(request.param, lm_sharpen=sharpen)


def _forward_jax(jmodel, variables, batch):
    return jax.jit(lambda v, *a: jmodel.apply(v, *a, deterministic=True))(
        variables, batch["encoder_inputs"], batch["encoder_mask"], batch["decoder_ids"],
        batch["decoder_mask"], batch["labels"])


def _forward_port(model, batch):
    b = to_torch(batch)
    with torch.no_grad():
        return model(b["encoder_inputs"], b["encoder_mask"], b["decoder_ids"],
                     b["decoder_mask"], b["labels"])


def test_forward_logits_and_loss_match_jax(fp32_pair):
    _, (jmodel, variables, model) = fp32_pair
    batch = example_batch()
    want, got = _forward_jax(jmodel, variables, batch), _forward_port(model, batch)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("target_len", [1, 2, 10])
def test_the_decoder_adds_its_relative_bias_only_past_one_token(monkeypatch, target_len):
    """The JAX decoder adds its causal relative bias in a teacher-forced
    forward only when the target is longer than one token; the port copies
    that condition (one key takes any bias in its softmax, so the logits
    alone cannot show it): the decoder's table is read only past one token,
    and the logits equal JAX's at every length."""
    jmodel, variables, model = preset_pair("t5_small", lm_sharpen=32.0)
    batch = example_batch(target_len=target_len)
    batch["labels"][1, :] = 5
    batch["decoder_mask"][1, :] = 1
    calls = []
    original = model.decoder.rel_bias.forward
    monkeypatch.setattr(model.decoder.rel_bias, "forward",
                        lambda q, k: calls.append(len(q)) or original(q, k))
    want, got = _forward_jax(jmodel, variables, batch), _forward_port(model, batch)
    assert calls == ([] if target_len == 1 else [target_len])
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["hf_bart_medium", "t5_small"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_beam_decode_steps_match_jax(name, dtype):
    """Four teacher-forced beam decode steps with permuted ancestry (bf16
    cache in a bf16 model, fp32 in an fp32 one). fp32: the plain formulation
    on both sides (1e-4). bf16: the BART configs take the kernels' math on
    the CPU and the JAX package its XLA route, T5 the plain route on both;
    bf16 rounding in different places, carried through 2 layers (5e-2 of
    the logit range, tests/test_torch_model.py's bound)."""
    jmodel, variables, model = preset_pair(name, dtype=dtype, lm_sharpen=1.0,
                                           kv_cache_dtype="bfloat16")
    batch, beams, length, steps = example_batch(), 4, 16, 4
    rng = np.random.default_rng(1)
    tokens = rng.integers(4, VOCAB, (3, beams, steps)).astype(np.int32)
    anc = []
    for t in range(steps):
        a = rng.integers(0, beams, (3, beams, length)).astype(np.int32)
        a[:, :, t] = np.arange(beams)
        anc.append(a)
    want = _decode_steps_jax(jmodel, variables, batch, tokens, anc, beams, length, False)
    got = _decode_steps_torch(model, batch, tokens, anc, beams, length, False)
    tol = 1e-4 if dtype == "float32" else 5e-2 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["hf_bart_medium", "t5_small"])
def test_beam_search_matches_jax_token_for_token(name):
    jmodel, variables, model = preset_pair(name, lm_sharpen=32.0 if name == "t5_small" else 4.0)
    b = example_batch(seed=5)
    want_seqs, want_scores = jax_beam_search(jmodel, variables, b["encoder_inputs"],
                                             jnp.asarray(b["encoder_mask"]), num_beams=4,
                                             max_length=MAX_LENGTH, stage_size=8)
    t = to_torch(b)
    seqs, scores = port_beam.beam_search(model, t["encoder_inputs"], t["encoder_mask"],
                                         num_beams=4, max_length=MAX_LENGTH, stage_size=8)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-5, atol=1e-6)


def test_t5_decode_takes_the_stage_length_and_no_kernel(monkeypatch):
    """In a bf16 T5 decode (stages of 8, 16, 24 times) the relative bias
    is built over each stage's length from a 0-d position tensor, and the
    self- and cross-attention kernel routes are never taken (no scale, a
    bias: the JAX package's route choice); a BART config at the same widths
    takes both."""
    calls = {"select": 0, "cross": 0}

    def counting(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(port_attention, "beam_select_attention_update",
                        counting("select", port_attention.beam_select_attention_update))
    monkeypatch.setattr(port_attention, "beam_cross_attention",
                        counting("cross", port_attention.beam_cross_attention))
    b = to_torch(example_batch(seed=6))
    for name in ("t5_small", "hf_bart_medium"):
        _, _, model = preset_pair(name, dtype="bfloat16", max_target_length=24)
        decoder = port_beam.BeamDecoder(model)
        seen = []
        if name == "t5_small":
            rel_bias = decoder.dmodel.decoder.rel_bias
            original = rel_bias.forward

            def recording(query_positions, key_positions):
                seen.append((query_positions.ndim, query_positions.dtype, len(key_positions)))
                return original(query_positions, key_positions)

            monkeypatch.setattr(rel_bias, "forward", recording)
        calls.update(select=0, cross=0)
        stats = {}
        seqs, _ = decoder.search(b["encoder_inputs"], b["encoder_mask"], 4, max_length=24,
                                 stage_size=8, stats=stats)
        assert seqs.shape == (3, 4, 24)
        if name == "t5_small":
            assert calls == {"select": 0, "cross": 0}
            assert {length for _, _, length in seen} == {8, 16, 24}
            assert all(ndim == 1 and dtype == torch.int32 for ndim, dtype, _ in seen)
            assert len(seen) == stats["replays"]
        else:
            assert calls["select"] == calls["cross"] == 2 * stats["replays"] > 0
