"""PyTorch port vs the JAX package: forward, loss and beam decode steps.

Both packages run the same weights (the JAX model's param tree, filled with
seeded numpy weights, carried over by ``load_flax_params``) on the same numpy
inputs, at a tiny Formula + IR configuration, on the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
jnp = jax.numpy

from multimodalanalytical_tpu.models import ModelConfig as JaxConfig  # noqa: E402
from multimodalanalytical_tpu.models import Seq2SeqModel as JaxModel  # noqa: E402
from multimodalanalytical_tpu.models.config import MODEL_PRESETS  # noqa: E402
from multimodalanalytical_tpu_torch.models.config import ModelConfig  # noqa: E402
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.models.weights import load_flax_params  # noqa: E402

VOCAB = 24
FORMULA_LEN, N_PATCHES, PATCH = 12, 14, 125


def data_config(vocab=VOCAB):
    return {
        "Formula": {"type": "text", "column": "molecular_formula", "target": False,
                    "vocab_size": 32, "pad_token_id": 0, "preprocessor_arguments": {}},
        "IR": {"type": "1D_patches", "column": "ir_spectra", "target": False,
               "preprocessor_arguments": {"patch_size": PATCH}},
        "Smiles": {"type": "text", "column": "smiles", "target": True,
                   "vocab_size": vocab, "pad_token_id": 0, "preprocessor_arguments": {}},
    }


def example_batch(batch=3, target_len=10, seed=0):
    """Numpy inputs with Formula padding, a padded target and -100 labels."""
    rng = np.random.default_rng(seed)
    enc = {"Formula": rng.integers(4, 32, (batch, FORMULA_LEN)).astype(np.int32),
           "IR": rng.random((batch, N_PATCHES, PATCH)).astype(np.float32)}
    mask = np.ones((batch, FORMULA_LEN + N_PATCHES), np.int32)
    mask[0, 8:FORMULA_LEN] = 0
    enc["Formula"][0, 8:] = 0
    dec = rng.integers(4, VOCAB, (batch, target_len)).astype(np.int32)
    dmask = np.ones((batch, target_len), np.int32)
    dmask[1, 7:] = 0
    labels = rng.integers(4, VOCAB, (batch, target_len)).astype(np.int32)
    labels[1, 6:] = -100
    return {"encoder_inputs": enc, "encoder_mask": mask, "decoder_ids": dec,
            "decoder_mask": dmask, "labels": labels}


def random_params(tree, seed=0):
    """Seeded numpy weights for every leaf of a JAX param tree: Dense kernels
    ~ N(0, 1/fan_in), tables ~ N(0, 1/4), norm scales near 1, small non-zero
    biases (so every bias and norm path carries signal)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, leaf in leaves:
        name = path[-1].key
        if name == "kernel":
            value = rng.normal(0.0, leaf.shape[0] ** -0.5, leaf.shape)
        elif name == "embedding":
            value = rng.normal(0.0, 0.5, leaf.shape)
        elif name == "scale":
            value = 1.0 + 0.1 * rng.normal(size=leaf.shape)
        else:
            value = 0.1 * rng.normal(size=leaf.shape)
        out.append(value.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def build_pair(d_model=64, layers=2, heads=4, ffn=128, dtype="float32",
               kv_cache_dtype="int8", lm_sharpen=4.0, max_target_length=16,
               preset="CustomModel"):
    """(jax model, jax variables, port model, batch) on the same weights.

    The param tree is the JAX model's own (``Seq2SeqModel.init`` under
    ``jax.eval_shape``), filled with seeded numpy weights. ``lm_sharpen``
    scales the lm_head so logits are well separated and beam choices
    survive last-bit differences."""
    cfg = JaxConfig(
        d_model=d_model, encoder_layers=layers, decoder_layers=layers,
        encoder_attention_heads=heads, decoder_attention_heads=heads,
        encoder_ffn_dim=ffn, decoder_ffn_dim=ffn, vocab_size=VOCAB, dtype=dtype,
        kv_cache_dtype=kv_cache_dtype, max_target_length=max_target_length,
        **MODEL_PRESETS[preset])
    jmodel = JaxModel(config=cfg, data_config=data_config(), target_modality="Smiles")
    batch = example_batch()
    shapes = jax.eval_shape(lambda key: jmodel.init(
        key, batch["encoder_inputs"], batch["encoder_mask"], batch["decoder_ids"],
        batch["decoder_mask"], batch["labels"], deterministic=True), jax.random.PRNGKey(0))
    params = random_params(shapes["params"])
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * lm_sharpen
    model = Seq2SeqModel(ModelConfig(**dataclasses.asdict(cfg)), data_config(), "Smiles")
    load_flax_params(model, params)
    return jmodel, {"params": params}, model, batch


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree))


@pytest.mark.parametrize("preset", ["CustomModel", "BartForConditionalGeneration"])
def test_forward_logits_and_loss_match_jax(preset):
    """CustomModel (pre-LN) and the BART preset as the reference executes it
    (post-LN, no final norms, raw target embedding + layernorm_embedding)."""
    jmodel, variables, model, batch = build_pair(preset=preset)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, deterministic=True))(
        variables, batch["encoder_inputs"], batch["encoder_mask"], batch["decoder_ids"],
        batch["decoder_mask"], batch["labels"])
    b = to_torch(batch)
    with torch.no_grad():
        got = model(b["encoder_inputs"], b["encoder_mask"], b["decoder_ids"],
                    b["decoder_mask"], b["labels"])
    # fp32 on both sides; only the summation order differs.
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4, atol=1e-4)


def test_load_flax_params_checks_names_and_shapes():
    _, variables, model, _ = build_pair(layers=1)
    params = dict(variables["params"])
    with pytest.raises(ValueError, match="missing"):
        load_flax_params(model, {k: v for k, v in params.items() if k != "lm_head"})
    bad = dict(params, lm_head=dict(params["lm_head"], bias=np.zeros(VOCAB + 1, np.float32)))
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(model, bad)


def _decode_steps_jax(jmodel, variables, batch, tokens, anc, beams, length, quantize):
    enc, mask = batch["encoder_inputs"], jnp.asarray(batch["encoder_mask"])
    hidden = jax.jit(lambda v, e, m: jmodel.apply(v, e, m, method=JaxModel.encode))(
        variables, enc, mask)
    cache = jax.jit(lambda v, h: jmodel.apply(v, mask.shape[0], beams, length, h, quantize,
                                              method=JaxModel.init_beam_cache))(variables, hidden)
    step = jax.jit(lambda v, *a: jmodel.apply(v, *a, method=JaxModel.beam_decode_step))
    selves, out = cache["self"], []
    for t in range(tokens.shape[2]):
        logits, selves = step(variables, jnp.asarray(tokens[:, :, t]), t,
                              {"self": selves, "cross": cache["cross"]},
                              jnp.asarray(anc[t]), mask)
        out.append(np.asarray(logits, np.float32))
    return np.stack(out)


def _decode_steps_torch(model, batch, tokens, anc, beams, length, quantize):
    b = to_torch(batch)
    out = []
    with torch.no_grad():
        hidden = model.encode(b["encoder_inputs"], b["encoder_mask"])
        cache = model.init_beam_cache(hidden.shape[0], beams, length, hidden,
                                      b["encoder_mask"], quantize)
        for t in range(tokens.shape[2]):
            logits = model.beam_decode_step(torch.as_tensor(tokens[:, :, t]), t, cache,
                                            torch.as_tensor(anc[t]))
            out.append(logits.float().numpy())
    return np.stack(out)


@pytest.mark.parametrize("cache_kind, beams", [
    ("float32", 4), ("int8", 4), ("bfloat16", 4), ("bfloat16", 1)],
    ids=["float32", "int8", "bfloat16", "bfloat16-greedy"])
def test_beam_decode_steps_match_jax(cache_kind, beams):
    """Four teacher-forced beam decode steps with permuted ancestry.

    float32: fp32 model and cache, plain formulation on both sides (1e-4).
    int8: fp32 model, int8 cache at d_model 128 / 2 heads (the shapes the
    JAX int8 decision accepts); the JAX CPU path dequantizes to bf16 and the
    port's kernel math scales after the dot, so they agree to bf16 (2e-2).
    bfloat16: bf16 model and cache, bf16 rounding on both sides in
    different places, carried through 2 layers (5e-2 of the logit range).
    bfloat16-greedy: K = 1, as validation decodes; the port takes its
    kernel's numerics there, the JAX package its XLA route (same bound).
    """
    length, steps = 16, 4
    kw = dict(lm_sharpen=1.0)
    if cache_kind == "int8":
        kw.update(d_model=128, heads=2)
    if cache_kind == "bfloat16":
        kw.update(dtype="bfloat16", kv_cache_dtype="bfloat16")
    jmodel, variables, model, batch = build_pair(**kw)
    rng = np.random.default_rng(1)
    tokens = rng.integers(4, VOCAB, (3, beams, steps)).astype(np.int32)
    anc = []
    for t in range(steps):
        a = rng.integers(0, beams, (3, beams, length)).astype(np.int32)
        a[:, :, t] = np.arange(beams)
        anc.append(a)
    quantize = cache_kind == "int8"
    want = _decode_steps_jax(jmodel, variables, batch, tokens, anc, beams, length, quantize)
    got = _decode_steps_torch(model, batch, tokens, anc, beams, length, quantize)
    scale = max(1.0, float(np.abs(want).max()))
    tol = {"float32": 1e-4, "int8": 2e-2, "bfloat16": 5e-2 * scale}[cache_kind]
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
