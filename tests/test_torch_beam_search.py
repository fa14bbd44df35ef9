"""PyTorch port's beam search vs the JAX package's, on the same weights (CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")
jnp = jax.numpy

from multimodalanalytical_tpu.generation.beam_search import beam_search as jax_beam_search  # noqa: E402,E501
from multimodalanalytical_tpu.generation.beam_search import greedy_decode as jax_greedy  # noqa: E402,E501
from multimodalanalytical_tpu_torch.generation import beam_search as port_beam  # noqa: E402
from test_torch_model import build_pair, to_torch  # noqa: E402


def _run_both(beams, max_length, **pair_kw):
    jmodel, variables, model, batch = build_pair(**pair_kw)
    enc, mask = batch["encoder_inputs"], batch["encoder_mask"]
    want_seqs, want_scores = jax_beam_search(
        jmodel, variables, enc, jnp.asarray(mask), num_beams=beams, max_length=max_length)
    stats = {}
    got_seqs, got_scores = port_beam.beam_search(
        model, to_torch(enc), torch.as_tensor(mask), num_beams=beams,
        max_length=max_length, stats=stats)
    return (np.asarray(want_seqs), np.asarray(want_scores), got_seqs.numpy(),
            got_scores.numpy(), stats)


def test_fp32_beam_search_matches_jax_token_for_token():
    want_seqs, want_scores, got_seqs, got_scores, stats = _run_both(beams=4, max_length=16)
    np.testing.assert_array_equal(got_seqs, want_seqs)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5)
    assert 1 <= stats["steps"] <= 15
    assert (got_seqs[:, :, 0] == 2).all()
    assert (np.diff(got_scores, axis=1) <= 0).all()


def test_greedy_matches_jax():
    jmodel, variables, model, batch = build_pair()
    enc, mask = batch["encoder_inputs"], batch["encoder_mask"]
    want = jax_greedy(jmodel, variables, enc, jnp.asarray(mask), max_length=16)
    got = port_beam.greedy_decode(model, to_torch(enc), torch.as_tensor(mask), max_length=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw, beams, length, want", [
    (dict(d_model=512), 10, 128, True),        # the flagship serving config
    (dict(d_model=512), 4, 32, True),          # tests/test_beam_kernel.py int8 case
    (dict(d_model=128, decoder_attention_heads=2), 4, 16, True),
    (dict(d_model=64), 4, 16, False),          # head_dim 8
    (dict(d_model=512), 1, 128, False),        # greedy
    (dict(d_model=512), 40, 128, False),       # more than 32 beams
    (dict(d_model=512), 4, 8, False),          # flat slot axis 32 < 64
    (dict(d_model=512, kv_cache_dtype="bfloat16"), 10, 128, False),
    (dict(d_model=512, use_beam_kernel=False), 10, 128, False),
])
def test_int8_cache_decision(kw, beams, length, want):
    """The port picks the JAX package's cache type (beam_search.py:87-97)."""
    from multimodalanalytical_tpu_torch.models.config import ModelConfig

    assert port_beam.kv_cache_quantized(ModelConfig(**kw), beams, length) is want


def test_top_k_breaks_ties_toward_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    values, indices = port_beam._top_k(x, 3)
    want_values, want_indices = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(indices.numpy(), np.asarray(want_indices))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_values))


def test_decode_model_pre_casts_the_bf16_dense_biases():
    """``decode_model`` pre-casts the bias of every Dense layer that computes
    in bf16 (each call would cast it to the same bf16 values), so no such
    bias is fp32 in the decode model; LayerNorm parameters and the fp32
    lm_head keep fp32, and the trained model is left as it was."""
    from multimodalanalytical_tpu_torch.ops.layers import Dense, LayerNorm

    _, _, model, _ = build_pair(dtype="bfloat16")
    decoding = port_beam.decode_model(model)
    original = dict(model.named_modules())
    cast = 0
    for name, module in decoding.named_modules():
        if isinstance(module, Dense) and module.bias is not None:
            if module.dtype == torch.bfloat16:
                assert module.bias.dtype == torch.bfloat16, name
                assert torch.equal(module.bias, original[name].bias.to(torch.bfloat16)), name
                cast += 1
            else:
                assert name == "lm_head" and module.bias.dtype == torch.float32
        if isinstance(module, LayerNorm):
            assert module.weight.dtype == module.bias.dtype == torch.float32, name
    assert cast >= 4 * 2 + 2 * 2      # attention and FFN Dense layers of the decoder
    assert all(p.dtype == torch.float32 for p in model.parameters())
