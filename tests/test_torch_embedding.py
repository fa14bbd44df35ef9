"""The port's multimodal embedding against the JAX ``MultimodalEmbedding``.

Every modality type, both dict input protocols (XVal values, peak
indices), the three patch encoders and both absolute position types run
through the JAX module and the port's on the same carried params (the JAX
init's tree, filled with seeded numpy weights, loaded by
``load_flax_params``) and the same seeded inputs, fp32 on the CPU, held at
rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more
jax = pytest.importorskip("jax")

from multimodalanalytical_tpu.models.embedding import (  # noqa: E402
    MultimodalEmbedding as JaxEmbedding,
)
from multimodalanalytical_tpu_torch.models.embedding import (  # noqa: E402
    PATCH_TYPES,
    TEXT_LIKE_TYPES,
    MultimodalEmbedding,
    input_width,
)
from multimodalanalytical_tpu_torch.models.weights import load_flax_params  # noqa: E402

D_MODEL, BATCH, VOCAB, MAX_LEN = 48, 3, 30, 96
RTOL, ATOL = 1e-5, 1e-6
# Sequence length and, for projected types, features per position.
LENGTHS = {"text": 7, "text_spectrum": 9, "peak_positional_encoding": 6,
           "run_length_encoding": 11, "multiplets": 10, "carbon": 5, "msms_text": 8,
           "1D_patches": 4, "msms_number": 6, "no_action": 1}
PATCH, N_FEATURES = 16, 5


def modality_config(mtype, encoding="linear"):
    cfg = {"type": mtype, "column": mtype, "target": False, "preprocessor_arguments": {}}
    if mtype in TEXT_LIKE_TYPES:
        cfg.update(vocab_size=VOCAB, pad_token_id=0)
    if mtype in PATCH_TYPES:
        cfg["preprocessor_arguments"]["encoding_type"] = encoding
    if mtype == "1D_patches":
        cfg["preprocessor_arguments"]["patch_size"] = PATCH
    if mtype == "no_action":
        cfg["n_features"] = N_FEATURES
    return cfg


def modality_input(rng, mtype, xval=False, indices=False):
    """Seeded numpy input of one modality (ids, rows, or a dict payload)."""
    length = LENGTHS[mtype]
    if mtype in TEXT_LIKE_TYPES:
        ids = rng.integers(1, VOCAB, (BATCH, length)).astype(np.int32)
        if not (xval or indices):
            return ids
        payload = {"tokenized_input": ids}
        if xval:
            payload["numerical_values"] = rng.normal(1.0, 0.5, (BATCH, length)).astype(
                np.float32)
        if indices:
            # Peak positions: increasing, some past the table (clipped).
            steps = rng.integers(1, 25, (BATCH, length))
            payload["token_indices"] = np.cumsum(steps, axis=1).astype(np.int32)
        return payload
    width = input_width(mtype, modality_config(mtype))
    return rng.normal(size=(BATCH, length, width)).astype(np.float32)


def random_params(tree, seed):
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, leaf in leaves:
        name = path[-1].key
        if name == "kernel":
            value = rng.normal(0.0, leaf.shape[0] ** -0.5, leaf.shape)
        elif name == "scale":
            value = 1.0 + 0.1 * rng.normal(size=leaf.shape)
        elif name == "embedding":
            value = rng.normal(0.0, 0.5, leaf.shape)
        else:
            value = 0.1 * rng.normal(size=leaf.shape)
        out.append(value.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def run_both(data_config, inputs, positions="sin_cos", norm=True, seed=0, **call):
    """(JAX output, port output) of the embedding on ``inputs``."""
    kw = dict(embedding_norm=norm, do_positional_encodings=positions is not None,
              positional_encodings_type=positions or "sin_cos", max_seq_len=MAX_LEN)
    jmod = JaxEmbedding(data_config=data_config, d_model=D_MODEL, **kw)
    shapes = jax.eval_shape(lambda key: jmod.init(key, inputs), jax.random.PRNGKey(0))
    params = random_params(shapes["params"], seed)
    want = jax.jit(lambda p, x: jmod.apply({"params": p}, x, **call))(params, inputs)
    port = MultimodalEmbedding(data_config, D_MODEL, generator=torch.Generator(), **kw)
    load_flax_params(port, params)
    call = {k: to_torch(v) for k, v in call.items()}
    with torch.no_grad():
        got = port(to_torch(inputs), **call)
    return np.asarray(want), got.numpy()


ALL_TYPES = list(LENGTHS)


@pytest.mark.parametrize("mtype", ALL_TYPES)
def test_each_modality_type_matches_jax(mtype):
    data_config = {"M": modality_config(mtype)}
    want, got = run_both(data_config, {"M": modality_input(np.random.default_rng(1), mtype)})
    assert got.shape == (BATCH, LENGTHS[mtype], D_MODEL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("positions", ["sin_cos", "learned", None])
@pytest.mark.parametrize("encoding", ["linear", "linear_2_layer", "linear_3_layer"])
def test_all_modalities_together_match_jax(encoding, positions):
    """Every type in one embedding, concatenated in data_config order (not
    the input dict's), with each patch encoder and position type; the
    multiplets as XVal dicts."""
    rng = np.random.default_rng(2)
    data_config = {f"M_{t}": modality_config(t, encoding) for t in ALL_TYPES}
    inputs = {f"M_{t}": modality_input(rng, t, xval=t == "multiplets")
              for t in reversed(ALL_TYPES)}
    want, got = run_both(data_config, inputs, positions=positions, seed=3)
    assert got.shape == (BATCH, sum(LENGTHS.values()), D_MODEL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("positions", ["sin_cos", "learned"])
@pytest.mark.parametrize("payload", ["xval", "indices", "xval+indices"])
def test_dict_protocols_match_jax(payload, positions):
    """A dict modality between two plain ones: XVal scales its embedding,
    token_indices place its positions (clipped to the table), and the
    modalities without indices keep arange over their own span."""
    rng = np.random.default_rng(4)
    data_config = {"Formula": modality_config("text"),
                   "Peaks": modality_config("peak_positional_encoding"),
                   "IR": modality_config("1D_patches")}
    inputs = {"Formula": modality_input(rng, "text"),
              "Peaks": modality_input(rng, "peak_positional_encoding",
                                      xval="xval" in payload, indices="indices" in payload),
              "IR": modality_input(rng, "1D_patches")}
    want, got = run_both(data_config, inputs, positions=positions, seed=5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_indices_in_one_modality_leave_the_others_on_their_own_span():
    """The modality with indices takes its positions from them (clipped to
    the table), the one after it keeps arange over its own span from the
    concatenation offset. One arange over the whole concatenation would
    give the indexed modality 0 .. L - 1 instead."""
    rng = np.random.default_rng(6)
    data_config = {"Peaks": modality_config("peak_positional_encoding"),
                   "IR": modality_config("1D_patches")}
    inputs = {"Peaks": modality_input(rng, "peak_positional_encoding", indices=True),
              "IR": modality_input(rng, "1D_patches")}
    want, got = run_both(data_config, inputs, positions="learned", norm=False, seed=7)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    port = MultimodalEmbedding(data_config, D_MODEL, do_positional_encodings=True,
                               positional_encodings_type="learned", max_seq_len=MAX_LEN,
                               embedding_norm=False, generator=torch.Generator().manual_seed(0))
    x = to_torch(inputs)
    offset = LENGTHS["peak_positional_encoding"]
    with torch.no_grad():
        full = port(x)
        peaks = port.embed_modality("Peaks", x["Peaks"])[0]
        ir = port.embed_modality("IR", x["IR"])[0]
        indexed = peaks + port.pos_enc(peaks, x["Peaks"]["token_indices"])
        arange = peaks + port.pos_enc(peaks, torch.arange(offset).expand(BATCH, -1))
        span = torch.arange(offset, offset + LENGTHS["1D_patches"]).expand(BATCH, -1)
        after = ir + port.pos_enc(ir, span)
    assert int(x["Peaks"]["token_indices"].max()) >= MAX_LEN     # some are clipped
    np.testing.assert_allclose(full[:, :offset].numpy(), indexed.numpy(), rtol=RTOL, atol=ATOL)
    assert not np.allclose(full[:, :offset].numpy(), arange.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(full[:, offset:].numpy(), after.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("positions", ["sin_cos", "learned"])
def test_decode_positions_and_apply_norm_match_jax(positions):
    """The decoder's call: one target token at an explicit step position,
    with and without the modality norm."""
    rng = np.random.default_rng(8)
    data_config = {"Smiles": modality_config("text")}
    ids = rng.integers(1, VOCAB, (BATCH, 1)).astype(np.int32)
    steps = np.full((BATCH, 1), 37, np.int32)
    for apply_norm in (True, False):
        want, got = run_both(data_config, {"Smiles": ids}, positions=positions, seed=9,
                             decode_positions=steps, apply_norm=apply_norm)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bfloat16_embedding_matches_jax():
    """bf16 compute: tables and projections round as flax's do, within one
    ulp of the output's largest magnitude; XVal multiplies under fp32
    promotion and the norms run in fp32."""
    rng = np.random.default_rng(10)
    data_config = {"Formula": modality_config("text"), "Multiplets": modality_config("multiplets"),
                   "IR": modality_config("1D_patches", "linear_2_layer")}
    inputs = {"Formula": modality_input(rng, "text"),
              "Multiplets": modality_input(rng, "multiplets", xval=True),
              "IR": modality_input(rng, "1D_patches")}
    import jax.numpy as jnp

    kw = dict(do_positional_encodings=True, positional_encodings_type="learned",
              max_seq_len=MAX_LEN)
    jmod = JaxEmbedding(data_config=data_config, d_model=D_MODEL, dtype=jnp.bfloat16, **kw)
    shapes = jax.eval_shape(lambda key: jmod.init(key, inputs), jax.random.PRNGKey(0))
    params = random_params(shapes["params"], 11)
    want = jax.jit(lambda p, x: jmod.apply({"params": p}, x))(params, inputs)
    port = MultimodalEmbedding(data_config, D_MODEL, dtype=torch.bfloat16,
                               generator=torch.Generator(), **kw)
    load_flax_params(port, params)
    with torch.no_grad():
        got = port(to_torch(inputs))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # bf16 products summed in another order round apart by an ulp of the
    # output's magnitude (2**-6 for values in [2, 4)).
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


@pytest.mark.parametrize("mtype,config,width", [
    ("1D_patches", {"preprocessor_arguments": {"patch_size": 75}}, 75),
    ("msms_number", {}, 2),
    ("no_action", {"n_features": 9}, 9),
])
def test_input_width_of_projected_types(mtype, config, width):
    assert input_width("M", {"type": mtype, **config}) == width


@pytest.mark.parametrize("mtype", ["1D_patches", "no_action"])
def test_missing_input_width_raises_with_the_modality_name(mtype):
    with pytest.raises(ValueError, match="'Spectrum'"):
        MultimodalEmbedding({"Spectrum": {"type": mtype, "preprocessor_arguments": {}}},
                            D_MODEL, generator=torch.Generator())


def test_unknown_types_raise():
    with pytest.raises(NotImplementedError, match="Unknown modality type"):
        MultimodalEmbedding({"M": {"type": "audio"}}, D_MODEL, generator=torch.Generator())
    with pytest.raises(NotImplementedError, match="encoding_type"):
        MultimodalEmbedding({"M": modality_config("1D_patches", "conv")}, D_MODEL,
                            generator=torch.Generator())
