"""The port against the reference's executed ``CustomModel``.

``tests/golden/reference_model_goldens.npz`` holds reference state_dicts,
inputs and the fp32 logits and losses of the reference's forward (see
``tests/test_reference_model_parity.py``, which holds the JAX package to
them). Here the same state_dicts reach the port through
``load_reference_state_dict`` (the port's copy of the reference mapping,
then ``load_flax_params``), and the port's forward must give the goldens at
the JAX test's own tolerances: conv / mlp / sid align heads, the
``linear_2_layer`` and ``linear_3_layer`` patch encoders, XVal multiplets
and learned positions; and the reference's executed HF BART and T5 graphs
(``bart_executed_graph``, ``t5_executed_graph``) on the BART and T5 presets.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; tiny shapes need no more

from multimodalanalytical_tpu_torch.models.config import (  # noqa: E402
    AlignConfig,
    ModelConfig,
    resolve_model_config,
)
from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel  # noqa: E402
from multimodalanalytical_tpu_torch.models.weights import load_reference_state_dict  # noqa: E402
from test_reference_model_parity import (  # noqa: E402
    CASES,
    D_MODEL,
    HF_CASES,
    VOCAB,
    _case_arrays,
    build_data_config,
)

GOLDEN = Path(__file__).parent / "golden" / "reference_model_goldens.npz"


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN, allow_pickle=False)


def port_model(case):
    align = AlignConfig(**case["align"]) if case.get("align") else None
    cfg = ModelConfig(
        d_model=D_MODEL, encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
        decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64, dropout=0.1,
        post_layer_normalisation=case["post_layer_normalisation"],
        gated_linear=case["gated_linear"],
        positional_encoding_type=case["positional_encoding_type"],
        max_position_embeddings=64, vocab_size=VOCAB, align_config=align)
    return Seq2SeqModel(cfg, build_data_config(case), "Smiles")


def run_case(model, case, ins):
    enc = {"Formula": torch.as_tensor(ins["Formula"]).long(),
           "IR": torch.as_tensor(ins["IR"]).float()}
    if case.get("xval"):
        enc["Multiplets"] = {
            "tokenized_input": torch.as_tensor(ins["Multiplets.tokenized_input"]).long(),
            "numerical_values": torch.as_tensor(ins["Multiplets.numerical_values"]).float()}
    target = torch.as_tensor(ins["align_target"]).float() if case.get("align") else None
    with torch.no_grad():
        return model(enc, torch.as_tensor(ins["enc_mask"]).int(),
                     torch.as_tensor(ins["dec_ids"]).long(),
                     torch.as_tensor(ins["dec_mask"]).int(),
                     torch.as_tensor(ins["labels"]).long(), align_target=target)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_reference(golden, name):
    case = CASES[name]
    sd, ins, outs = _case_arrays(golden, name)
    model = port_model(case)
    load_reference_state_dict(model, sd)
    res = run_case(model, case, ins)
    np.testing.assert_allclose(res["logits"].double().numpy(), outs["logits"], rtol=2e-4,
                               atol=2e-5, err_msg=f"{name}: logits")
    np.testing.assert_allclose(float(res["model_only_loss"]), float(outs["model_only_loss"]),
                               rtol=1e-5, atol=1e-6, err_msg=f"{name}: CE loss")
    if case.get("align"):
        np.testing.assert_allclose(float(res["alignment_loss"]),
                                   float(outs["alignment_loss"]), rtol=1e-4, atol=1e-6,
                                   err_msg=f"{name}: align loss")
    np.testing.assert_allclose(float(res["loss"]), float(outs["loss"]), rtol=1e-5, atol=1e-5,
                               err_msg=f"{name}: total loss")


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c.get("align")])
def test_align_head_weights_arrive_in_place(golden, name):
    """Every align-head tensor of the reference reaches the port unchanged:
    Linear weights as they are, the Conv1d kernel (out, in, k) as it is
    (through the mapping's flax (k, in, out) and back by one transpose),
    the 1x1 conv as a Dense weight."""
    sd, _, _ = _case_arrays(golden, name)
    model = port_model(CASES[name])
    load_reference_state_dict(model, sd)
    head = model.align_network
    pairs = [(head.fc1.weight, "align_network.0.weight"), (head.fc1.bias, "align_network.0.bias"),
             (head.fc2.weight, "align_network.2.weight"), (head.fc2.bias, "align_network.2.bias")]
    if CASES[name]["align"]["align_network"] == "convolutional":
        pairs += [(head.conv1.weight, "align_network.4.weight"),
                  (head.conv1.bias, "align_network.4.bias"),
                  (head.conv2.weight[:, :, None], "align_network.6.weight"),
                  (head.conv2.bias, "align_network.6.bias")]
        assert sd["align_network.4.weight"].ndim == 3
    for param, key in pairs:
        np.testing.assert_array_equal(param.detach().numpy(), sd[key], err_msg=key)


def test_lightning_checkpoint_keys_and_tensors_load(golden):
    """A Lightning ``HFWrapper`` state_dict (``hf_model.`` prefix, the
    duplicate ``multimodal_embedding.`` copy, torch tensors) loads as the
    bare state_dict does."""
    name = "postln_geglu_alignmlp_learned"
    sd, ins, outs = _case_arrays(golden, name)
    wrapped = {f"hf_model.{k}": torch.as_tensor(v) for k, v in sd.items()}
    wrapped.update({k.replace("embedding.", "multimodal_embedding.", 1): torch.as_tensor(v)
                    for k, v in sd.items() if k.startswith("embedding.")})
    model = port_model(CASES[name])
    load_reference_state_dict(model, wrapped)
    res = run_case(model, CASES[name], ins)
    np.testing.assert_allclose(float(res["loss"]), float(outs["loss"]), rtol=1e-5, atol=1e-5)


def test_a_state_dict_of_another_architecture_is_refused(golden):
    sd, _, _ = _case_arrays(golden, "preln_plain_sincos")
    model = port_model(CASES["preln_geglu_alignconv_sincos"])
    with pytest.raises(ValueError, match="missing"):
        load_reference_state_dict(model, sd)


def hf_port_model(model_type):
    """The BART / T5 preset at the goldens' widths, resolved as the JAX
    test resolves it."""
    cfg = resolve_model_config(
        {"model_type": model_type, "d_model": D_MODEL, "encoder_layers": 2,
         "decoder_layers": 2, "encoder_attention_heads": 4, "decoder_attention_heads": 4,
         "encoder_ffn_dim": 64, "decoder_ffn_dim": 64, "dropout": 0.1,
         "max_position_embeddings": 64},
        vocab_size=VOCAB, pad_token_id=0, bos_token_id=2, eos_token_id=3)
    return Seq2SeqModel(cfg, build_data_config({}), "Smiles")


@pytest.mark.parametrize("family", ["auto", "explicit"])
@pytest.mark.parametrize("name", list(HF_CASES))
def test_hf_graph_matches_executed_reference(golden, name, family):
    """The reference's executed HF graphs (its embedding and position
    surgery, BART's decoder layernorm_embedding without final stack norms,
    T5's RMSNorm, relative bias, unscaled bias-free attention and tied
    d**-0.5 logits) through ``load_reference_state_dict``, every key of the
    state_dict used once but BART's target-modality embedding norm, which
    its executed decoder never applies, at the JAX test's tolerances."""
    model_type, _ = HF_CASES[name]
    sd, ins, outs = _case_arrays(golden, name)
    model = hf_port_model(model_type)
    load_reference_state_dict(model, sd, family=model_type if family == "explicit" else "auto")
    res = run_case(model, {}, ins)
    np.testing.assert_allclose(res["logits"].double().numpy(), outs["logits"], rtol=2e-4,
                               atol=2e-5, err_msg=f"{name}: logits")
    np.testing.assert_allclose(float(res["loss"]), float(outs["loss"]), rtol=1e-5, atol=1e-6,
                               err_msg=f"{name}: loss")


def test_hf_state_dict_of_the_other_family_is_refused(golden):
    sd, _, _ = _case_arrays(golden, "t5_executed_graph")
    with pytest.raises(KeyError):
        load_reference_state_dict(hf_port_model("T5ForConditionalGeneration"), sd,
                                  family="BartForConditionalGeneration")
