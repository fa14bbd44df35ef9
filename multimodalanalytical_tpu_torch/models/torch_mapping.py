"""Map reference PyTorch state_dicts onto the JAX package's param tree
(a copy of ``multimodalanalytical_tpu/models/torch_mapping.py``).

The reference trains PyTorch models (CustomModel / HF BART / HF T5 inside
the ``HFWrapper`` LightningModule, reference modeling/wrapper.py:230-298 and
modeling/custom_modeling.py:323-508). This module holds the numpy-only
weight-layout mapping from those state_dicts to the JAX ``Seq2SeqModel``
param tree, with the architecture (layer count, GEGLU, align head, learned
positions, per-modality embedding type) inferred from the state_dict keys,
so one mapper covers every preset. The port names its parameters after that
tree, so ``models/weights.py:load_reference_state_dict`` carries a
reference checkpoint into the port as this mapping followed by
``load_flax_params``. The port keeps its own copy because the JAX package's
``models`` package imports flax. No torch import here: callers hand in
``{key: np.ndarray}``.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np

__all__ = [
    "custom_model_to_flax",
    "bart_to_flax",
    "t5_to_flax",
    "lightning_state_dict_to_flax",
    "detect_model_family",
]


def _t(w: np.ndarray) -> np.ndarray:
    """torch Linear weight (out, in) -> flax Dense kernel (in, out)."""
    return np.ascontiguousarray(w.T)


def _ln(sd: Dict[str, np.ndarray], name: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[name + ".weight"], "bias": sd[name + ".bias"]}


def _dense(sd, name, bias=True):
    out = {"kernel": _t(sd[name + ".weight"])}
    if bias:
        out["bias"] = sd[name + ".bias"]
    return out


def _mha_self(sd, name):
    """torch nn.MultiheadAttention (fused in_proj) -> fused qkv layout."""
    w, b = sd[name + ".in_proj_weight"], sd[name + ".in_proj_bias"]
    return {
        "qkv_proj": {"kernel": _t(w), "bias": b},
        "out_proj": {"kernel": _t(sd[name + ".out_proj.weight"]),
                     "bias": sd[name + ".out_proj.bias"]},
    }


def _mha_cross(sd, name):
    """torch nn.MultiheadAttention as cross-attention -> q + fused kv."""
    w, b = sd[name + ".in_proj_weight"], sd[name + ".in_proj_bias"]
    d = w.shape[1]
    return {
        "q_proj": {"kernel": _t(w[:d]), "bias": b[:d]},
        "kv_proj": {"kernel": _t(w[d:]), "bias": b[d:]},
        "out_proj": {"kernel": _t(sd[name + ".out_proj.weight"]),
                     "bias": sd[name + ".out_proj.bias"]},
    }


def _ff(sd, name, gated):
    ff = {
        "linear1": _dense(sd, name + ".linear1"),
        "linear2": _dense(sd, name + ".linear2"),
    }
    if gated:
        ff["gate"] = _dense(sd, name + ".gate")
    return ff


def _n_layers(sd: Dict[str, np.ndarray], pattern: str) -> int:
    """Count layers from keys matching ``pattern`` (one capture group)."""
    rx = re.compile(pattern)
    idx = {int(m.group(1)) for k in sd if (m := rx.match(k))}
    if not idx:
        raise ValueError(f"no layers matching {pattern!r} in state_dict")
    return max(idx) + 1


def _embedding_modalities(sd: Dict[str, np.ndarray], prefix: str):
    """Modality names under ``{prefix}.embedding_layer_dict``."""
    rx = re.compile(re.escape(prefix) + r"\.embedding_layer_dict\.([^.]+)\.")
    return sorted({m.group(1) for k in sd if (m := rx.match(k))})


def _embedding_params(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """Map the reference MultimodalEmbedding (modeling/utils.py:44-182).

    Per-modality layer type is inferred from the keys:
      * ``{base}.weight`` without ``.bias``      -> nn.Embedding (text/multiplets)
      * ``{base}.weight`` + ``{base}.bias``      -> 1-layer Linear patch proj
      * ``{base}.0.weight``, ``.2.weight``, ...  -> n-layer patch MLP
        (Sequential indices 0/2/4 are the Linears, odd slots the ReLUs)
    """
    out: Dict[str, Any] = {}
    for mod in _embedding_modalities(sd, prefix):
        base = f"{prefix}.embedding_layer_dict.{mod}"
        if base + ".bias" in sd:
            out[f"embed_{mod}"] = {"proj": _dense(sd, base)}
        elif base + ".weight" in sd:
            out[f"embed_{mod}"] = {"embedding": sd[base + ".weight"]}
        else:
            layers = sorted(
                int(m.group(1)) for k in sd
                if (m := re.match(re.escape(base) + r"\.(\d+)\.weight$", k))
            )
            out[f"embed_{mod}"] = {
                f"proj_{i}": _dense(sd, f"{base}.{li}")
                for i, li in enumerate(layers)
            }
        norm = f"{prefix}.embedding_norm_dict.{mod}"
        if norm + ".weight" in sd:
            out[f"norm_{mod}"] = _ln(sd, norm)
    pos = f"{prefix}.positional_encodings"
    if pos + ".pos_encodings.weight" in sd:  # learned positions
        out["pos_enc"] = {
            "pos_embed": {"embedding": sd[pos + ".pos_encodings.weight"]},
            "pos_norm": _ln(sd, pos + ".norm"),
        }
    return out


def _align_params(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """CustomModel align head (custom_modeling.py:363-396): mlp is
    Sequential(Linear, ReLU, Linear, Sigmoid); convolutional is
    Sequential(Linear, ReLU, Linear, Lambda, Conv1d, ReLU, Conv1d,
    Sigmoid, Lambda) -> fc1, fc2, conv1 (spatial), conv2 (1x1 == Dense)."""
    out = {
        "fc1": _dense(sd, "align_network.0"),
        "fc2": _dense(sd, "align_network.2"),
    }
    if "align_network.4.weight" in sd:  # convolutional
        conv1_w = sd["align_network.4.weight"]      # (out_ch, in_ch, k)
        conv2_w = sd["align_network.6.weight"]      # (out, in, 1)
        out["conv1"] = {
            "kernel": np.ascontiguousarray(conv1_w.transpose(2, 1, 0)),
            "bias": sd["align_network.4.bias"],
        }
        out["conv2"] = {"kernel": _t(conv2_w[:, :, 0]),
                        "bias": sd["align_network.6.bias"]}
    return out


def custom_model_to_flax(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Reference ``CustomModel`` state_dict -> our param tree.

    Layer count, GEGLU, align head, learned positions and embedding layer
    types are all inferred from the keys.
    """
    gated = "encoder.layers.0.gate.weight" in sd
    params: Dict[str, Any] = {
        "embedding": _embedding_params(sd, "embedding"),
        "encoder": {"final_norm": _ln(sd, "encoder.norm")},
        "decoder": {"final_norm": _ln(sd, "decoder.norm")},
        "lm_head": _dense(sd, "token_ff"),
    }
    for i in range(_n_layers(sd, r"encoder\.layers\.(\d+)\.")):
        params["encoder"][f"layer_{i}"] = {
            "self_attn": _mha_self(sd, f"encoder.layers.{i}.self_attn"),
            "ff": _ff(sd, f"encoder.layers.{i}", gated),
            "norm1": _ln(sd, f"encoder.layers.{i}.norm1"),
            "norm2": _ln(sd, f"encoder.layers.{i}.norm2"),
        }
    for i in range(_n_layers(sd, r"decoder\.layers\.(\d+)\.")):
        params["decoder"][f"layer_{i}"] = {
            "self_attn": _mha_self(sd, f"decoder.layers.{i}.self_attn"),
            "cross_attn": _mha_cross(sd, f"decoder.layers.{i}.multihead_attn"),
            "ff": _ff(sd, f"decoder.layers.{i}", gated),
            "norm1": _ln(sd, f"decoder.layers.{i}.norm1"),
            "norm2": _ln(sd, f"decoder.layers.{i}.norm2"),
            "norm3": _ln(sd, f"decoder.layers.{i}.norm3"),
        }
    if "align_network.0.weight" in sd:
        params["align_network"] = _align_params(sd)
    return params


def _hf_fused_self(sd, base, bias=True):
    """HF separate q/k/v/out projections -> our fused qkv layout."""
    kernel = np.concatenate(
        [_t(sd[f"{base}.{p}.weight"]) for p in ("q", "k", "v")], axis=1)
    out = {"qkv_proj": {"kernel": kernel},
           "out_proj": {"kernel": _t(sd[f"{base}.o.weight"])}}
    if bias:
        out["qkv_proj"]["bias"] = np.concatenate(
            [sd[f"{base}.{p}.bias"] for p in ("q", "k", "v")])
        out["out_proj"]["bias"] = sd[f"{base}.o.bias"]
    return out


def _hf_cross(sd, base, bias=True):
    out = {
        "q_proj": {"kernel": _t(sd[f"{base}.q.weight"])},
        "kv_proj": {"kernel": np.concatenate(
            [_t(sd[f"{base}.k.weight"]), _t(sd[f"{base}.v.weight"])], axis=1)},
        "out_proj": {"kernel": _t(sd[f"{base}.o.weight"])},
    }
    if bias:
        out["q_proj"]["bias"] = sd[f"{base}.q.bias"]
        out["kv_proj"]["bias"] = np.concatenate(
            [sd[f"{base}.k.bias"], sd[f"{base}.v.bias"]])
        out["out_proj"]["bias"] = sd[f"{base}.o.bias"]
    return out


def _rename_hf_bart(sd):
    """HF Bart names its projections q_proj/k_proj/v_proj/out_proj; normalize
    to the short q/k/v/o names the helpers use."""
    ren = {}
    for k, v in sd.items():
        k = (k.replace(".q_proj.", ".q.").replace(".k_proj.", ".k.")
              .replace(".v_proj.", ".v.").replace(".out_proj.", ".o."))
        ren[k] = v
    return ren


def bart_to_flax(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """HF ``BartForConditionalGeneration`` with the reference's surgery
    applied (wrapper.py:32-84: multimodal shared embedding, sincos
    positions, encoder layernorm_embedding -> Dummy) -> our BART preset."""
    sd = _rename_hf_bart(sd)
    params: Dict[str, Any] = {
        "embedding": _embedding_params(sd, "model.shared"),
        "decoder_emb_norm": _ln(sd, "model.decoder.layernorm_embedding"),
        "lm_head": {"kernel": _t(sd["lm_head.weight"])},
        "encoder": {}, "decoder": {},
    }
    for i in range(_n_layers(sd, r"model\.encoder\.layers\.(\d+)\.")):
        e = f"model.encoder.layers.{i}"
        params["encoder"][f"layer_{i}"] = {
            "self_attn": _hf_fused_self(sd, f"{e}.self_attn"),
            "ff": {"linear1": _dense(sd, f"{e}.fc1"),
                   "linear2": _dense(sd, f"{e}.fc2")},
            "norm1": _ln(sd, f"{e}.self_attn_layer_norm"),
            "norm2": _ln(sd, f"{e}.final_layer_norm"),
        }
    for i in range(_n_layers(sd, r"model\.decoder\.layers\.(\d+)\.")):
        d = f"model.decoder.layers.{i}"
        params["decoder"][f"layer_{i}"] = {
            "self_attn": _hf_fused_self(sd, f"{d}.self_attn"),
            "cross_attn": _hf_cross(sd, f"{d}.encoder_attn"),
            "ff": {"linear1": _dense(sd, f"{d}.fc1"),
                   "linear2": _dense(sd, f"{d}.fc2")},
            "norm1": _ln(sd, f"{d}.self_attn_layer_norm"),
            "norm2": _ln(sd, f"{d}.encoder_attn_layer_norm"),
            "norm3": _ln(sd, f"{d}.final_layer_norm"),
        }
    return params


def t5_to_flax(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """HF ``T5ForConditionalGeneration`` with the reference's surgery
    applied (wrapper.py:182-219) -> our T5 preset (RMSNorm scales only,
    bias-free attention, shared relative bias from block 0)."""
    params: Dict[str, Any] = {
        "embedding": _embedding_params(sd, "shared"),
        "lm_head": {"kernel": _t(sd["lm_head.weight"])},
        "encoder": {
            "final_norm": {"scale": sd["encoder.final_layer_norm.weight"]},
            "rel_bias": {"rel_bias": {"embedding": sd[
                "encoder.block.0.layer.0.SelfAttention"
                ".relative_attention_bias.weight"]}},
        },
        "decoder": {
            "final_norm": {"scale": sd["decoder.final_layer_norm.weight"]},
            "rel_bias": {"rel_bias": {"embedding": sd[
                "decoder.block.0.layer.0.SelfAttention"
                ".relative_attention_bias.weight"]}},
        },
    }
    for i in range(_n_layers(sd, r"encoder\.block\.(\d+)\.")):
        e = f"encoder.block.{i}"
        params["encoder"][f"layer_{i}"] = {
            "self_attn": _hf_fused_self(sd, f"{e}.layer.0.SelfAttention",
                                        bias=False),
            "ff": {"linear1": _dense(sd, f"{e}.layer.1.DenseReluDense.wi",
                                     bias=False),
                   "linear2": _dense(sd, f"{e}.layer.1.DenseReluDense.wo",
                                     bias=False)},
            "norm1": {"scale": sd[f"{e}.layer.0.layer_norm.weight"]},
            "norm2": {"scale": sd[f"{e}.layer.1.layer_norm.weight"]},
        }
    for i in range(_n_layers(sd, r"decoder\.block\.(\d+)\.")):
        d = f"decoder.block.{i}"
        params["decoder"][f"layer_{i}"] = {
            "self_attn": _hf_fused_self(sd, f"{d}.layer.0.SelfAttention",
                                        bias=False),
            "cross_attn": _hf_cross(sd, f"{d}.layer.1.EncDecAttention",
                                    bias=False),
            "ff": {"linear1": _dense(sd, f"{d}.layer.2.DenseReluDense.wi",
                                     bias=False),
                   "linear2": _dense(sd, f"{d}.layer.2.DenseReluDense.wo",
                                     bias=False)},
            "norm1": {"scale": sd[f"{d}.layer.0.layer_norm.weight"]},
            "norm2": {"scale": sd[f"{d}.layer.1.layer_norm.weight"]},
            "norm3": {"scale": sd[f"{d}.layer.2.layer_norm.weight"]},
        }
    return params


_FAMILY_MAPPERS = {
    "CustomModel": custom_model_to_flax,
    "BartForConditionalGeneration": bart_to_flax,
    "T5ForConditionalGeneration": t5_to_flax,
}


def detect_model_family(sd: Dict[str, np.ndarray]) -> str:
    """Infer which reference model family a (prefix-stripped) state_dict is."""
    if "token_ff.weight" in sd:
        return "CustomModel"
    if any(k.startswith("encoder.block.") for k in sd):
        return "T5ForConditionalGeneration"
    if any(k.startswith("model.encoder.layers.") for k in sd):
        return "BartForConditionalGeneration"
    raise ValueError(
        "unrecognized state_dict: expected a reference CustomModel, "
        "BartForConditionalGeneration or T5ForConditionalGeneration"
    )


def lightning_state_dict_to_flax(
    sd: Dict[str, np.ndarray], family: str = "auto"
) -> Dict[str, Any]:
    """Reference ``HFWrapper`` Lightning state_dict -> our param tree.

    The wrapper stores the model under ``hf_model.`` and ALSO holds a second
    reference to the embedding as ``multimodal_embedding.`` (wrapper.py:298)
    — the duplicate is dropped; a raw (unwrapped) model state_dict passes
    through unchanged.
    """
    if any(k.startswith("hf_model.") for k in sd):
        sd = {k[len("hf_model."):]: v for k, v in sd.items()
              if k.startswith("hf_model.")}
    if family == "auto":
        family = detect_model_family(sd)
    return _FAMILY_MAPPERS[family](sd)
