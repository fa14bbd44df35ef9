"""Model configuration (counterpart of ``multimodalanalytical_tpu/models/config.py``).

The same field set as the JAX ``ModelConfig``, so one YAML model config
drives both packages, and the same derivation of the BART / T5 dimensions
from an HF checkpoint name (:func:`hf_architecture_kwargs`: an offline table
of the names the shipped configs use, or ``transformers.AutoConfig`` for a
local path). This package cannot import the JAX file, whose package
``__init__`` pulls in flax.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Encoder-alignment head config (reference custom_modeling.py:18-37)."""

    align_network: str = "convolutional"  # or "mlp"
    hidden_dimension: int = 256
    conv_channels: int = 512
    kernel_size: int = 5
    output_dimension: int = 1800
    loss_lambda: float = 50.0
    loss_function: str = "mae"  # mse | mae | sid


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_attention_heads: int = 8
    decoder_attention_heads: int = 8
    encoder_ffn_dim: int = 2048
    decoder_ffn_dim: int = 2048
    dropout: float = 0.1
    activation_function: str = "gelu"
    # True => pre-LN (norm_first); name kept for reference config parity.
    post_layer_normalisation: bool = True
    gated_linear: bool = False
    positional_encoding_type: str = "sin_cos"
    max_position_embeddings: int = 1024
    final_layer_norm: bool = True
    norm_type: str = "layernorm"          # layernorm | rmsnorm
    relative_position_bias: bool = False  # T5 bucketed attention bias
    use_absolute_positions: bool = True
    attention_bias: bool = True
    attention_scale: bool = True
    ffn_bias: bool = True
    lm_head_bias: bool = True
    tied_logits_scale: bool = False
    decoder_modality_norm: bool = True
    decoder_embedding_layernorm: bool = False

    vocab_size: int = 0
    pad_token_id: int = 0
    bos_token_id: int = 2
    eos_token_id: int = 3
    decoder_start_token_id: int = 2

    max_target_length: int = 128
    guided_generation: bool = False
    align_config: Optional[AlignConfig] = None

    # Execution knobs.
    dtype: str = "float32"         # compute dtype: float32 | bfloat16
    # Flash attention for long encoder sequences (Lq == Lk >= 2048):
    # ops/flash_attention.py, the CUDA kernels on a CUDA tensor.
    use_flash_attention: bool = True
    # Hand-written beam-decode attention kernels (ops/beam_attention.py).
    use_beam_kernel: bool = True
    # Beam-decode KV-cache storage: "int8" (per-slot-per-head symmetric
    # quantization) | "bfloat16". beam_search decides eligibility exactly as
    # the JAX package does.
    kv_cache_dtype: str = "int8"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


MODEL_PRESETS: Dict[str, Dict[str, Any]] = {
    "CustomModel": {},
    "BartForConditionalGeneration": {
        "positional_encoding_type": "sin_cos",
        "post_layer_normalisation": False,
        "final_layer_norm": False,
        "lm_head_bias": False,
        "decoder_modality_norm": False,
        "decoder_embedding_layernorm": True,
    },
    "CustomBartForConditionalGeneration": {
        "positional_encoding_type": "learned",
        "post_layer_normalisation": True,
    },
    "T5ForConditionalGeneration": {
        "norm_type": "rmsnorm",
        "activation_function": "relu",
        "relative_position_bias": True,
        "use_absolute_positions": False,
        "post_layer_normalisation": True,
        "attention_bias": False,
        "attention_scale": False,
        "ffn_bias": False,
        "lm_head_bias": False,
        "tied_logits_scale": True,
    },
}

_CONFIG_FIELDS = {f.name for f in dataclasses.fields(ModelConfig)}

# Architecture hyperparameters of the HF checkpoints that the shipped model
# configs name ('facebook/bart-base', 'google-t5/t5-small'), and their common
# siblings, as each checkpoint's config.json gives them. The reference reads
# them with AutoConfig.from_pretrained(model_name); this table answers for
# those names without the hub.
_HF_OFFLINE_ARCHITECTURES: Dict[str, Dict[str, Any]] = {
    "facebook/bart-base": dict(
        model_type="bart", d_model=768, encoder_layers=6, decoder_layers=6,
        encoder_attention_heads=12, decoder_attention_heads=12,
        encoder_ffn_dim=3072, decoder_ffn_dim=3072, dropout=0.1,
        activation_function="gelu", max_position_embeddings=1024,
    ),
    "facebook/bart-large": dict(
        model_type="bart", d_model=1024, encoder_layers=12, decoder_layers=12,
        encoder_attention_heads=16, decoder_attention_heads=16,
        encoder_ffn_dim=4096, decoder_ffn_dim=4096, dropout=0.1,
        activation_function="gelu", max_position_embeddings=1024,
    ),
    "google-t5/t5-small": dict(
        model_type="t5", d_model=512, d_ff=2048, num_layers=6,
        num_decoder_layers=6, num_heads=8, d_kv=64, dropout_rate=0.1,
        feed_forward_proj="relu", relative_attention_num_buckets=32,
        relative_attention_max_distance=128,
    ),
    "google-t5/t5-base": dict(
        model_type="t5", d_model=768, d_ff=3072, num_layers=12,
        num_decoder_layers=12, num_heads=12, d_kv=64, dropout_rate=0.1,
        feed_forward_proj="relu", relative_attention_num_buckets=32,
        relative_attention_max_distance=128,
    ),
}
_HF_OFFLINE_ARCHITECTURES["t5-small"] = _HF_OFFLINE_ARCHITECTURES["google-t5/t5-small"]
_HF_OFFLINE_ARCHITECTURES["t5-base"] = _HF_OFFLINE_ARCHITECTURES["google-t5/t5-base"]


def _hf_attrs(config_or_name: Any) -> Dict[str, Any]:
    """A flat attribute dict of an HF config object, a checkpoint name or a dict."""
    if isinstance(config_or_name, dict):
        return dict(config_or_name)
    if isinstance(config_or_name, str):
        if config_or_name in _HF_OFFLINE_ARCHITECTURES:
            return dict(_HF_OFFLINE_ARCHITECTURES[config_or_name])
        # A local path (or a warm HF cache) still works; any other name
        # fails with the table's names.
        try:
            from transformers import AutoConfig  # noqa: PLC0415 - optional, heavy

            cfg = AutoConfig.from_pretrained(config_or_name)
            return dict(cfg.to_dict(), model_type=cfg.model_type)
        except Exception as exc:  # noqa: BLE001 - re-raised with the table
            raise ValueError(
                f"Unknown HF checkpoint {config_or_name!r}: not in the offline "
                f"architecture table {sorted(_HF_OFFLINE_ARCHITECTURES)} and not "
                f"loadable locally ({exc})") from exc
    # A transformers PretrainedConfig, duck-typed.
    attrs = config_or_name.to_dict() if hasattr(config_or_name, "to_dict") else vars(config_or_name)
    attrs = dict(attrs)
    attrs.setdefault("model_type", getattr(config_or_name, "model_type", None))
    return attrs


def hf_architecture_kwargs(config_or_name: Any) -> Dict[str, Any]:
    """ModelConfig kwargs of an HF BART / T5 architecture: every stack
    dimension, the dropout and the activation, as the reference's
    ``load_bart_model`` / ``load_t5_model`` take them from
    ``AutoConfig.from_pretrained``. Takes a checkpoint name (the offline
    table or a local path), a ``transformers`` config object or an attr dict."""
    from .transformer import ACTIVATIONS

    a = _hf_attrs(config_or_name)
    model_type = a.get("model_type")
    if model_type == "bart":
        activation = a["activation_function"]
        if activation not in ACTIVATIONS:
            raise ValueError(f"Unsupported BART activation_function {activation!r}; this "
                             f"build implements {sorted(ACTIVATIONS)} (models/transformer.py)")
        return {key: a[key] for key in (
            "d_model", "encoder_layers", "decoder_layers", "encoder_attention_heads",
            "decoder_attention_heads", "encoder_ffn_dim", "decoder_ffn_dim", "dropout",
            "activation_function", "max_position_embeddings")}
    if model_type == "t5":
        if a["d_kv"] * a["num_heads"] != a["d_model"]:
            raise ValueError(
                f"T5 config has d_kv={a['d_kv']} x num_heads={a['num_heads']} != "
                f"d_model={a['d_model']}; this family derives head_dim = d_model // heads "
                "and cannot express decoupled d_kv")
        buckets = a.get("relative_attention_num_buckets", 32)
        max_distance = a.get("relative_attention_max_distance", 128)
        if (buckets, max_distance) != (32, 128):
            raise ValueError(
                f"T5 relative-bias shape ({buckets} buckets, max_distance {max_distance}) "
                "differs from the (32, 128) this build pins (ops/positional.py "
                "t5_relative_bucket)")
        proj = a.get("feed_forward_proj", "relu")
        gated = proj.startswith("gated-")
        act = proj[len("gated-"):] if gated else proj
        if act not in ("relu", "gelu"):
            raise ValueError(f"Unsupported T5 feed_forward_proj {proj!r}")
        if proj == "gated-gelu":
            # HF T5Config maps exactly "gated-gelu" to "gelu_new" (the tanh
            # approximation); a plain "gelu" stays exact-erf.
            act = "gelu_new"
        num_layers, num_decoder_layers = a["num_layers"], a.get("num_decoder_layers")
        return {
            "d_model": a["d_model"],
            "encoder_layers": num_layers,
            # HF falls back only on None: an explicit 0 stays 0.
            "decoder_layers": num_layers if num_decoder_layers is None else num_decoder_layers,
            "encoder_attention_heads": a["num_heads"],
            "decoder_attention_heads": a["num_heads"],
            "encoder_ffn_dim": a["d_ff"],
            "decoder_ffn_dim": a["d_ff"],
            "dropout": a["dropout_rate"],
            "activation_function": act,
            "gated_linear": gated,
        }
    raise ValueError(f"Unsupported HF model_type {model_type!r} (bart | t5)")


# The model types whose dimensions the reference reads from the named HF
# checkpoint; CustomModel and CustomBart take theirs from the YAML.
_HF_DERIVED_TYPES = ("BartForConditionalGeneration", "T5ForConditionalGeneration")


def resolve_model_config(
    model_config: Dict[str, Any],
    vocab_size: int,
    pad_token_id: int,
    bos_token_id: int,
    eos_token_id: int,
) -> ModelConfig:
    """Build a ModelConfig from a reference-style model YAML dict."""
    model_type = model_config.get("model_type", "CustomModel")
    if model_type not in MODEL_PRESETS:
        raise ValueError(f"Unknown model type {model_type}")
    merged: Dict[str, Any] = dict(MODEL_PRESETS[model_type])
    # The named checkpoint's dimensions first; the YAML's explicit keys
    # override them, as the reference's AutoConfig kwargs do.
    model_name = model_config.get("model_name")
    if model_name and model_type in _HF_DERIVED_TYPES:
        merged.update(hf_architecture_kwargs(model_name))
    for key, value in model_config.items():
        if key in _CONFIG_FIELDS and value is not None:
            merged[key] = value
    align = merged.get("align_config")
    if isinstance(align, dict):
        merged["align_config"] = AlignConfig(**align)
    merged.update(
        vocab_size=vocab_size,
        pad_token_id=pad_token_id,
        bos_token_id=bos_token_id,
        eos_token_id=eos_token_id,
        decoder_start_token_id=bos_token_id,
    )
    return ModelConfig(**merged)
