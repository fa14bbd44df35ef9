"""Model configuration (counterpart of ``multimodalanalytical_tpu/models/config.py``).

The same field set as the JAX ``ModelConfig``, so one YAML model config
drives both packages. This package cannot import the JAX file, whose package
``__init__`` pulls in flax. HF-name derivation of the BART/T5 dimensions
(``hf_architecture_kwargs``) is not ported yet; :func:`resolve_model_config`
raises for a config that would need it.
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
    if model_config.get("model_name") and model_type in _HF_DERIVED_TYPES:
        raise NotImplementedError(
            f"{model_type} derives its dimensions from the HF checkpoint "
            f"{model_config['model_name']!r}; that derivation is not ported yet")
    merged: Dict[str, Any] = dict(MODEL_PRESETS[model_type])
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
