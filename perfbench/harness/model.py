"""The program's model for a configuration, with weights made from the seed.

The weights are made on the model's device from ``--seed`` in one draw of
uniform values, cut into the state dict's leaves and scaled as the
program's initialisers scale them: Xavier-uniform matrices and tables
(per block of rows for the fused q/k/v and k/v projections), zero biases,
unit norm scales. The lm_head bias holds pad and BOS ``BLOCKED_LOGIT``
below the other tokens, as a trained output layer never emits them. The
same tensors go to the program, through its load path
(``load_state_dict``), and to the reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

BLOCKED_LOGIT = -30.0
BLOCKED_IDS = (0, 2)       # pad, BOS
FUSED_BLOCKS = {"qkv_proj": 3, "kv_proj": 2}


def model_config(config: Dict[str, Any]):
    from multimodalanalytical_tpu_torch.models.config import ModelConfig

    m = config["model"]
    target = next(s for s in config["data"].values() if s["target"])
    keys = ("d_model", "encoder_layers", "decoder_layers", "encoder_attention_heads",
            "decoder_attention_heads", "encoder_ffn_dim", "decoder_ffn_dim", "dropout",
            "post_layer_normalisation", "gated_linear", "positional_encoding_type",
            "max_position_embeddings", "final_layer_norm", "max_target_length", "dtype",
            "use_flash_attention", "kv_cache_dtype")
    return ModelConfig(vocab_size=target["vocab_size"], **{k: m[k] for k in keys})


def make_weights(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, from one seeded draw."""
    total = sum(math.prod(s) for s in shapes.values())
    generator = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=generator, device=device).mul_(2.0).sub_(1.0)
    weights, offset = {}, 0
    for name, shape in shapes.items():
        count = math.prod(shape)
        leaf = flat[offset:offset + count].view(shape)
        offset += count
        if len(shape) == 2:
            blocks = next((b for k, b in FUSED_BLOCKS.items() if f".{k}." in name), 1)
            leaf = leaf * math.sqrt(6.0 / (shape[1] + shape[0] // blocks))
        elif name.endswith(".bias"):
            leaf = torch.zeros(shape, device=device)
            if name == "lm_head.bias":
                leaf[list(BLOCKED_IDS)] = BLOCKED_LOGIT
        else:
            leaf = torch.ones(shape, device=device)
        weights[name] = leaf.contiguous()
    return weights


def build(config: Dict[str, Any], seed: int, device) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """(the program's Seq2SeqModel on ``device`` with the seed's weights,
    the weights as the reference takes them)."""
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel

    device = torch.device(device)
    target = next(m for m, s in config["data"].items() if s["target"])
    model = Seq2SeqModel(model_config(config), config["data"], target,
                         multimodal_norm=config["model"]["multimodal_norm"], device=device,
                         generator=torch.Generator(device=device).manual_seed(0))
    shapes = {name: t.shape for name, t in model.state_dict().items()}
    weights = make_weights(shapes, seed, device)
    model.load_state_dict(weights)
    return model, weights
