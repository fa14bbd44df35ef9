"""Multimodal embedding (counterpart of ``models/embedding.py``).

Per-modality embedding: a token table for the token-id types
(``TEXT_LIKE_TYPES``), a patch projection (``linear``, ``linear_2_layer``
or ``linear_3_layer``) for ``1D_patches`` and ``msms_number``, a linear
projection of raw feature rows for ``no_action``; the per-modality fp32
LayerNorm (eps 1e-5) followed by the cast to the compute dtype,
sequence-axis concatenation in data_config order, and absolute positions
(sin/cos or learned).

Input protocol: ``inputs`` maps modality name to either
  * int token ids (B, L),
  * float patches or feature rows (B, L, n_features),
  * {"tokenized_input": ids, "numerical_values": floats}  (XVal scaling),
  * {"tokenized_input": ids, "token_indices": positions}  (positions
    gathered at the given indices; the other modalities keep
    arange(offset, offset + length) over their own span).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.layers import Dense, Embed, LayerNorm
from ..ops.positional import POS_ENC_REGISTRY

# Modality types whose input is a (B, L) tensor of token ids.
TEXT_LIKE_TYPES = (
    "text", "text_spectrum", "peak_positional_encoding",
    "run_length_encoding", "multiplets", "carbon", "msms_text",
)
PATCH_TYPES = ("1D_patches", "msms_number")
# Features per position of an msms_number row: m/z and intensity
# (data/preprocessing/msms_number.py).
MSMS_FEATURES = 2


def input_width(modality: str, modality_config: Dict[str, Any]) -> int:
    """Features per position of a projected modality: ``patch_size`` for
    ``1D_patches``, 2 for ``msms_number``, and for ``no_action`` the
    ``n_features`` that fitting the preprocessors writes into the modality's
    config. Flax infers the width at its first call; the port builds its
    layers eagerly and so needs it up front. Raises when it is not given."""
    mtype = modality_config["type"]
    if mtype == "1D_patches":
        width = (modality_config.get("preprocessor_arguments") or {}).get("patch_size")
    elif mtype == "msms_number":
        width = MSMS_FEATURES
    else:
        width = modality_config.get("n_features")
    if width is None:
        raise ValueError(f"modality {modality!r} ({mtype}): no input width in its config "
                         "(patch_size for 1D_patches, n_features for no_action)")
    return int(width)


class PatchProjection(nn.Module):
    """Linear / 2-layer / 3-layer patch embedder (parameters ``proj`` or
    ``proj_0`` ... ``proj_2``, as the JAX module names them)."""

    def __init__(self, in_features: int, d_model: int, encoding_type: str = "linear", *,
                 dtype=torch.float32, device=None, generator: torch.Generator):
        super().__init__()
        if encoding_type in ("linear", ""):
            widths = {"proj": (in_features, d_model)}
        elif encoding_type == "linear_2_layer":
            widths = {"proj_0": (in_features, d_model // 2),
                      "proj_1": (d_model // 2, d_model)}
        elif encoding_type == "linear_3_layer":
            third = d_model // 3
            widths = {"proj_0": (in_features, third), "proj_1": (third, 2 * third),
                      "proj_2": (2 * third, d_model)}
        else:
            raise NotImplementedError(f"Unknown encoding_type {encoding_type}")
        self.names = list(widths)
        for name, (fan_in, fan_out) in widths.items():
            self.add_module(name, Dense(fan_in, fan_out, dtype=dtype, device=device,
                                        generator=generator))

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        x = patches
        for i, name in enumerate(self.names):
            if i:
                x = torch.relu(x)
            x = getattr(self, name)(x)
        return x


class MultimodalEmbedding(nn.Module):
    def __init__(self, data_config: Dict[str, Any], d_model: int, *,
                 embedding_norm: bool = True, do_positional_encodings: bool = False,
                 positional_encodings_type: str = "sin_cos", max_seq_len: int = 1024,
                 unnormed: Tuple[str, ...] = (), dtype=torch.float32, device=None,
                 generator: torch.Generator):
        """``unnormed``: modalities always embedded without their norm, which
        then has no parameters (as in the JAX param tree, where an unused
        flax module creates none)."""
        super().__init__()
        self.modalities = list(data_config)
        self.embedding_norm = embedding_norm
        self.dtype = dtype
        for modality, modality_config in data_config.items():
            mtype = modality_config["type"]
            if mtype in TEXT_LIKE_TYPES:
                embed = Embed(modality_config["vocab_size"], d_model, dtype=dtype,
                              device=device, generator=generator)
            elif mtype in PATCH_TYPES or mtype == "no_action":
                args = modality_config.get("preprocessor_arguments") or {}
                encoding = "linear" if mtype == "no_action" else args.get("encoding_type",
                                                                          "linear")
                embed = PatchProjection(input_width(modality, modality_config), d_model,
                                        encoding, dtype=dtype, device=device,
                                        generator=generator)
            else:
                raise NotImplementedError(f"Unknown modality type: {mtype}")
            self.add_module(f"embed_{modality}", embed)
            if embedding_norm and modality not in unnormed:
                self.add_module(f"norm_{modality}", LayerNorm(d_model, device=device))
        self.pos_enc = None
        if do_positional_encodings:
            self.pos_enc = POS_ENC_REGISTRY[positional_encodings_type](
                d_model, max_seq_len, device=device, generator=generator)

    def embed_modality(self, modality: str, modality_input: Any, apply_norm: bool = True
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(embedding (B, L, D), explicit positions (B, L) or None)."""
        positions = None
        embed = getattr(self, f"embed_{modality}")
        if isinstance(modality_input, dict):
            embedding = embed(modality_input["tokenized_input"])
            if "numerical_values" in modality_input:      # XVal scaling
                embedding = embedding * modality_input["numerical_values"][..., None]
            positions = modality_input.get("token_indices")
        else:
            embedding = embed(modality_input)
        if self.embedding_norm and apply_norm:
            embedding = getattr(self, f"norm_{modality}")(embedding).to(self.dtype)
        return embedding, positions

    def forward(self, inputs: Dict[str, Any], decode_positions: Optional[torch.Tensor] = None,
                apply_norm: bool = True) -> torch.Tensor:
        """Embed and concatenate modalities along the sequence axis, in
        data_config order (never the input dict's). ``decode_positions``
        (B, L) overrides the positions (incremental decoding)."""
        ordered = [m for m in self.modalities if m in inputs]
        ordered += [m for m in inputs if m not in ordered]
        parts, position_parts, offset = [], [], 0
        for modality in ordered:
            embedding, positions = self.embed_modality(modality, inputs[modality], apply_norm)
            batch, length = embedding.shape[:2]
            if positions is None:
                positions = torch.arange(offset, offset + length,
                                         device=embedding.device).expand(batch, -1)
            parts.append(embedding)
            position_parts.append(positions)
            offset += length
        full = torch.cat(parts, dim=1)
        if self.pos_enc is not None:
            positions = (decode_positions if decode_positions is not None
                         else torch.cat(position_parts, dim=1))
            full = full + self.pos_enc(full, positions).to(full.dtype)
        return full
