"""Multimodal embedding (counterpart of ``models/embedding.py``).

Per-modality embedding (token table for ``text`` and for the token-id
spectrum sources ``run_length_encoding`` and ``text_spectrum``, which the
JAX package embeds like ``text``; linear patch projection for
``1D_patches``), the per-modality fp32 LayerNorm (eps 1e-5) followed by the
cast to the compute dtype, sequence-axis concatenation in data_config order,
and sin/cos positions. Other modality types, patch encoders and the dict
input protocol (XVal values, peak positions) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.layers import Dense, Embed, LayerNorm
from ..ops.positional import SinCosPositionalEncoding

# Modality types whose input is a (B, L) tensor of token ids.
TOKEN_TYPES = ("text", "run_length_encoding", "text_spectrum")


class PatchProjection(nn.Module):
    """The ``linear`` patch embedder (parameters under ``proj``)."""

    def __init__(self, patch_size: int, d_model: int, *, dtype=torch.float32,
                 device=None, generator: torch.Generator):
        super().__init__()
        self.proj = Dense(patch_size, d_model, dtype=dtype, device=device,
                          generator=generator)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return self.proj(patches)


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
            if mtype in TOKEN_TYPES:
                embed = Embed(modality_config["vocab_size"], d_model, dtype=dtype,
                              device=device, generator=generator)
            elif mtype == "1D_patches":
                args = modality_config.get("preprocessor_arguments") or {}
                if args.get("encoding_type", "linear") not in ("linear", ""):
                    raise NotImplementedError(
                        f"patch encoding_type {args['encoding_type']!r} is not ported yet")
                embed = PatchProjection(args["patch_size"], d_model, dtype=dtype,
                                        device=device, generator=generator)
            else:
                raise NotImplementedError(f"modality type {mtype!r} is not ported yet")
            self.add_module(f"embed_{modality}", embed)
            if embedding_norm and modality not in unnormed:
                self.add_module(f"norm_{modality}", LayerNorm(d_model, device=device))
        self.positional_encodings = None
        if do_positional_encodings:
            if positional_encodings_type != "sin_cos":
                raise NotImplementedError(
                    f"{positional_encodings_type!r} positions are not ported yet")
            self.positional_encodings = SinCosPositionalEncoding(d_model, max_seq_len,
                                                                 device=device)

    def embed_modality(self, modality: str, modality_input: torch.Tensor,
                       apply_norm: bool = True) -> torch.Tensor:
        if isinstance(modality_input, dict):
            raise NotImplementedError("dict modality inputs are not ported yet")
        embedding = getattr(self, f"embed_{modality}")(modality_input)
        if self.embedding_norm and apply_norm:
            embedding = getattr(self, f"norm_{modality}")(embedding).to(self.dtype)
        return embedding

    def forward(self, inputs: Dict[str, torch.Tensor],
                decode_positions: Optional[torch.Tensor] = None,
                apply_norm: bool = True) -> torch.Tensor:
        """Embed and concatenate modalities along the sequence axis, in
        data_config order (never the input dict's). ``decode_positions``
        (B, L) overrides the positions (incremental decoding)."""
        ordered = [m for m in self.modalities if m in inputs]
        ordered += [m for m in inputs if m not in ordered]
        parts = [self.embed_modality(m, inputs[m], apply_norm) for m in ordered]
        full = torch.cat(parts, dim=1)
        if self.positional_encodings is not None:
            positions = decode_positions
            if positions is None:
                positions = torch.arange(full.shape[1], device=full.device).expand(
                    full.shape[0], -1)
            full = full + self.positional_encodings(full, positions).to(full.dtype)
        return full
