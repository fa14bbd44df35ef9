"""Absolute positional encodings (counterpart of ``ops/positional.py``).

Sin/cos in the interleaved layout ([sin(p/w0), cos(p/w0), sin(p/w1), ...])
for checkpoint parity with the reference, and learned positions (a table
followed by an fp32 LayerNorm). The T5 relative bias is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .layers import Embed, LayerNorm


def sincos_table(max_seq_len: int, d_model: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """(max_seq_len, d_model) interleaved sin/cos table (computed on the host)."""
    exponents = np.arange(0, d_model, 2) / d_model
    inv_freq = 1.0 / (10000.0 ** exponents)
    angles = np.arange(max_seq_len)[:, None] * inv_freq[None, :]
    interleaved = np.stack([np.sin(angles), np.cos(angles)], axis=2)
    table = interleaved.reshape(max_seq_len, -1)[:, :d_model]
    return torch.as_tensor(table, dtype=dtype, device=device)


class SinCosPositionalEncoding(nn.Module):
    def __init__(self, d_model: int, max_seq_len: int = 1024, *, device=None,
                 generator: Optional[torch.Generator] = None):
        """``generator`` is unused (the table has no parameters); it keeps
        the registry's constructors alike."""
        super().__init__()
        self.max_seq_len = max_seq_len
        self.register_buffer("table", sincos_table(max_seq_len, d_model, device=device),
                             persistent=False)

    def forward(self, inputs: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encodings for ``inputs`` (B, L, D); ``positions`` (B, L) selects
        explicit rows, clipped to the table."""
        if positions is not None:
            return self.table[positions.long().clamp(0, self.max_seq_len - 1)]
        return self.table[None, : inputs.shape[1], :]


class LearnedPositionalEncoding(nn.Module):
    """A fp32 ``pos_embed`` table of ``max_seq_len`` rows, positions clipped
    to it, then the fp32 LayerNorm ``pos_norm`` (eps 1e-5), as the
    reference normalises learned positions."""

    def __init__(self, d_model: int, max_seq_len: int = 1024, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.pos_embed = Embed(max_seq_len, d_model, device=device, generator=generator)
        self.pos_norm = LayerNorm(d_model, device=device)

    def forward(self, inputs: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(inputs.shape[1], device=inputs.device)[None, :]
        return self.pos_norm(self.pos_embed(positions.long().clamp(0, self.max_seq_len - 1)))


POS_ENC_REGISTRY = {
    "sin_cos": SinCosPositionalEncoding,
    "learned": LearnedPositionalEncoding,
}
