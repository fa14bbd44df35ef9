"""Positional encodings (counterpart of ``ops/positional.py``).

Sin/cos in the interleaved layout ([sin(p/w0), cos(p/w0), sin(p/w1), ...])
for checkpoint parity with the reference, learned positions (a table
followed by an fp32 LayerNorm), and T5's bucketed relative attention bias.
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


def t5_relative_bucket(relative_position: torch.Tensor, bidirectional: bool,
                       num_buckets: int = 32, max_distance: int = 128) -> torch.Tensor:
    """T5's relative-position bucketing (HF t5 ``_relative_position_bucket``):
    half the buckets for exact small offsets, the rest log-spaced, in fp32
    as the JAX package computes it (the truncation toward zero sits next to
    an integer at some offsets, so the fp32 operations are kept as they are).
    Runs on ``relative_position``'s device and never reads it on the host."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + torch.where(n < 0, num_buckets, 0)
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # A 0-d fp32 tensor filled on n's device (no host copy, so a CUDA graph
    # can capture it): a true division, where a Python divisor may become a
    # multiplication by its reciprocal.
    log_span = torch.log(torch.full((), max_distance / max_exact, device=n.device))
    val_large = max_exact + (torch.log(n.float() / max_exact + 1e-9) / log_span
                             * (num_buckets - max_exact)).to(torch.int32)
    val_large = val_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


class RelativePositionBias(nn.Module):
    """T5-style bucketed relative attention bias (HF modeling_t5
    ``T5Attention.compute_bias``): one fp32 (num_buckets, heads) table
    ``rel_bias`` per stack, shared by its layers as T5 shares block 0's."""

    def __init__(self, num_heads: int, bidirectional: bool, num_buckets: int = 32,
                 max_distance: int = 128, *, device=None, generator: torch.Generator):
        super().__init__()
        self.bidirectional = bidirectional
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.rel_bias = Embed(num_buckets, num_heads, stddev=1.0, device=device,
                              generator=generator)

    def forward(self, query_positions: torch.Tensor,
                key_positions: torch.Tensor) -> torch.Tensor:
        """(Lq,), (Lk,) integer positions on one device -> (1, H, Lq, Lk) fp32."""
        rel = key_positions[None, :] - query_positions[:, None]
        buckets = t5_relative_bucket(rel, self.bidirectional, self.num_buckets,
                                     self.max_distance)
        return self.rel_bias(buckets).permute(2, 0, 1)[None]
