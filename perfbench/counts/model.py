"""Model operations (multiply and add counted as two) of the CustomModel,
from the configuration's shapes and the valid tokens of each row.

Projections count every valid token's rows; attention counts q.k and p.v
over the keys each valid query attends (valid encoder keys; for the
decoder, its causal prefix). Embedding lookups, norms, softmax and the
elementwise work are left out. A training step is three forward passes
(forward, and a backward of twice its operations).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np


def _widths(config: Dict[str, Any]):
    m = config["model"]
    target = next(s for s in config["data"].values() if s["target"])
    return (m["d_model"], m["encoder_ffn_dim"], m["decoder_ffn_dim"], m["encoder_layers"],
            m["decoder_layers"], target["vocab_size"])


def encoder(config: Dict[str, Any], valid: Sequence[int], patch_tokens: int = 0,
            patch_width: int = 0) -> float:
    """The encoder over rows of ``valid`` tokens each, and the patch
    projection of ``patch_tokens`` patches of ``patch_width`` values."""
    d, f, _, layers, _, _ = _widths(config)
    n = np.asarray(valid, dtype=np.float64)
    per_layer = n.sum() * (8 * d * d + 4 * d * f) + 4 * d * (n * n).sum()
    return float(layers * per_layer + 2.0 * patch_tokens * patch_width * d)


def cross_kv(config: Dict[str, Any], valid_total: int) -> float:
    d, _, _, _, layers, _ = _widths(config)
    return float(layers * valid_total * 4 * d * d)


def decoder_step(config: Dict[str, Any], rows: int, pos: int) -> float:
    """One beam step of ``rows`` = B x K rows at ``pos``: the decoder's
    projections and FFN, self-attention over pos + 1 times, and the
    lm_head (cross-attention: :func:`decode_search`)."""
    d, _, f, _, layers, vocab = _widths(config)
    linear = rows * (12 * d * d + 4 * d * f)
    attn = 4 * d * rows * (pos + 1)
    return float(layers * (linear + attn) + rows * 2 * d * vocab)


def decode_search(config: Dict[str, Any], batch: int, beams: int, valid: Sequence[int],
                  steps: Sequence[int], patch_tokens: int = 0, patch_width: int = 0) -> float:
    """One beam search: the encoder, the cross K/V, and one decoder step
    per entry of ``steps`` (its ``pos``), with cross-attention over each
    row's valid keys."""
    d, _, _, _, layers, _ = _widths(config)
    valid_total = int(np.sum(valid))
    total = encoder(config, valid, patch_tokens, patch_width) + cross_kv(config, valid_total)
    cross_attn = layers * 4.0 * d * beams * valid_total
    for pos in steps:
        total += decoder_step(config, batch * beams, pos) + cross_attn
    return total


def train_forward(config: Dict[str, Any], valid: Sequence[int], targets: Sequence[int],
                  patch_tokens: int = 0, patch_width: int = 0) -> float:
    """The teacher-forced forward of a batch: rows of ``valid`` encoder
    tokens and ``targets`` target tokens."""
    d, _, f, _, layers, vocab = _widths(config)
    src = np.asarray(valid, dtype=np.float64)
    tgt = np.asarray(targets, dtype=np.float64)
    total = encoder(config, valid, patch_tokens, patch_width) + cross_kv(config, int(src.sum()))
    linear = tgt.sum() * (12 * d * d + 4 * d * f)
    self_attn = 4 * d * (tgt * (tgt + 1) / 2).sum()
    cross_attn = 4 * d * (tgt * src).sum()
    return float(total + layers * (linear + self_attn + cross_attn) + tgt.sum() * 2 * d * vocab)
