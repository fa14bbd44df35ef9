"""Operations and bytes of the flash attention forward (#5) in a decode's
prologue: one launch per encoder layer that takes it, over the whole
batch.

Operations: 2 Dh per (query, valid key) pair, for each of the two products
(Q.K and P.V) and each head, with every one of the encoder's ``Ls``
queries of a row against that row's valid keys. Bytes: the valid keys' bf16
K and V rows. Key tiles that hold only padding count as no work, so the
share shows what skipping them would buy.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from . import peaks


def forward(queries: int, valid_keys: int, heads: int, head_dim: int) -> Tuple[float, float]:
    """One launch: ``queries`` a row (Ls), ``valid_keys`` summed over the
    batch's rows."""
    flops = 2 * 2.0 * head_dim * heads * queries * valid_keys
    nbytes = 2 * valid_keys * heads * head_dim * 2
    return flops, float(nbytes)


def prologue_bound_s(config: Dict[str, Any], mask: np.ndarray, launches: int) -> float:
    """The least time the chip could take for ``launches`` forwards over
    one batch's encoder keep-mask (B, Ls)."""
    m = config["model"]
    heads = m["encoder_attention_heads"]
    flops, nbytes = forward(mask.shape[1], int(mask.sum()), heads, m["d_model"] // heads)
    return launches * peaks.bound_s(flops, nbytes)
