"""Operations and bytes of one launch of the decode kernels.

Each input byte is counted once when read and each output byte once when
written, whatever the kernel reads again.

* #1 ``beam_select_attention_update`` (int8 cache) at step ``pos``: q and
  this step's bf16 K/V rows in, the output and the step's int8 K/V rows
  and fp32 scales out, the ancestry's ``pos + 1`` entries per beam, and
  of the cache rows of the ``pos`` earlier times (K and V planes with
  their scales) only those certain to be read: one lineage per batch row.
  The K beams of a row read each distinct row their histories name once,
  between one row a time (all beams share an ancestor) and K; how many
  are distinct only the ancestry says, which the program keeps inside the
  step's graph, so the count takes the least. Operations: q.k and p.v
  over ``pos + 1`` times for every beam.
* #2 ``beam_cross_attention``: q in and the output out, the K and V rows
  of the valid encoder keys only, the (B, Ls) fp32 key bias; operations
  over the valid keys only.
"""

from __future__ import annotations

from typing import Tuple


def select_update(batch: int, beams: int, d_model: int, heads: int, pos: int
                  ) -> Tuple[float, float]:
    rows = batch * beams
    row_bytes = d_model + 4 * heads                   # int8 row + its fp32 scales
    history = 2 * batch * pos * row_bytes             # one lineage per batch row
    q_out = 2 * rows * d_model * 2
    fresh = 2 * rows * (2 * d_model + row_bytes)      # bf16 K/V in, int8 rows + scales out
    ancestry = rows * (pos + 1) * 4
    flops = 4.0 * rows * (pos + 1) * d_model
    return flops, float(history + q_out + fresh + ancestry)


def cross(batch: int, beams: int, d_model: int, valid_keys: int, keys: int
          ) -> Tuple[float, float]:
    """``valid_keys``: summed over the batch's rows; ``keys``: Ls."""
    flops = 4.0 * beams * valid_keys * d_model
    nbytes = (2 * batch * beams + 2 * valid_keys) * d_model * 2 + batch * keys * 4
    return flops, float(nbytes)
