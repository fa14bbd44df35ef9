"""Counts over the beam searches a run recorded (``decode_backlog`` and
``serve_open`` records): each search's step positions, its batch's valid
encoder tokens, and from them the model operations and the decode kernels'
bounds."""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence, Tuple

import numpy as np

from . import kernels, model, peaks


def positions(stats: Dict[str, Any]) -> List[int]:
    """The ``pos`` of each step a search ran: 0, 1, ... up to the device
    step count at its end, where a step run past the exit stays."""
    return [min(i, stats["steps"]) for i in range(stats["replays"])]


def patch_tokens(config: Dict[str, Any], mask: np.ndarray) -> Tuple[int, int]:
    """(valid patch tokens of the batch, values per patch), from the
    encoder layout of the configuration's input modalities."""
    width = total = 0
    offset = 0
    for modality, spec in config["data"].items():
        if spec["target"]:
            continue
        length = config["lengths"][modality]
        if spec["type"] == "1D_patches":
            width = spec["preprocessor_arguments"]["patch_size"]
            total += int(mask[:, offset:offset + length].sum())
        offset += length
    return total, width


def search_flops(config: Dict[str, Any], stats: Dict[str, Any], mask: np.ndarray,
                 beams: int) -> float:
    valid = mask.sum(axis=1)
    tokens, width = patch_tokens(config, mask)
    return model.decode_search(config, mask.shape[0], beams, valid, positions(stats),
                               tokens, width)


def select_bound_s(config: Dict[str, Any], stats: Dict[str, Any], batch: int, beams: int
                   ) -> float:
    m = config["model"]
    d, heads, layers = m["d_model"], m["decoder_attention_heads"], m["decoder_layers"]
    return layers * sum(peaks.bound_s(*kernels.select_update(batch, beams, d, heads, pos))
                        for pos in positions(stats))


def cross_bound_s(config: Dict[str, Any], stats: Dict[str, Any], mask: np.ndarray,
                  beams: int) -> float:
    m = config["model"]
    flops, nbytes = kernels.cross(mask.shape[0], beams, m["d_model"], int(mask.sum()),
                                  mask.shape[1])
    return m["decoder_layers"] * stats["replays"] * peaks.bound_s(flops, nbytes)


def kernel_time(ops: Dict[str, Sequence[float]], names: Iterable[str]) -> Tuple[float, int]:
    """(device seconds, launches) of the trace's operations whose name
    holds any of ``names``."""
    seconds, count = 0.0, 0
    for op, (s, n) in ops.items():
        if any(name in op for name in names):
            seconds += s
            count += n
    return seconds, count
