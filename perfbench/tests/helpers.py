"""Tiny configurations for CPU tests of the yardstick."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TINY_MODEL = {"d_model": 128, "encoder_layers": 2, "decoder_layers": 2,
              "encoder_attention_heads": 2, "decoder_attention_heads": 2,
              "encoder_ffn_dim": 256, "decoder_ffn_dim": 256, "max_target_length": 16}


def tiny_config(name: str = "ir_patches", **model) -> dict:
    with open(ROOT / "configs" / f"{name}.json") as f:
        config = json.load(f)
    config["model"].update(TINY_MODEL, **model)
    return config


RLE_DATA = {"RLE": {"type": "run_length_encoding", "column": "ir_spectra", "target": False,
                    "vocab_size": 105, "pad_token_id": 0, "preprocessor_arguments": {}}}


# Token-id modalities that the collator sends with more than plain ids:
# the peaks' own positions, or XVal values.
NOT_PLAIN_IDS = {
    "peak_positions": {"type": "peak_positional_encoding", "preprocessor_arguments": {}},
    "multiplets_xval": {"type": "multiplets",
                        "preprocessor_arguments": {"encoding": "numerical_encoding"}},
    "text_spectrum_xval": {"type": "text_spectrum",
                           "preprocessor_arguments": {"spectrum_to_text_y": "numerical_encoding"}},
}


def with_rle(config: dict, length: int) -> dict:
    """``config`` with the RLE IR recipe's layout: one run-length-encoded
    IR modality of ``length`` tokens (vocabulary 105) in place of its
    inputs, and its target."""
    config["data"] = {**copy.deepcopy(RLE_DATA), "Smiles": config["data"]["Smiles"]}
    config["lengths"] = {"RLE": length}
    return config


def rle_config(length: int, **model) -> dict:
    """The RLE IR recipe's layout on the tiny model."""
    return with_rle(tiny_config(**model), length)


def rle_traffic(low: int, high: int, **values) -> dict:
    """A decode backlog's traffic with RLE rows of ``low``-``high`` valid tokens."""
    return traffic("ir_patches.decode", valid_tokens={"RLE": {"low": low, "high": high}},
                   **values)


def traffic(cell: str, **values) -> dict:
    with open(ROOT / "workloads" / f"{cell}.json") as f:
        out = copy.deepcopy(json.load(f)["traffic"])
    out.update(values)
    return out
