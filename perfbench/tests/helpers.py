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


def traffic(cell: str, **values) -> dict:
    with open(ROOT / "workloads" / f"{cell}.json") as f:
        out = copy.deepcopy(json.load(f)["traffic"])
    out.update(values)
    return out
