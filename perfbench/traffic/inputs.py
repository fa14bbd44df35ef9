"""Seeded inputs of every cell, made from the parameters of its traffic file.

Every size that sets the work (valid tokens per modality, target lengths,
arrival gaps) is drawn from the traffic file's own ``sizes_seed``, so every
run seed gets the same multiset of sizes; the run seed only permutes them
over the rows and draws the values (token ids, spectra). Token ids are
drawn from 4 upwards: 0-3 are the tokenizers' specials.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ..modality_types import TEXT_LIKE_TYPES, require_plain_ids
from .tokenizer import BOS_ID, EOS_ID, FixedVocabTokenizer

FIRST_ID = 4


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def _lengths(spec: Dict[str, int], rows: int, base: np.random.Generator) -> np.ndarray:
    """``step`` x a draw from low..high per row."""
    return spec.get("step", 1) * base.integers(spec["low"], spec["high"] + 1, rows)


def sizes(traffic: Dict[str, Any], rows: int, seed: int) -> Dict[str, np.ndarray]:
    """Per row, the valid tokens of each modality named under
    ``valid_tokens`` and the target length (``target_tokens``), drawn from
    ``sizes_seed`` and permuted by ``seed``."""
    base = np.random.default_rng(traffic["sizes_seed"])
    order = _rng(seed, 0).permutation(rows)
    specs = dict(traffic.get("valid_tokens", {}))
    if "target_tokens" in traffic:
        specs["target"] = traffic["target_tokens"]
    return {name: _lengths(spec, rows, base)[order] for name, spec in sorted(specs.items())}


def encoder_pool(config: Dict[str, Any], traffic: Dict[str, Any], seed: int
                 ) -> List[Tuple[Dict[str, np.ndarray], np.ndarray]]:
    """``traffic["pool"]`` collated encoder batches of ``traffic["batch"]``
    rows: (inputs by modality, keep-mask (B, Ls) int32), as the collator
    lays them out (int32 ids tail-padded with 0 for every token-id type
    that the collator sends as plain ids, float32 patches)."""
    batch, pool = traffic["batch"], traffic["pool"]
    rows = batch * pool
    valid = sizes(traffic, rows, seed)
    values = _rng(seed, 1)
    inputs: Dict[str, np.ndarray] = {}
    masks = []
    for modality, spec in config["data"].items():
        if spec["target"]:
            continue
        width = config["lengths"][modality]
        if spec["type"] in TEXT_LIKE_TYPES:
            require_plain_ids(modality, spec)
            keep = np.arange(width)[None, :] < valid[modality][:, None]
            ids = values.integers(FIRST_ID, spec["vocab_size"], (rows, width))
            inputs[modality] = np.where(keep, ids, 0).astype(np.int32)
        elif spec["type"] == "1D_patches":
            patch = spec["preprocessor_arguments"]["patch_size"]
            inputs[modality] = values.random((rows, width, patch), dtype=np.float32)
            keep = np.ones((rows, width), bool)
        else:
            raise ValueError(f"no traffic for modality type {spec['type']!r}")
        masks.append(keep)
    mask = np.concatenate(masks, axis=1).astype(np.int32)
    return [({m: x[i * batch:(i + 1) * batch] for m, x in inputs.items()},
             mask[i * batch:(i + 1) * batch]) for i in range(pool)]


def target_pool(config: Dict[str, Any], traffic: Dict[str, Any], seed: int
                ) -> List[Dict[str, np.ndarray]]:
    """Teacher-forcing targets for :func:`encoder_pool`'s rows: BOS, random
    tokens and EOS, ``target_tokens`` long with the BOS, padded to the max
    target length; labels are -100 on the padding."""
    batch, pool = traffic["batch"], traffic["pool"]
    rows = batch * pool
    width = config["model"]["max_target_length"]
    vocab = next(s["vocab_size"] for s in config["data"].values() if s["target"])
    lengths = sizes(traffic, rows, seed)["target"]
    tokens = _rng(seed, 2).integers(FIRST_ID, vocab, (rows, width + 1))
    tokens[:, 0] = BOS_ID
    tokens[np.arange(rows), lengths] = EOS_ID
    keep = np.arange(width)[None, :] < lengths[:, None]
    decoder_ids = np.where(keep, tokens[:, :-1], 0).astype(np.int32)
    labels = np.where(keep, tokens[:, 1:], -100).astype(np.int32)
    out = {"decoder_ids": decoder_ids, "decoder_mask": keep.astype(np.int32), "labels": labels}
    return [{k: v[i * batch:(i + 1) * batch] for k, v in out.items()} for i in range(pool)]


def arrivals(traffic: Dict[str, Any], seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of an open-loop Poisson stream
    at ``rate_per_s``: gaps drawn from ``sizes_seed`` for a stream a quarter
    longer than the window, permuted by ``seed``; the times inside the
    window."""
    rate = float(traffic["rate_per_s"])
    count = int(np.ceil(rate * seconds * 1.25)) + 16
    gaps = np.random.default_rng(traffic["sizes_seed"]).exponential(1.0 / rate, count)
    due = np.cumsum(gaps[_rng(seed, 3).permutation(count)])
    return due[due < seconds]


def serve_records(config: Dict[str, Any], traffic: Dict[str, Any], count: int, seed: int,
                  formula: FixedVocabTokenizer) -> List[Dict[str, Any]]:
    """``count`` one-spectrum records as a client posts them: a formula
    string of ``formula_tokens`` regex tokens and a spectrum as a list of
    floats. Spectra come from a pool of ``spectra_pool`` seeded ones."""
    points = config["spectrum_points"]
    base = np.random.default_rng(traffic["sizes_seed"])
    tokens = _lengths(traffic["formula_tokens"], count, base)[_rng(seed, 4).permutation(count)]
    values = _rng(seed, 5)
    spectra = [row.tolist() for row in values.random((traffic["spectra_pool"], points))]
    atoms = formula.atoms
    picks = values.integers(0, len(atoms), (count, int(tokens.max())))
    spectrum_of = values.integers(0, len(spectra), count)
    columns = [m for m, s in config["data"].items() if not s["target"]]
    text, patches = (next(m for m in columns if config["data"][m]["type"] == t)
                     for t in ("text", "1D_patches"))
    return [{text: "".join(atoms[j] for j in picks[i, :tokens[i]]),
             patches: spectra[spectrum_of[i]]} for i in range(count)]


def fit_spectra(config: Dict[str, Any], traffic: Dict[str, Any], seed: int) -> np.ndarray:
    """The spectra the patch preprocessor's mean and std are fitted on."""
    return _rng(seed, 6).random((traffic["fit_spectra"], config["spectrum_points"]))
