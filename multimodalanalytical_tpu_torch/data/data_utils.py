"""Preprocessor fitting and artifact (de)serialization.

Reference behavior: src/analytical_fm/data/data_utils.py:40-129 (fit one
preprocessor per modality on a <=10k-row sample and inject vocab/pad/feature
info back into the data config).

Deviation (deliberate): the fitted state persists as a **JSON artifact**
(`preprocessor.json`), not a pickle (reference cli/training.py:111-112) —
versionable, language-neutral, and safe to load.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np

from ..configuration import DEFAULT_SETTINGS
from .preprocessing import PREPROCESSORS
from .tokenizer import RegexTokenizer, build_regex_tokenizer

logger = logging.getLogger(__name__)

ARTIFACT_VERSION = 1


def sample_rows(n_rows: int, budget: int = 0, seed: int | None = None) -> np.ndarray:
    """Random row indices used for preprocessor fitting (with replacement, like
    the reference's np.random.randint at data_utils.py:56-58)."""
    budget = budget or DEFAULT_SETTINGS.default_samples
    rng = np.random.default_rng(DEFAULT_SETTINGS.default_seed if seed is None else seed)
    return rng.integers(0, n_rows, size=min(budget, n_rows))


def load_tokenizer(path, modality: str) -> RegexTokenizer:
    """Load a tokenizer from a bare RegexTokenizer JSON or from a full
    ``preprocessor.json`` artifact (reference data_utils.py:63-65 semantics:
    reuse a pretrained tokenizer across dataset changes)."""
    with Path(path).open() as f:
        payload = json.load(f)
    if "tokenizer" in payload:                      # bare RegexTokenizer.to_json
        return RegexTokenizer.from_json(payload)
    preps = payload.get("preprocessors", {})
    if modality in preps and preps[modality].get("type") == "text":
        return RegexTokenizer.from_json(preps[modality])
    # fall back to any text preprocessor in the artifact
    for state in preps.values():
        if state.get("type") == "text":
            return RegexTokenizer.from_json(state)
    raise ValueError(f"No text tokenizer found in artifact {path}")


def fit_preprocessors(
    sampled_columns: Mapping[str, Sequence[Any]],
    config: Dict[str, Any],
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Fit preprocessors per modality; returns (updated config, preprocessors).

    Args:
        sampled_columns: modality name -> sampled column values.
        config: the data config (modality -> {type, column, target, ...});
            vocab sizes / pad ids / n_features are written back into it.
    """
    preprocessors: Dict[str, Any] = {}

    for modality, modality_config in config.items():
        mtype = modality_config["type"]
        args = modality_config.get("preprocessor_arguments") or {}

        if mtype == "text":
            if "tokenizer_path" in args:
                # Reuse a previously-fitted tokenizer across dataset changes
                # (pretrain -> finetune; reference data_utils.py:63-65 loads
                # via AutoTokenizer.from_pretrained). Accepts either a bare
                # RegexTokenizer JSON or a full preprocessor.json artifact
                # (the tokenizer is looked up by modality name).
                logger.info(
                    "Loading tokenizer for modality %s from %s",
                    modality, args["tokenizer_path"],
                )
                tokenizer = load_tokenizer(args["tokenizer_path"], modality)
            elif "tokenizer_regex" not in args:
                raise ValueError(
                    "One of tokenizer_path or tokenizer_regex has to be defined "
                    "for datatype text."
                )
            else:
                behaviour = args.get("tokenizer_behaviour", "isolated")
                logger.info(
                    "Building tokenizer from scratch for modality: %s", modality
                )
                tokenizer = build_regex_tokenizer(
                    [s for s in sampled_columns[modality] if s is not None],
                    args["tokenizer_regex"],
                    tokenizer_behaviour=behaviour,
                )
            logger.info("Modality %s has vocab size: %d", modality, tokenizer.vocab_size)
            preprocessors[modality] = tokenizer
            modality_config["vocab_size"] = tokenizer.vocab_size
            modality_config["pad_token_id"] = tokenizer.pad_token_id

        elif mtype in PREPROCESSORS:
            logger.info("Building %s preprocessor", mtype)
            known_args = {k: v for k, v in args.items() if k != "tokenizer"}
            preprocessor = PREPROCESSORS[mtype](**known_args)
            if mtype == "text_spectrum":
                # spectra/formula columns may sit in preprocessor_arguments or
                # at the top level of the modality config (reference reads the
                # latter in the collator, datamodules.py:280-285).
                spectra_col = (
                    args.get("spectra_column")
                    or modality_config.get("spectra_column")
                    or modality
                )
                formula_col = args.get("formula_column") or modality_config.get(
                    "formula_column"
                )
                spectra = sampled_columns[spectra_col]
                formulae = (
                    None
                    if preprocessor.spectra_only
                    else sampled_columns.get(formula_col or "")
                )
                preprocessor.fit(spectra, formulae)
            else:
                preprocessor.fit(sampled_columns[modality])
            preprocessors[modality] = preprocessor

            if getattr(preprocessor, "tokenizer", None) is not None:
                modality_config["vocab_size"] = preprocessor.tokenizer.vocab_size
                modality_config["pad_token_id"] = preprocessor.tokenizer.pad_token_id
            elif hasattr(preprocessor, "n_features"):
                modality_config["n_features"] = preprocessor.n_features

        elif mtype == "no_action":
            logger.info("No action for modality %s.", modality)
            sample = sampled_columns[modality][0]
            try:
                modality_config["n_features"] = len(sample)
            except TypeError:
                modality_config["n_features"] = 1

        else:
            raise ValueError(f"Modality with type {mtype} is not implemented.")

    return config, preprocessors


# ---------------------------------------------------------------------------
# Artifact IO
# ---------------------------------------------------------------------------

def save_preprocessors(
    path: Path, data_config: Dict[str, Any], preprocessors: Dict[str, Any]
) -> None:
    payload = {
        "version": ARTIFACT_VERSION,
        "data_config": data_config,
        "preprocessors": {},
    }
    for modality, prep in preprocessors.items():
        if isinstance(prep, RegexTokenizer):
            payload["preprocessors"][modality] = {"type": "text", **prep.to_json()}
        else:
            payload["preprocessors"][modality] = prep.state_dict()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        json.dump(payload, f)


def save_collator_lengths(
    path: Path, max_source_length: Dict[str, int], max_target_length: int
) -> None:
    """Embed the fitted static batch shapes into an existing artifact.

    The collator's max lengths are computed from TRAIN data at fit time;
    persisting them makes the artifact self-sufficient for serving (the
    server reconstructs the exact jit shapes with no dataset on hand)."""
    path = Path(path)
    with path.open() as f:
        payload = json.load(f)
    payload["collator_lengths"] = {
        "max_source_length": dict(max_source_length),
        "max_target_length": max_target_length,
    }
    with path.open("w") as f:
        json.dump(payload, f)


def load_collator_lengths(path: Path):
    """Returns {"max_source_length": {...}, "max_target_length": int} or
    None for artifacts written before serving support."""
    with Path(path).open() as f:
        payload = json.load(f)
    return payload.get("collator_lengths")


def load_preprocessors_artifact(path: Path) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    with Path(path).open() as f:
        payload = json.load(f)
    preprocessors: Dict[str, Any] = {}
    for modality, state in payload["preprocessors"].items():
        if state["type"] == "text":
            preprocessors[modality] = RegexTokenizer.from_json(state)
        else:
            preprocessors[modality] = PREPROCESSORS[state["type"]].from_state(state)
    return payload["data_config"], preprocessors
