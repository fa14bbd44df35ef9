"""Batch assembly: modality columns -> fixed-shape numpy arrays.

Re-designs the reference's ``MultiModalDataCollator``
(reference data/datamodules.py:17-385) for TPU execution:

  * all arrays are **batch-first** and padded to **fit-time static lengths**
    (the reference pads some modalities per-batch and transposes to
    seq-first; masking makes the fixed-shape version numerically identical);
  * masks are keep-masks (1 = attend) — one convention everywhere;
  * the final partial batch can be padded to the full batch size with
    fully-masked dummy rows (``n_valid`` records the real count) so jit
    compiles exactly one batch shape.

Batch dict layout:
  encoder_inputs: {modality: array | {"tokenized_input":, "numerical_values":,
                   "token_indices":}}
  encoder_mask:   (B, L_total) keep-mask over the concatenated source
  decoder_ids:    (B, Lt) teacher-forced input (target shifted right)
  decoder_mask:   (B, Lt) keep-mask
  labels:         (B, Lt) target ids with pad -> -100
  target_strings: list[str] raw targets for scoring
  align_target:   optional (B, 1800)
  extra:          passthrough columns
  n_valid:        number of real rows
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from .preprocessing import PREPROCESSORS  # noqa: F401  (registry parity)

logger = logging.getLogger(__name__)

TOKENIZED_TYPES = ("multiplets", "carbon", "msms_text", "msms_number")


def _run_length_rows(prep, rows: Sequence[Any]) -> Dict[str, np.ndarray]:
    """The run-length preprocessor's ids and mask, every row at its fixed
    length (``max_sequence_length``, at most 4090). A None row (a record
    without this modality, as the serve engine's warm batch sends one) is a
    fully masked row of pad ids, the fully masked segment every other
    modality gives a missing value; the preprocessor itself cannot encode
    it (the JAX package's collator raises there)."""
    rows = list(rows)
    present = [i for i, row in enumerate(rows) if row is not None]
    if len(present) == len(rows):
        return prep(rows)
    width = prep.max_sequence_length
    out = {"input_ids": np.full((len(rows), width), prep.tokenizer.pad_token_id, np.int32),
           "attention_mask": np.zeros((len(rows), width), np.int32)}
    if present:
        encoded = prep([rows[i] for i in present])
        for key, value in out.items():
            value[present] = encoded[key]
    return out


class MultiModalCollator:
    def __init__(
        self,
        preprocessors: Dict[str, Any],
        data_config: Dict[str, Any],
        max_source_length: Optional[Dict[str, int]] = None,
        max_target_length: Optional[int] = None,
        extra_columns: Optional[List[str]] = None,
        pad_to_batch_size: Optional[int] = None,
    ):
        self.preprocessors = preprocessors
        self.data_config = data_config
        self.extra_columns = [c for c in (extra_columns or []) if c]
        self.pad_to_batch_size = pad_to_batch_size

        self.input_modalities = [
            m for m, c in data_config.items() if not c["target"]
        ]
        targets = [
            m for m, c in data_config.items()
            if c["target"] and not c.get("alignment")
        ]
        alignment = [
            m for m, c in data_config.items()
            if c["target"] and c.get("alignment")
        ]
        if len(targets) != 1:
            raise ValueError("Only 1 target modality can be specified.")
        if len(alignment) > 1:
            raise ValueError("At most 1 target alignment modality can be specified.")
        self.target_modality = targets[0]
        self.alignment_modality = alignment[0] if alignment else None

        self.max_source_length = max_source_length or {}
        self.max_target_length = max_target_length

    # ---------------------------------------------------------------- fit
    def fit_lengths(self, sampled_columns: Mapping[str, Sequence[Any]]) -> None:
        """Compute fixed max source/target lengths from a data sample
        (reference datamodules.py:79-138: observed max + 5 margin)."""
        for modality in self.input_modalities:
            mtype = self.data_config[modality]["type"]
            if modality in self.max_source_length:
                continue
            if mtype == "text":
                lengths = self.preprocessors[modality].encode_lengths(
                    [s for s in sampled_columns[modality] if s is not None]
                )
                self.max_source_length[modality] = max(lengths) + 5
            elif mtype == "1D_patches":
                sample = [sampled_columns[modality][0]]
                processed, _ = self.preprocessors[modality](sample)
                self.max_source_length[modality] = processed.shape[1]
            # Other modality types carry their own fit-time max lengths.

        if (
            self.max_target_length is None
            and self.data_config[self.target_modality]["type"] == "text"
        ):
            lengths = self.preprocessors[self.target_modality].encode_lengths(
                [s for s in sampled_columns[self.target_modality] if s is not None]
            )
            self.max_target_length = max(lengths) + 5

    # ------------------------------------------------------------ __call__
    def __call__(self, columns: Mapping[str, Sequence[Any]]) -> Dict[str, Any]:
        first_key = next(iter(columns))
        batch_size = len(columns[first_key])

        encoder_inputs: Dict[str, Any] = {}
        mask_parts: List[np.ndarray] = []
        for modality in self.input_modalities:
            mtype = self.data_config[modality]["type"]
            # no_action has no fitted preprocessor (raw passthrough).
            prep = self.preprocessors.get(modality)

            if mtype == "text":
                out = prep(
                    list(columns[modality]), padding="max_length",
                    max_length=self.max_source_length[modality], truncation=True,
                )
                encoder_inputs[modality] = out["input_ids"]
                mask_parts.append(out["attention_mask"])

            elif mtype in TOKENIZED_TYPES:
                out = prep(list(columns[modality]))
                if "numerical_values" in out:
                    encoder_inputs[modality] = {
                        "tokenized_input": out["input_ids"],
                        "numerical_values": out["numerical_values"],
                    }
                else:
                    encoder_inputs[modality] = out["input_ids"]
                mask_parts.append(out["attention_mask"])

            elif mtype == "text_spectrum":
                cfg = self.data_config[modality]
                args = cfg.get("preprocessor_arguments") or {}
                spectra_col = (
                    args.get("spectra_column") or cfg.get("spectra_column") or modality
                )
                formula_col = args.get("formula_column") or cfg.get("formula_column")
                spectra = columns[spectra_col]
                formulae = (
                    None if prep.spectra_only else columns[formula_col]
                )
                out = prep(spectra, formulae)
                if "numerical_values" in out:
                    encoder_inputs[modality] = {
                        "tokenized_input": out["input_ids"],
                        "numerical_values": out["numerical_values"],
                    }
                else:
                    encoder_inputs[modality] = out["input_ids"]
                mask_parts.append(out["attention_mask"])

            elif mtype == "peak_positional_encoding":
                out = prep(columns[modality])
                payload = {
                    "tokenized_input": out["input_ids"],
                    "token_indices": out["indices"],
                }
                if "numerical_values" in out:
                    payload["numerical_values"] = out["numerical_values"]
                encoder_inputs[modality] = payload
                mask_parts.append(out["attention_mask"])

            elif mtype == "run_length_encoding":
                out = _run_length_rows(prep, columns[modality])
                encoder_inputs[modality] = out["input_ids"]
                mask_parts.append(out["attention_mask"])

            elif mtype == "1D_patches":
                patches, keep_mask = prep(list(columns[modality]))
                encoder_inputs[modality] = patches
                mask_parts.append(keep_mask)

            elif mtype == "no_action":
                # Raw passthrough features: (B, F) rows become one sequence
                # position of F features each ((B, L, F) kept as-is), fully
                # attended. The embedding projects them linearly.
                arr = np.asarray(
                    [np.asarray(row, dtype=np.float32) for row in columns[modality]]
                )
                if arr.ndim == 1:
                    arr = arr[:, None]
                if arr.ndim == 2:
                    arr = arr[:, None, :]
                encoder_inputs[modality] = arr
                mask_parts.append(np.ones(arr.shape[:2], np.int32))

            else:
                raise ValueError(f"Unknown modality type {mtype}")

        encoder_mask = np.concatenate(mask_parts, axis=1).astype(np.int32)

        # ---- target -----------------------------------------------------
        target_type = self.data_config[self.target_modality]["type"]
        target_strings: List[str]
        if target_type == "text":
            tokenized = self.preprocessors[self.target_modality](
                list(columns[self.target_modality]),
                padding="max_length", max_length=self.max_target_length,
                truncation=True,
            )
            target_strings = list(columns[self.target_modality])
        elif target_type in ("carbon", "multiplets"):
            prep = self.preprocessors[self.target_modality]
            tokenized = prep(list(columns[self.target_modality]))
            if target_type == "carbon":
                target_strings = prep.process_carbon(list(columns[self.target_modality]))
            else:
                target_strings = prep.process_multiplets(
                    list(columns[self.target_modality])
                )[0]
        else:
            # Vector targets (functional_group / class_one_hot / normalise /
            # no_action): encoder-style regression targets.
            prep = self.preprocessors.get(self.target_modality)
            values = columns[self.target_modality]
            vec = prep(values) if prep is not None else np.asarray(values, np.float32)
            batch = {
                "encoder_inputs": encoder_inputs,
                "encoder_mask": encoder_mask,
                "vector_target": np.asarray(vec, dtype=np.float32),
                "n_valid": batch_size,
            }
            return self._pad_batch(batch, batch_size)

        ids = tokenized["input_ids"]
        keep = tokenized["attention_mask"]
        decoder_ids = ids[:, :-1]
        decoder_mask = keep[:, :-1].astype(np.int32)
        labels = ids[:, 1:].astype(np.int32).copy()
        labels[keep[:, 1:] == 0] = -100

        batch: Dict[str, Any] = {
            "encoder_inputs": encoder_inputs,
            "encoder_mask": encoder_mask,
            "decoder_ids": decoder_ids.astype(np.int32),
            "decoder_mask": decoder_mask,
            "labels": labels,
            "target_strings": target_strings,
            "n_valid": batch_size,
        }

        # ---- alignment target ------------------------------------------
        if self.alignment_modality is not None:
            if self.alignment_modality in columns:
                align = np.asarray(
                    [np.asarray(row, dtype=np.float32) for row in columns[self.alignment_modality]]
                )
            else:
                align = np.zeros((batch_size, 1800), dtype=np.float32)
            if align.shape[1] < 1800:
                align = np.pad(align, ((0, 0), (0, 1800 - align.shape[1])))
            prep = self.preprocessors.get(self.alignment_modality)
            if (
                prep is not None
                and self.data_config[self.alignment_modality]["type"] == "1D_patches"
                and getattr(prep, "interpolation", False)
            ):
                align = prep.interpolate(align).astype(np.float32)
            batch["align_target"] = align.astype(np.float32)

        for col in self.extra_columns:
            if col in columns and col not in batch:
                batch[col] = list(columns[col])

        return self._pad_batch(batch, batch_size)

    # ---------------------------------------------------------- batch pad
    def _pad_batch(self, batch: Dict[str, Any], batch_size: int) -> Dict[str, Any]:
        target = self.pad_to_batch_size
        if not target or batch_size >= target:
            return batch
        pad = target - batch_size

        def pad_array(arr: np.ndarray, fill=0) -> np.ndarray:
            widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
            return np.pad(arr, widths, constant_values=fill)

        def pad_tree(node):
            if isinstance(node, dict):
                return {k: pad_tree(v) for k, v in node.items()}
            if isinstance(node, np.ndarray):
                return pad_array(node)
            return node

        batch["encoder_inputs"] = pad_tree(batch["encoder_inputs"])
        batch["encoder_mask"] = pad_array(batch["encoder_mask"])
        if "decoder_ids" in batch:
            batch["decoder_ids"] = pad_array(batch["decoder_ids"])
            batch["decoder_mask"] = pad_array(batch["decoder_mask"])
            batch["labels"] = pad_array(batch["labels"], fill=-100)
        if "align_target" in batch:
            batch["align_target"] = pad_array(batch["align_target"])
        if "vector_target" in batch:
            batch["vector_target"] = pad_array(batch["vector_target"])
        return batch
