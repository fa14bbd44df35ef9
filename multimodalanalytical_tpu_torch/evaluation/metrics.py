"""Sampling metrics: Top-N exact-match accuracy over canonical SMILES.

Re-implements the reference's scoring semantics
(reference: src/analytical_fm/utils.py:22-153) on top of the first-party chem
engine instead of RDKit, without the pandas dependency in the hot path.
"""

from __future__ import annotations

import logging
from functools import lru_cache
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..chem import canonicalize, mol_formula

logger = logging.getLogger(__name__)

_SPECIAL_TOKENS = ("<bos>", "<pad>", "<eos>")


def clean_sample(sample: str, canonicalise: bool) -> Optional[str]:
    """Strip special tokens/whitespace from a decoded sample; optionally canonicalise.

    Matches reference utils.py:22-41: returns ``None`` when canonicalisation is
    requested and the string is not a valid molecule.
    """
    for token in _SPECIAL_TOKENS:
        sample = sample.replace(token, "")
    sample = sample.replace(" ", "")

    if canonicalise:
        return canonicalize(sample)
    return sample


@lru_cache(maxsize=200_000)
def _cached_canonical(smiles: str) -> Optional[str]:
    return canonicalize(smiles)


def _strip(sample: str) -> str:
    for token in _SPECIAL_TOKENS:
        sample = sample.replace(token, "")
    return sample.replace(" ", "")


def _clean(sample: str, canonicalise: bool) -> Optional[str]:
    sample = _strip(sample)
    if canonicalise:
        return _cached_canonical(sample)
    return sample


def _warm_canonical_cache(raw: Sequence[str], min_unique: int = 2000) -> None:
    """Canonicalize the unique strings of a large scoring batch in parallel.

    The engine call is ctypes (releases the GIL) and dominates the cost
    (~50-230 us/string), so a thread pool scales near-linearly; the scoring
    loop then hits ``_cached_canonical`` warm. An 800k-beam mixture predict
    drops from ~10 core-minutes of serial canonicalization to seconds.
    Small batches (validation loops) skip the pool overhead."""
    import os

    # Measured on a 1-core box: threads only add overhead (0.29s -> 0.41s
    # on 5k strings); the pool pays off only with real parallelism.
    workers = min(32, os.cpu_count() or 1)
    if workers < 2:
        return
    # Dedup PRESERVING scoring order, and warm at most what the LRU can
    # hold: beyond the cap, arbitrary-order warming would evict the very
    # entries the scoring loop reads first.
    cap = _cached_canonical.cache_info().maxsize - 1024
    unique = list(dict.fromkeys(_strip(s) for s in raw))[:cap]
    if len(unique) < min_unique:
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as pool:
        # list() drains the iterator so every future completes here.
        list(pool.map(_cached_canonical, unique, chunksize=256))


def calc_sampling_metrics(
    samples: Sequence[Sequence[str]],
    targets: Sequence[str],
    classes: Optional[Sequence[Any]] = None,
    molecules: bool = True,
    logging: bool = False,
) -> Dict[str, Any]:
    """Top-1..Top-N exact-match rank metrics (reference utils.py:86-153).

    Args:
        samples: per-target list of N beam samples (raw decoded strings).
        targets: target strings.
        classes: optional per-target class labels for a per-class breakdown.
        molecules: canonicalise predictions/targets before comparing.
        logging: emit metric lines to the logger.
    """
    if len(samples) == 0:
        return {}
    n_beams = len(samples[0])

    if molecules:
        flat: List[str] = list(targets)
        for beams in samples:
            flat.extend(beams)
        _warm_canonical_cache(flat)
    cleaned_targets = [_clean(t, molecules) for t in targets]
    ranks = np.full(len(targets), n_beams, dtype=np.int64)
    for i, beams in enumerate(samples):
        target = cleaned_targets[i]
        for j, beam in enumerate(beams):
            if _clean(beam, molecules) == target:
                ranks[i] = j
                break

    metrics: Dict[str, Any] = {}
    if classes is not None and len(classes) > 0:
        classes_arr = np.asarray(classes)
        for cl in np.unique(classes_arr):
            mask = classes_arr == cl
            cls_ranks = ranks[mask]
            cl_key = float(cl)
            metrics[cl_key] = {}
            for i in range(n_beams):
                top_n = float((cls_ranks <= i).sum() / len(cls_ranks))
                metrics[cl_key][f"Top-{i + 1}"] = top_n
                if logging:
                    logger.info(
                        "Class: %s. Samples per class: %d. Top-%d: %.3f",
                        cl, int(mask.sum()), i + 1, top_n,
                    )
    else:
        for i in range(n_beams):
            top_n = float((ranks <= i).sum() / len(ranks))
            metrics[f"Top-{i + 1}"] = top_n
            if logging:
                logger.info("Top-%d: %.3f", i + 1, top_n)

    return metrics


def reject_sample(predictions: Dict[str, Any], molecules: bool = True) -> Dict[str, Any]:
    """Rejection sampling: drop beams whose formula differs from the target's.

    Matches reference utils.py:44-83 — each prediction list is filtered to
    formula-matching beams and padded back to ``n_beams`` with empty strings.
    """
    n_beams = len(predictions["predictions"][0])
    logger.info("Doing rejection sampling with n_beams: %d", n_beams)

    for i in range(len(predictions["predictions"])):
        target_formula = mol_formula(predictions["targets"][i])
        kept: List[str] = []
        for beam in predictions["predictions"][i]:
            sample = clean_sample(beam, molecules)
            if sample is None:
                continue
            pred_formula = mol_formula(sample)
            if pred_formula is not None and target_formula is not None and (
                pred_formula == target_formula
            ):
                kept.append(sample)
        predictions["predictions"][i] = kept + [""] * (n_beams - len(kept))

    if len(predictions["predictions"]) != len(predictions["targets"]):
        raise ValueError(
            f"Predictions and targets do not match in size: "
            f"{len(predictions['predictions'])} != {len(predictions['targets'])}"
        )
    return predictions


def token_accuracy(
    target_ids: np.ndarray, predicted_ids: np.ndarray, ignore_id: int = -100
) -> float:
    """Fraction of non-ignored target tokens predicted exactly
    (reference wrapper.py:641-655)."""
    target_ids = np.asarray(target_ids)
    predicted_ids = np.asarray(predicted_ids)
    mask = target_ids != ignore_id
    correct = (target_ids == predicted_ids) & mask
    total = mask.sum()
    return float(correct.sum() / total) if total else 0.0
