"""Offline train-set augmentations.

Reference behavior: src/analytical_fm/data/augmentations.py:12-108 —
horizontal shift (subsample + reinterpolate), gaussian smoothing per sigma,
randomized SMILES, plus concatenation of an extra augment dataset from disk.
Randomized SMILES uses the in-repo chem engine instead of RDKit.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def interpolate(spec: np.ndarray, x: np.ndarray, upscale_val: int) -> np.ndarray:
    new_x = np.arange(0, upscale_val, 1)
    return np.interp(new_x, x, spec)


def horizontal_shift_augment(spectrum, n_augments: int = 2) -> List[List[float]]:
    """Subsample with phase offsets and re-interpolate to the original grid
    (reference augmentations.py:19-29). The reference's slicing only yields
    ``len//n`` points for every phase when the length is odd (the 1791-point
    IR grids); here the support grid is sized per slice so even lengths work
    too."""
    spectrum = np.asarray(spectrum, dtype=np.float64)
    out = []
    for i in range(n_augments):
        shifted = spectrum[i : (-n_augments + i) : n_augments]
        old_x = np.linspace(0, len(spectrum), len(shifted))
        out.append(interpolate(shifted, old_x, len(spectrum)).tolist())
    return out


def smooth_augment(spectrum, sigmas: List[float]) -> List[List[float]]:
    """scipy's gaussian_filter1d — the reference's exact call
    (augmentations.py:33-40); a hand-rolled convolution differed at the
    boundaries (scipy's default 'reflect' mode is symmetric-reflect,
    np.pad's 'reflect' is not). Parity pinned against the reference's
    executed code in tests/test_reference_preproc_parity.py."""
    from scipy.ndimage import gaussian_filter1d

    spectrum = np.asarray(spectrum, dtype=np.float64)
    return [gaussian_filter1d(spectrum, sigma).tolist() for sigma in sigmas]


def smiles_augment(smiles: str, n_augments: int) -> List[str]:
    from ..chem import random_smiles

    # Seed from the molecule so augmentation is deterministic per sample.
    seed = abs(hash(smiles)) % (2**31)
    return random_smiles(smiles, n_augments, seed=seed)


AUGMENT_OPTIONS = {
    "horizontal": horizontal_shift_augment,
    "smooth": smooth_augment,
    "smiles_aug": smiles_augment,
}


def augment(dataset, augment_config: Optional[Dict[str, Any]], num_cpu: int = 1):
    """Append augmented copies of the train set (reference augmentations.py:57-87)."""
    del num_cpu  # vectorized numpy path; no process pool needed
    if not isinstance(augment_config, dict):
        return dataset

    from .datasets import TableDataset

    augmented_sets: List[TableDataset] = []
    augmentations = augment_config.get("augmentations") or []
    for fields in augmentations:
        augment_column = fields["augment_column"]
        augment_fns = fields["augment_fns"]

        new_columns: Dict[str, List[Any]] = {k: [] for k in dataset.column_names}
        for row_idx in range(len(dataset)):
            value = dataset[augment_column][row_idx]
            augmented_values: List[Any] = []
            for fn_name, params in augment_fns.items():
                augmented_values.extend(AUGMENT_OPTIONS[fn_name](value, **params))
            for column in dataset.column_names:
                if column == augment_column:
                    new_columns[column].extend(augmented_values)
                else:
                    new_columns[column].extend(
                        [dataset[column][row_idx]] * len(augmented_values)
                    )
        augmented_sets.append(TableDataset(new_columns))

    out = dataset
    for aug in augmented_sets:
        out = out.concat(aug)

    augment_data_path = augment_config.get("augment_data_path")
    if augment_data_path and augment_data_path != "<to be filled>":
        out = out.concat(_load_augment_dataset(augment_data_path))

    return out


def _load_augment_dataset(path: str):
    """Extra augmentation data from disk: a parquet directory, or an HF
    ``save_to_disk`` Arrow directory (the reference's format,
    augmentations.py:84)."""
    from pathlib import Path

    from .datasets import TableDataset, load_parquet_dir

    p = Path(path)
    if any(p.glob("*.parquet")):
        extra_splits = load_parquet_dir(path)
        out = None
        for extra in extra_splits.values():
            out = extra if out is None else out.concat(extra)
        return out
    # HF Arrow directory
    import datasets as hf_datasets

    ds = hf_datasets.load_from_disk(path)
    return TableDataset({name: ds[name] for name in ds.column_names})
