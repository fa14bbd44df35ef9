"""Dataset loading, split policies and streaming mixture synthesis.

Re-implements reference src/analytical_fm/data/datasets.py:31-416 on plain
pyarrow + numpy (no HF ``datasets`` dependency): a dataset is a column dict.

Split policies (reference datasets.py:144-291, 327-375):
  * ``random``        — 5-fold KFold + capped 10% validation split
  * ``func_group_split`` — stratified by sorted functional-group-name string
  * ``unique_target`` — KFold over unique target values
  * ``test_only``     — everything into test (inference mode)
  * ``given_splits``  — pre-split train/validation/test parquet files

Mixture synthesis (reference datasets.py:31-141): on-the-fly IR mixtures of
``n_compounds`` spectra with configurable ratios, yielding one sample per
component with the pure spectrum as alignment target.
"""

from __future__ import annotations

import logging
import math
from itertools import zip_longest
from pathlib import Path
from typing import Any, Callable, Dict, Generator, Iterator, List, Optional, Sequence

import numpy as np

from ..configuration import DEFAULT_SETTINGS
from .augmentations import augment

logger = logging.getLogger(__name__)


class TableDataset:
    """Column-oriented in-memory dataset."""

    def __init__(self, columns: Dict[str, List[Any]]):
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"Ragged columns: { {k: len(v) for k, v in columns.items()} }")
        self.columns = columns
        self._length = lengths.pop() if lengths else 0

    def __len__(self) -> int:
        return self._length

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def __getitem__(self, column: str) -> List[Any]:
        return self.columns[column]

    def select(self, indices: Sequence[int]) -> "TableDataset":
        idx = np.asarray(indices)
        return TableDataset({k: [v[i] for i in idx] for k, v in self.columns.items()})

    def select_columns(self, names: Sequence[str]) -> "TableDataset":
        return TableDataset({k: self.columns[k] for k in names if k in self.columns})

    def rename_columns(self, mapping: Dict[str, str]) -> "TableDataset":
        return TableDataset({mapping.get(k, k): v for k, v in self.columns.items()})

    def concat(self, other: "TableDataset") -> "TableDataset":
        keys = [k for k in self.columns if k in other.columns]
        return TableDataset({k: list(self.columns[k]) + list(other.columns[k]) for k in keys})

    def rows(self, indices: Optional[Sequence[int]] = None) -> Iterator[Dict[str, Any]]:
        rng = range(self._length) if indices is None else indices
        for i in rng:
            yield {k: v[i] for k, v in self.columns.items()}

    def slice_columns(self, indices: Sequence[int]) -> Dict[str, List[Any]]:
        return {k: [v[i] for i in indices] for k, v in self.columns.items()}


class IterableDatasetWithLength:
    """Generator-backed dataset with a declared length
    (reference data_utils.py:18-37)."""

    def __init__(
        self,
        generator_fn: Callable[..., Generator[Dict[str, Any], None, None]],
        length: int,
        generator_args: Optional[Dict[str, Any]] = None,
        split: str = "train",
    ):
        self.generator_fn = generator_fn
        self.generator_args = generator_args or {}
        self._length = length
        self.split = split

    def __len__(self) -> int:
        return self._length

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        count = 0
        for sample in self.generator_fn(**self.generator_args):
            if count >= self._length:
                break
            yield sample
            count += 1

    def take(self, n: int) -> TableDataset:
        columns: Dict[str, List[Any]] = {}
        for i, sample in enumerate(self):
            if i >= n:
                break
            for k, v in sample.items():
                columns.setdefault(k, []).append(v)
        return TableDataset(columns)


def load_parquet_dir(
    data_path: str, columns: Optional[Sequence[str]] = None
) -> Dict[str, TableDataset]:
    """Load all parquet files in a directory.

    Files whose names start with train/valid/test map to those splits
    (given_splits support); everything else lands in split "data".
    """
    import pyarrow.parquet as pq

    path = Path(data_path)
    if not path.is_dir():
        raise ValueError(
            "Data path must specify path to directory containing the dataset "
            "files as parquet."
        )
    split_tables: Dict[str, List[Any]] = {}
    for file in sorted(path.glob("*.parquet")):
        name = file.stem.lower()
        if name.startswith("train"):
            split = "train"
        elif name.startswith("valid"):
            split = "validation"
        elif name.startswith("test"):
            split = "test"
        else:
            split = "data"
        table = pq.read_table(file, columns=list(columns) if columns else None)
        split_tables.setdefault(split, []).append(table)

    out: Dict[str, TableDataset] = {}
    for split, tables in split_tables.items():
        import pyarrow as pa

        table = pa.concat_tables(tables)
        columns_out: Dict[str, List[Any]] = {}
        for name in table.column_names:
            column = table.column(name)
            # Numeric list columns (spectra) decode to per-row float32
            # ndarrays ONCE here — to_pylist() hands the hot path Python
            # lists of 1800 floats that every batch re-parses (~1 ms/row,
            # measured as the mixture pipeline's bottleneck).
            value_type = getattr(column.type, "value_type", None)
            if value_type is not None and pa.types.is_floating(value_type):
                columns_out[name] = [
                    None if row is None
                    else np.asarray(row, dtype=np.float32)
                    for row in column.to_pylist()
                ]
            else:
                columns_out[name] = column.to_pylist()
        out[split] = TableDataset(columns_out)
    if not out:
        raise ValueError(f"No parquet files found under {data_path}")
    return out


# ---------------------------------------------------------------------------
# Split policies
# ---------------------------------------------------------------------------

def _kfold_indices(n: int, n_splits: int, seed: int) -> List[np.ndarray]:
    """Test-fold indices of ``sklearn.KFold(shuffle=True, random_state)``.

    Uses sklearn itself (same library + call as the reference,
    datasets.py:157) so fold membership matches the published CV folds
    bit-for-bit; verified against the reference's executed ``split`` in
    tests/test_reference_split_parity.py."""
    from sklearn.model_selection import KFold

    folds = KFold(n_splits=n_splits, shuffle=True, random_state=seed)
    return [test for _, test in folds.split(X=np.arange(n))]


def _train_test_split(
    indices: np.ndarray, test_size: int, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """HF ``Dataset.train_test_split(shuffle=True, seed=...)`` exactly:
    ``np.random.default_rng(seed).permutation(n)`` over POSITIONS, test
    slice first, both subsets kept in permuted order — so fold membership
    AND row order match the reference bit-for-bit (verified against the
    reference's executed ``split`` in tests/test_reference_split_parity.py).
    """
    indices = np.asarray(indices)
    perm = np.random.default_rng(seed).permutation(len(indices))
    return indices[perm[test_size:]], indices[perm[:test_size]]


def split(dataset: TableDataset, cv_split: int = 0, seed: int = 3245) -> Dict[str, TableDataset]:
    """Random 5-fold split + capped validation (reference datasets.py:144-173)."""
    folds = _kfold_indices(len(dataset), 5, seed)
    test_indices = folds[cv_split]
    train_indices = np.setdiff1d(np.arange(len(dataset)), test_indices)

    val_size = min(int(0.1 * len(train_indices)), DEFAULT_SETTINGS.default_val_set_size)
    train_indices, val_indices = _train_test_split(train_indices, val_size, seed)

    return {
        "train": dataset.select(train_indices),
        "test": dataset.select(test_indices),
        "validation": dataset.select(val_indices),
    }


def func_split(
    dataset: TableDataset, cv_split: int = 0, seed: int = 3453
) -> Dict[str, TableDataset]:
    """Stratify by sorted functional-group-name strings; singleton groups go
    to train (reference datasets.py:176-234)."""
    from sklearn.model_selection import StratifiedKFold
    from sklearn.model_selection import train_test_split as sk_tts

    names = [".".join(sorted(x)) for x in dataset["functional_group_names"]]
    counts: Dict[str, int] = {}
    for name in names:
        counts[name] = counts.get(name, 0) + 1

    singles = np.asarray([i for i, n in enumerate(names) if counts[n] == 1],
                         dtype=int)
    multis = np.asarray([i for i, n in enumerate(names) if counts[n] > 1],
                        dtype=int)
    multi_labels = np.asarray([names[i] for i in multis])

    # Same sklearn calls as the reference (datasets.py:205-228) so fold
    # membership matches its published CV folds exactly: stratified 90/10
    # holdout (cv_split=-1, fixed seed 3453) or 10-fold StratifiedKFold;
    # then an sklearn val split of the train subset, in subset order.
    if cv_split == -1:
        train_pos, test_pos = sk_tts(
            np.arange(len(multis)), stratify=multi_labels, test_size=0.1,
            random_state=3453, shuffle=True,
        )
    else:
        skf = StratifiedKFold(n_splits=10, shuffle=True, random_state=seed)
        splits = list(skf.split(X=multis, y=multi_labels))
        train_pos, test_pos = splits[cv_split]

    val_size = min(int(0.05 * len(train_pos)), DEFAULT_SETTINGS.default_val_set_size)
    if val_size >= 1:
        train_pos, val_pos = sk_tts(
            train_pos, test_size=val_size, random_state=seed, shuffle=True,
        )
    else:  # tiny datasets (tests): sklearn rejects test_size=0
        val_pos = np.asarray([], dtype=int)
    train_idx = np.concatenate([multis[train_pos], singles])
    return {
        "train": dataset.select(train_idx),
        "test": dataset.select(multis[test_pos]),
        "validation": dataset.select(multis[val_pos]),
    }


def target_split(
    dataset: TableDataset, target_column: str, cv_split: int = 0, seed: int = 3453
) -> Dict[str, TableDataset]:
    """KFold over *unique* target values so no target leaks across splits
    (reference datasets.py:255-291)."""
    all_targets = dataset[target_column]
    unique_targets = np.unique(np.asarray(all_targets, dtype=object))

    folds = _kfold_indices(len(unique_targets), 5, seed)
    test_positions = folds[cv_split]
    train_positions = np.setdiff1d(np.arange(len(unique_targets)), test_positions)

    # Reference uses SKLEARN's train_test_split here (datasets.py:279-284)
    # — a different RNG convention than HF's (used by ``split``); call the
    # same function for bit-identical target membership.
    from sklearn.model_selection import train_test_split as sk_tts

    val_size = min(
        int(0.05 * len(train_positions)), DEFAULT_SETTINGS.default_val_set_size
    )
    if val_size >= 1:
        train_vals, val_vals = sk_tts(
            unique_targets[train_positions], test_size=val_size,
            random_state=seed, shuffle=True,
        )
    else:  # tiny datasets (tests): sklearn rejects test_size=0
        train_vals, val_vals = unique_targets[train_positions], np.asarray([])
    train_targets = set(train_vals.tolist())
    val_targets = set(val_vals.tolist())
    test_targets = set(unique_targets[test_positions].tolist())

    def select_by(targets: set) -> TableDataset:
        idx = [i for i, t in enumerate(all_targets) if t in targets]
        return dataset.select(idx)

    return {
        "train": select_by(train_targets),
        "test": select_by(test_targets),
        "validation": select_by(val_targets),
    }


# ---------------------------------------------------------------------------
# Mixture synthesis
# ---------------------------------------------------------------------------

def normalize_spectrum(spectrum: np.ndarray) -> np.ndarray:
    spectrum = np.asarray(spectrum, dtype=np.float64)
    min_val, max_val = spectrum.min(), spectrum.max()
    clipped = np.maximum(spectrum, 0)
    if max_val - min_val == 0:
        return np.zeros_like(spectrum)
    return (clipped - min_val) / (max_val - min_val)


def normalize_spectrum_block(spectra: np.ndarray) -> np.ndarray:
    """Row-wise ``normalize_spectrum`` over a (P, L) block — float-identical
    per element (min/max are exact, the subtract/divide are elementwise)."""
    spectra = np.asarray(spectra, dtype=np.float64)
    min_val = spectra.min(axis=1, keepdims=True)
    max_val = spectra.max(axis=1, keepdims=True)
    clipped = np.maximum(spectra, 0)
    span = max_val - min_val
    flat = (span == 0.0)[:, 0]
    # Avoid divide-by-zero on flat rows; they are zeroed below, matching
    # the scalar path's early return.
    out = (clipped - min_val) / np.where(span == 0.0, 1.0, span)
    if flat.any():
        out[flat] = 0.0
    return out


def mix_spectra(
    dataset: TableDataset,
    mix_config: Dict[str, Any],
    split: str,
    seed: int = 0,
) -> Generator[Dict[str, Any], None, None]:
    """Yield synthetic mixture samples (reference datasets.py:58-141)."""
    rng = np.random.RandomState(seed or DEFAULT_SETTINGS.default_seed)

    n_compounds = mix_config["n_compounds"]
    compounds_ratio = mix_config.get("compounds_ratio")
    parallel_samples = mix_config["parallel_samples"]
    max_n_samples = mix_config[f"{split}_max_n_samples"]
    normalize = mix_config["normalize"]
    mixed = mix_config.get("mixed", False)

    if max_n_samples // parallel_samples < 1:
        parallel_samples = max_n_samples
    if compounds_ratio is None:
        compounds_ratio = [1 / n_compounds] * n_compounds
    if len(compounds_ratio) != n_compounds or not math.isclose(sum(compounds_ratio), 1):
        raise ValueError(
            f"Invalid compound ratios: expected {n_compounds} compounds with "
            f"ratios summing to 1; got {compounds_ratio}."
        )

    smiles_col = dataset["Smiles"]
    formula_col = dataset["Formula"]
    ir_col = [np.asarray(s, dtype=np.float32) for s in dataset["IR"]]
    n_rows = len(dataset)
    num_expected = math.perm(n_rows, n_compounds)

    if mixed:
        if compounds_ratio != [1 / n_compounds] * n_compounds:
            raise ValueError(
                "Mixed mode is only supported with equal compound ratios."
            )
        mock = [0.0] * len(ir_col[0])
        for i in range(n_rows):
            spectrum = normalize_spectrum(ir_col[i]) if normalize else ir_col[i]
            yield {
                "Smiles": smiles_col[i],
                "Formula": formula_col[i],
                "IR": spectrum.tolist() if isinstance(spectrum, np.ndarray) else spectrum,
                "Additional_smiles": "mock",
                "Percentage": f"{1 / n_compounds}",
                "IR_target": mock,
            }
        return

    ratios = np.asarray(compounds_ratio)
    # Chunk-vectorized synthesis: one gather + one
    # np.average per CHUNK of mixtures instead of per sample. The arithmetic
    # is float-IDENTICAL to the per-sample reference loop — np.average with
    # 1-D weights broadcasts/multiplies/sums the same f32*f64 elementwise
    # ops whether the reduction axis is 0 of (n_comp, L) or 1 of
    # (C, n_comp, L) — pinned by the executed-reference goldens in
    # tests/test_reference_preproc_parity.py::test_mix_spectra_stream_*.
    # Chunk size 128 measured 3x faster than per-sample on this host
    # (14 us/mixture vs 44); FULL 16k blocks are 10x SLOWER — the f64
    # intermediates (0.5 GB) fall out of cache on the single weak core.
    equal_lengths = len({len(s) for s in ir_col}) <= 1
    pool = np.stack(ir_col) if (equal_lengths and n_rows) else None
    nonzero = [i for i in range(n_compounds) if ratios[i] != 0]
    percent_str = [f"{r}" for r in ratios]
    chunk_size = 128
    for n in range(max_n_samples // parallel_samples):
        random_indices = rng.choice(n_rows, size=(parallel_samples, n_compounds))
        random_indices = np.unique(random_indices, axis=0)
        valid = np.asarray([len(set(row)) == len(row) for row in random_indices])
        random_indices = random_indices[valid]

        if n * parallel_samples + parallel_samples >= num_expected:
            break

        for chunk_start in range(0, len(random_indices), chunk_size):
            chunk_idx = random_indices[chunk_start : chunk_start + chunk_size]
            if pool is not None:
                block = pool[chunk_idx]  # (C, n_compounds, L)
                combined_block = np.average(block, weights=ratios, axis=1)
                if normalize:
                    combined_block = normalize_spectrum_block(combined_block)
                if combined_block.shape[1] != 1800:  # pad real data
                    combined_block = np.concatenate(
                        [combined_block,
                         np.zeros((combined_block.shape[0],
                                   1800 - combined_block.shape[1]),
                                  dtype=combined_block.dtype)], axis=1)
                combined_block = combined_block.astype(np.float32)
            else:
                combined_block = None

            for row_j, idx in enumerate(chunk_idx):
                if combined_block is not None:
                    combined = combined_block[row_j]
                else:  # ragged pool: per-sample fallback (reference path)
                    spectra = np.stack([ir_col[s] for s in idx])
                    combined = np.average(spectra, weights=ratios, axis=0)
                    if normalize:
                        combined = normalize_spectrum(combined)
                    if combined.shape[0] != 1800:  # pad real data
                        combined = np.concatenate(
                            [combined, np.zeros(1800 - combined.shape[0],
                                                dtype=combined.dtype)])
                    combined = combined.astype(np.float32)
                yield from _emit_components(
                    idx, combined, nonzero, n_compounds,
                    smiles_col, formula_col, ir_col, percent_str)


def _emit_components(idx, combined, nonzero, n_compounds,
                     smiles_col, formula_col, ir_col, percent_str):
    for i in nonzero:
        # ndarrays, not lists: the collator re-parses Python lists
        # at ~1 ms per 1800-float row (the round-2 mixture pipeline
        # bottleneck — 405 samples/s host-bound vs ~5k on chip).
        yield {
            "Smiles": smiles_col[idx[i]],
            "Formula": formula_col[idx[i]],
            "IR": combined,
            "Additional_smiles": ",".join(
                smiles_col[idx[j]] for j in range(n_compounds) if j != i
            ),
            "Percentage": percent_str[i],
            "IR_target": ir_col[idx[i]],
        }


def multi_config_mix(
    dataset: TableDataset,
    mixture_config: Dict[str, Any],
    split: str,
    seed: int = 0,
) -> Generator[Dict[str, Any], None, None]:
    """Round-robin over per-mode mixture generators
    (reference datasets.py:31-46)."""
    generators = [
        mix_spectra(dataset, mixture_config[mode], split, seed)
        for mode in mixture_config
    ]
    for samples in zip_longest(*generators, fillvalue=None):
        for sample in samples:
            if sample is not None:
                yield sample


# ---------------------------------------------------------------------------
# Top-level dataset construction
# ---------------------------------------------------------------------------

def build_dataset_multimodal(
    data_config: Dict[str, Any],
    data_path: str,
    splitting: str,
    cv_split: int,
    augment_config: Optional[Dict[str, Any]] = None,
    num_cpu: int = 7,
    mixture_config: Optional[Dict[str, Any]] = None,
):
    """Load parquet dir, split, augment, rename columns -> modality names and
    optionally wrap into streaming mixture datasets
    (reference datasets.py:294-416)."""
    relevant_columns = set()
    for modality, cfg in data_config.items():
        column = cfg["column"]
        if isinstance(column, str):
            if column not in ("percentage", "") and not cfg.get("alignment"):
                relevant_columns.add(column)
        elif isinstance(column, list):
            relevant_columns.update(column)
        else:
            raise ValueError(
                f"Expected column to be either list or str for modality: {modality}"
            )
    if splitting == "func_group_split":
        relevant_columns.add("functional_group_names")

    logger.info("Loading dataset from %s", data_path)
    split_tables = load_parquet_dir(data_path, columns=None)
    # Column projection (tolerate missing metadata columns per split file).
    split_tables = {
        k: v.select_columns([c for c in v.column_names if c in relevant_columns])
        for k, v in split_tables.items()
    }
    logger.info("Dataset loaded")

    def combined() -> TableDataset:
        tables = list(split_tables.values())
        out = tables[0]
        for t in tables[1:]:
            out = out.concat(t)
        return out

    if splitting == "test_only":
        whole = combined()
        dataset_dict = {"test": whole, "train": whole, "validation": whole}
    elif splitting == "func_group_split":
        dataset_dict = func_split(
            combined(), cv_split=cv_split, seed=DEFAULT_SETTINGS.default_seed
        )
    elif splitting == "unique_target":
        target_column = ""
        for cfg in data_config.values():
            if cfg["target"] and not cfg.get("alignment"):
                target_column = cfg["column"]
                break
        dataset_dict = target_split(
            combined(), target_column, cv_split=cv_split,
            seed=DEFAULT_SETTINGS.default_seed,
        )
    elif splitting == "random":
        dataset_dict = split(combined(), cv_split)
    elif splitting == "given_splits" and len(split_tables) == 3:
        if set(split_tables) != {"train", "validation", "test"}:
            raise ValueError(
                f"Expected ['train', 'validation', 'test'] but found "
                f"{list(split_tables)}."
            )
        dataset_dict = split_tables
    else:
        raise ValueError(f"Unknown split {splitting}.")

    dataset_dict["train"] = augment(dataset_dict["train"], augment_config, num_cpu)

    rename = {}
    for modality, cfg in data_config.items():
        column = cfg["column"]
        if isinstance(column, str) and column not in ("percentage", "") and not cfg.get("alignment"):
            rename[column] = modality
    dataset_dict = {k: v.rename_columns(rename) for k, v in dataset_dict.items()}

    if mixture_config:
        logger.info("Creating mixture dataset")
        out: Dict[str, Any] = {}
        for split_name, table in dataset_dict.items():
            max_samples = sum(
                mixture_config[conf][f"{split_name}_max_n_samples"]
                for conf in mixture_config
            )
            out[split_name] = IterableDatasetWithLength(
                generator_fn=multi_config_mix,
                generator_args={
                    "dataset": table,
                    "mixture_config": mixture_config,
                    "split": split_name,
                    "seed": DEFAULT_SETTINGS.default_seed,
                },
                length=max_samples,
                split=split_name,
            )
            logger.info("Max len for %s: %d", split_name, max_samples)
        dataset_dict = out

    return data_config, dataset_dict
