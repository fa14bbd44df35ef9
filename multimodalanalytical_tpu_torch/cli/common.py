"""Shared CLI pipeline pieces: dataset -> preprocessors -> loaders -> model (counterpart of ``cli/common.py``).

The data pieces come from this package's copies of the framework-free
``data/``, ``config/`` and ``configuration`` layers, imported inside the
functions that need them (they pull in pyyaml, pyarrow and ``tokenizers``,
which the decode core never needs). This module also keeps its own
``setup_logging`` and ``seed_everything``.
"""

from __future__ import annotations

import logging
import random
import sys
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig, resolve_model_config
from ..models.seq2seq import Seq2SeqModel
from ..training.loader import DataLoader, subsample_dataset

logger = logging.getLogger(__name__)


def default_configs_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "configs"


def compose(config_name: str, overrides) -> Dict[str, Any]:
    """The config composer (``config/loader.py``) on the repository's ``configs/`` tree."""
    from ..config import compose_config

    return compose_config(default_configs_dir(), config_name, list(overrides))


def setup_logging(log_file: Optional[Path] = None, level: int = logging.INFO) -> None:
    handlers: list = [logging.StreamHandler(sys.stderr)]
    if log_file is not None:
        log_file = Path(log_file)
        log_file.parent.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(level=level, format="%(asctime)s %(levelname)s %(name)s: %(message)s",
                        handlers=handlers, force=True)


def seed_everything(seed: Optional[int] = None) -> int:
    """Seed Python's, numpy's and torch's generators (reference
    utils.py:175-179); the default is the shared settings' seed."""
    if seed is None:
        from ..configuration import DEFAULT_SETTINGS

        seed = DEFAULT_SETTINGS.default_seed
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


CPU_OVERRIDE = "+device=cpu"


def config_device(config: Dict[str, Any]) -> torch.device:
    """The device an entry point runs on: ``config["device"]``, which is
    ``cuda`` unless the caller asks for the CPU with the override
    ``+device=cpu``. Raises when a CUDA device is asked for and there is
    none: an entry point never carries on on the CPU by itself."""
    device = torch.device(config.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} was asked for but torch.cuda.is_available() "
                           f"is False; pass {CPU_OVERRIDE} to run on the CPU")
    return device


def sample_train_columns(train_set) -> Dict[str, Any]:
    """<=10k-row sample used for preprocessor/length fitting
    (reference data_utils.py:49-59)."""
    from ..configuration import DEFAULT_SETTINGS
    from ..data.data_utils import sample_rows
    from ..data.datasets import IterableDatasetWithLength, TableDataset

    if isinstance(train_set, IterableDatasetWithLength):
        return train_set.take(min(DEFAULT_SETTINGS.default_samples, len(train_set))).columns
    if not isinstance(train_set, TableDataset):
        raise TypeError(f"unsupported dataset {type(train_set).__name__}")
    return train_set.slice_columns(sample_rows(len(train_set)))


def build_preprocessors(config: Dict[str, Any], data_config: Dict[str, Any], train_set
                        ) -> Tuple[Dict[str, Any], Dict[str, Any], Path]:
    """Load the preprocessor artifact if present, else fit and save it."""
    from ..data.data_utils import (
        fit_preprocessors,
        load_preprocessors_artifact,
        save_preprocessors,
    )

    if config.get("preprocessor_path"):
        artifact_path = Path(config["preprocessor_path"])
    else:
        artifact_path = Path(config["working_dir"]) / config["job_name"] / "preprocessor.json"
    if artifact_path.is_file():
        logger.info("Loading existing preprocessor from: %s", artifact_path)
        data_config, preprocessors = load_preprocessors_artifact(artifact_path)
    else:
        logger.info("No existing preprocessor found at: %s", artifact_path)
        data_config, preprocessors = fit_preprocessors(sample_train_columns(train_set),
                                                       data_config)
        save_preprocessors(artifact_path, data_config, preprocessors)
    return data_config, preprocessors, artifact_path


def build_collator(data_config: Dict[str, Any], preprocessors: Dict[str, Any], train_set,
                   batch_size: int, extra_columns=None, artifact_path=None):
    """A collator padded to ``batch_size`` with lengths fitted on a sample of
    the training set; the lengths are written into the artifact so that it
    alone can serve."""
    from ..data.collator import MultiModalCollator
    from ..data.data_utils import save_collator_lengths

    collator = MultiModalCollator(preprocessors=preprocessors, data_config=data_config,
                                  extra_columns=extra_columns, pad_to_batch_size=batch_size)
    collator.fit_lengths(sample_train_columns(train_set))
    if artifact_path is not None and Path(artifact_path).is_file():
        save_collator_lengths(artifact_path, collator.max_source_length,
                              collator.max_target_length)
    return collator


def build_loaders(dataset_dict: Dict[str, Any], collator, batch_size: int, seed: int,
                  test_idx=None) -> Dict[str, DataLoader]:
    """Train (shuffled when a table), validation and test loaders;
    validation and test are capped at 10k random rows, or the test rows are
    the ``test_idx`` .npy index file (reference datamodules.py:441-491).

    Under several data ranks every loader is row-sharded: each feeds its
    contiguous chunk of every global batch of ``batch_size`` rows
    (reference trainer/trainer.py:58, DDP), and the collator pads to the
    chunk, ``batch_size // n_data``, which must be whole. The data ranks
    are ``parallel/mesh.py:default_mesh``'s: every process (no CLI builds a
    model axis)."""
    from ..data.datasets import TableDataset
    from ..parallel.mesh import default_mesh

    mesh = default_mesh()
    num_shards = mesh.n_data
    if num_shards > 1:
        if batch_size % num_shards != 0:
            raise ValueError(f"model.batch_size={batch_size} must be divisible by the data "
                             f"ranks ({num_shards}) for multi-process training")
        collator.pad_to_batch_size = batch_size // num_shards
    shards = dict(num_shards=num_shards, shard_index=mesh.data_index)
    loaders = {}
    if "train" in dataset_dict:
        loaders["train"] = DataLoader(dataset_dict["train"], collator, batch_size,
                                      shuffle=isinstance(dataset_dict["train"], TableDataset),
                                      seed=seed, **shards)
    if "validation" in dataset_dict:
        loaders["validation"] = DataLoader(
            subsample_dataset(dataset_dict["validation"], 10000, seed), collator, batch_size,
            **shards)
    if "test" in dataset_dict:
        test_set = dataset_dict["test"]
        if test_idx is not None:
            test_set = test_set.select(np.load(test_idx))
        else:
            test_set = subsample_dataset(test_set, 10000, seed)
        loaders["test"] = DataLoader(test_set, collator, batch_size, **shards)
    return loaders


def build_model(model_config_dict: Dict[str, Any], data_config: Dict[str, Any],
                target_modality: str, tokenizer, device: torch.device,
                seed: int = 0) -> Tuple[Seq2SeqModel, ModelConfig]:
    """The model of a model config on ``device``, initialised from ``seed``."""
    cfg = resolve_model_config(model_config_dict, vocab_size=tokenizer.vocab_size,
                               pad_token_id=tokenizer.pad_token_id,
                               bos_token_id=tokenizer.bos_token_id,
                               eos_token_id=tokenizer.eos_token_id)
    model = Seq2SeqModel(cfg, data_config, target_modality,
                         multimodal_norm=model_config_dict.get("multimodal_norm", True),
                         device=device,
                         generator=torch.Generator(device=device).manual_seed(seed))
    return model, cfg


def score_predictions(predictions: Dict[str, Any], molecules: bool = True,
                      rejection_sampling: bool = False,
                      predict_class: Optional[str] = None) -> Dict[str, Any]:
    """Top-1..Top-K of ``predict``'s output by ``evaluation/metrics.py``,
    optionally after rejection sampling (beams
    whose formula differs from the target's dropped), which rewrites
    ``predictions["predictions"]`` in place as the JAX predict CLI does;
    per class when ``predict_class`` names a returned column."""
    from ..evaluation.metrics import calc_sampling_metrics, reject_sample

    if rejection_sampling:
        reject_sample(predictions, molecules=molecules)
    classes = None
    if predict_class and predict_class in predictions:
        classes = predictions[predict_class]
        if classes and isinstance(classes[0], list):
            classes = [c[0] for c in classes]
    return calc_sampling_metrics(predictions["predictions"], predictions["targets"],
                                 classes=classes, molecules=molecules, logging=True)


def write_json(path: Path, payload: Any) -> None:
    import json

    with Path(path).open("w") as f:
        json.dump(payload, f)
