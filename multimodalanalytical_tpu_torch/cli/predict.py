"""Prediction entry point (counterpart of ``cli/predict.py``).

Loads the preprocessor artifact, trims the modalities absent from the
current data config (a multitask checkpoint serving a single-task request,
reference predict.py:71-77), restores the checkpoint, beam-search decodes
at ``model.n_beams`` and scores, with rejection sampling when
``model.rejection_sampling`` is set::

    python -m multimodalanalytical_tpu_torch.cli.predict \\
        working_dir=runs job_name=predict data=ir/patches data_path=... model=custom_model \\
        preprocessor_path=runs/train/preprocessor.json \\
        model.model_checkpoint_path=runs/train/checkpoints/best

``model.model_checkpoint_path`` is a checkpoint directory of this package or
an ``.npz`` of a JAX param tree (``training/checkpoint.py``).
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Any, Dict, List

from ..training.checkpoint import restore_params
from ..training.trainer import Trainer
from .common import (
    build_collator,
    build_loaders,
    build_model,
    compose,
    default_device,
    score_predictions,
    seed_everything,
    setup_logging,
    write_json,
)
from .training import GUIDED_NOT_PORTED

logger = logging.getLogger(__name__)


def run(config: Dict[str, Any]) -> Dict[str, Any]:
    from ..data.data_utils import load_preprocessors_artifact
    from ..data.datasets import build_dataset_multimodal

    work_dir = Path(config["working_dir"]) / config["job_name"]
    work_dir.mkdir(parents=True, exist_ok=True)
    setup_logging(work_dir / "predict.log")
    seed = seed_everything()

    model_config: Dict[str, Any] = dict(config["model"])
    if not model_config.get("model_checkpoint_path"):
        raise ValueError("Please supply model_checkpoint_path with model.model_checkpoint_path=...")
    if not config.get("preprocessor_path"):
        raise ValueError("Please supply preprocessor_path=...")
    if model_config.get("guided_generation"):
        raise NotImplementedError(GUIDED_NOT_PORTED)

    data_config = dict(config["data"])
    data_config, dataset = build_dataset_multimodal(
        data_config, data_path=config["data_path"], cv_split=config.get("cv_split", 0),
        splitting=config.get("splitting", "random"), augment_config=config.get("augment"),
        num_cpu=config.get("num_cpu", 7), mixture_config=config.get("mixture"))
    loaded_config, preprocessors = load_preprocessors_artifact(Path(config["preprocessor_path"]))
    data_config = {k: v for k, v in loaded_config.items() if k in data_config}

    batch_size = model_config["batch_size"]
    predict_class = config.get("predict_class")
    collator = build_collator(data_config, preprocessors, dataset["train"], batch_size,
                              extra_columns=[predict_class] if predict_class else None)
    loaders = build_loaders(dataset, collator, batch_size, seed, test_idx=config.get("test_idx"))
    target_modality = collator.target_modality
    tokenizer = preprocessors[target_modality]
    model, _ = build_model(model_config, data_config, target_modality, tokenizer,
                           default_device(), seed)
    model.load_state_dict(restore_params(model_config["model_checkpoint_path"]))
    logger.info("Restored checkpoint from %s", model_config["model_checkpoint_path"])

    n_beams = model_config.get("n_beams", 10)
    trainer = Trainer(model, tokenizer, num_steps=100, seed=seed, n_beams=n_beams)
    predictions = trainer.predict(loaders["test"], n_beams=n_beams)
    metrics = score_predictions(predictions, molecules=config.get("molecules", True),
                                rejection_sampling=bool(model_config.get("rejection_sampling")),
                                predict_class=predict_class)
    write_json(work_dir / f"test_data_logits_beam_{n_beams}.json", predictions)
    metrics_path = work_dir / f"metrics_beam_{n_beams}.json"
    write_json(metrics_path, metrics)
    logger.info("Metrics saved to: %s", metrics_path)
    return metrics


def main(argv: List[str] | None = None) -> None:
    run(compose("config_predict", sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
