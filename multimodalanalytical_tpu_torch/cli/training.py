"""Training entry point (counterpart of ``cli/training.py``).

compose config -> dataset -> preprocessors -> collator/loaders -> model ->
finetune load -> fit -> reload ``best`` -> beam-search predict at
``model.n_beams`` -> ``metrics_beam_{K}.json`` and
``test_data_logits_beam_{K}.json``, as the JAX entry point::

    python -m multimodalanalytical_tpu_torch.cli.training \\
        working_dir=runs job_name=train data=ir/patches data_path=... model=custom_model

The model runs on the CUDA device when there is one (its kernels then carry
decode and long encoders), else on the CPU. Config composition and the
datasets need pyyaml, pyarrow and ``tokenizers``.

A ``mixture`` config trains on the host generator: the JAX package's
``device_mixing=False`` route, its parity reference (device-side mixing is
not ported yet). Guided generation is not ported yet and raises.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Any, Dict, List

from ..training.checkpoint import CheckpointManager, load_finetune_params, restore_params
from ..training.trainer import Trainer, calculate_training_steps
from .common import (
    build_collator,
    build_loaders,
    build_model,
    build_preprocessors,
    compose,
    default_device,
    score_predictions,
    seed_everything,
    setup_logging,
    write_json,
)

logger = logging.getLogger(__name__)

GUIDED_NOT_PORTED = ("guided_generation is not ported to the PyTorch package yet "
                     "(ROADMAP Queue 1 item 9); run without it or use the JAX package")


def run(config: Dict[str, Any]) -> Dict[str, Any]:
    from ..data.datasets import build_dataset_multimodal

    work_dir = Path(config["working_dir"]) / config["job_name"]
    work_dir.mkdir(parents=True, exist_ok=True)
    setup_logging(work_dir / "training.log")
    seed = seed_everything()
    device = default_device()

    data_config = dict(config["data"])
    model_config: Dict[str, Any] = dict(config["model"])
    if model_config.get("guided_generation"):
        raise NotImplementedError(GUIDED_NOT_PORTED)
    if config.get("mixture"):
        logger.info("Mixture synthesis runs on the host generator (device-side mixing is "
                    "ROADMAP Queue 1 item 10)")

    data_config, dataset = build_dataset_multimodal(
        data_config, data_path=config["data_path"], cv_split=config.get("cv_split", 0),
        splitting=config.get("splitting", "random"), augment_config=config.get("augment"),
        num_cpu=config.get("num_cpu", 7), mixture_config=config.get("mixture"))
    logger.info("Built dataset")

    data_config, preprocessors, artifact_path = build_preprocessors(
        config, data_config, dataset["train"])
    batch_size = model_config["batch_size"]
    predict_class = config.get("predict_class")
    collator = build_collator(data_config, preprocessors, dataset["train"], batch_size,
                              extra_columns=[predict_class] if predict_class else None,
                              artifact_path=artifact_path)
    loaders = build_loaders(dataset, collator, batch_size, seed)
    target_modality = collator.target_modality
    logger.info("Built loaders (target modality: %s)", target_modality)

    tokenizer = preprocessors[target_modality]
    model, _ = build_model(model_config, data_config, target_modality, tokenizer, device, seed)

    trainer_config = config["trainer"]
    epochs = trainer_config["epochs"]
    acc_batches = trainer_config.get("acc_batches", 1) or 1
    monitor = trainer_config.get("checkpoint_monitor", "val_molecular_accuracy")
    trainer = Trainer(
        model, tokenizer,
        optimiser=model_config.get("optimiser", "adam"),
        lr=model_config.get("lr", 1e-3),
        weight_decay=model_config.get("weight_decay", 0.0),
        adam_beta1=model_config.get("adam_beta1", 0.9),
        adam_beta2=model_config.get("adam_beta2", 0.999),
        num_steps=calculate_training_steps(len(dataset["train"]), batch_size, acc_batches,
                                           epochs),
        acc_batches=acc_batches,
        clip_grad=trainer_config.get("clip_grad", 1.0),
        modality_dropout=config.get("modality_dropout"),
        seed=seed,
        n_beams=model_config.get("n_beams", 10),
        monitor=monitor,
        checkpoint_every_n_vals=trainer_config.get("checkpoint_every_n_vals", 1) or 1,
    )

    # Finetuning: params only, without the align network when align is off
    # (reference cli/training.py:152-162).
    if config.get("finetuning") and model_config.get("model_checkpoint_path"):
        params, _ = load_finetune_params(model_config["model_checkpoint_path"], model,
                                         strip_align=model_config.get("align_config") is None)
        model.load_state_dict(params)
        logger.info("Loaded finetuning checkpoint from %s", model_config["model_checkpoint_path"])

    checkpoints = CheckpointManager(work_dir / "checkpoints", monitor=monitor,
                                    mode=trainer.monitor_mode)
    metrics_writer = None
    try:
        import tensorboardX

        metrics_writer = tensorboardX.SummaryWriter(str(work_dir / "tb"))
    except ImportError:
        pass

    # Resume (full optimizer state) when a checkpoint path is given without
    # finetuning (reference cli/training.py:165).
    resume = bool(model_config.get("model_checkpoint_path")) and not config.get("finetuning")
    trainer.fit(
        loaders["train"], loaders.get("validation"), epochs=epochs, checkpoints=checkpoints,
        early_stopping_patience=trainer_config.get("early_stopping_patience"),
        limit_val_batches=trainer_config.get("limit_val_batches", 1.0) or 1.0,
        val_check_interval=trainer_config.get("val_check_interval"),
        metrics_writer=metrics_writer, resume=resume, max_steps=trainer_config.get("max_steps"))

    # Reload the best checkpoint for the final evaluation (reference
    # cli/training.py:167-187); the final state when there is none.
    best_dir = work_dir / "checkpoints" / "best"
    if best_dir.exists():
        model.load_state_dict(restore_params(best_dir))
        logger.info("Loaded best checkpoint (step %s)", checkpoints.best_step)
    else:
        logger.info("No best checkpoint; evaluating final state")

    n_beams = model_config.get("n_beams", 10)
    predictions = trainer.predict(loaders["test"], n_beams=n_beams)
    metrics = score_predictions(predictions, molecules=config.get("molecules", True),
                                predict_class=predict_class)
    write_json(work_dir / f"test_data_logits_beam_{n_beams}.json", predictions)
    metrics_path = work_dir / f"metrics_beam_{n_beams}.json"
    write_json(metrics_path, metrics)
    logger.info("Metrics saved to: %s", metrics_path)
    return metrics


def main(argv: List[str] | None = None) -> None:
    run(compose("config_train", sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
