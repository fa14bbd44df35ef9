"""Training entry point (counterpart of ``cli/training.py``).

compose config -> dataset -> preprocessors -> collator/loaders -> model ->
finetune load -> fit -> reload ``best`` -> beam-search predict at
``model.n_beams`` -> ``metrics_beam_{K}.json`` and
``test_data_logits_beam_{K}.json``, as the JAX entry point::

    python -m multimodalanalytical_tpu_torch.cli.training \\
        working_dir=runs job_name=train data=ir/patches data_path=... model=custom_model

The model runs on the CUDA device (its kernels carry decode and long
encoders); the override ``+device=cpu`` asks for the CPU, and without it a
machine with no CUDA device raises before any data is loaded. Config
composition and the datasets need pyyaml, pyarrow and ``tokenizers``.

Across processes, as the reference's DDP runs (``AFM_MULTIHOST=1``, one
process per card, ``parallel/mesh.py``)::

    AFM_MULTIHOST=1 torchrun --nproc_per_node N -m multimodalanalytical_tpu_torch.cli.training ...

each process trains on its rows of every global batch of
``model.batch_size`` (NCCL; gloo with ``+device=cpu``), rank 0 writes the
checkpoints and the tensorboard log, and every rank writes its predictions
and metrics with a ``_rank{r}`` suffix.

A ``mixture`` config trains on the device-side premix
(``data/device_mixture.py``) when the recipe is eligible and the run has
one process; ``device_mixing=false`` keeps the host generator, the parity
reference. ``model.guided_generation`` guides the final predict by each
target's formula: ``true`` (or ``surrogate``) in the decode step's graph,
``exact`` with one host call per step (``generation/guided.py``).
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Any, Dict, List

from ..parallel import initialize_multihost, is_main, rank_suffix
from ..training.checkpoint import CheckpointManager, load_finetune_params, restore_params
from ..training.trainer import Trainer, calculate_training_steps
from .common import (
    build_collator,
    build_loaders,
    build_model,
    build_preprocessors,
    compose,
    config_device,
    score_predictions,
    seed_everything,
    setup_logging,
    write_json,
)

logger = logging.getLogger(__name__)



def build_guided(model_config: Dict[str, Any], tokenizer):
    """The guided decoder of ``model.guided_generation`` (true -> the
    surrogate, or the named mode), or None when it is off."""
    guided_mode = model_config.get("guided_generation")
    if not guided_mode:
        return None
    from ..generation import guided_hook_builder

    mode = guided_mode if isinstance(guided_mode, str) else "surrogate"
    return guided_hook_builder(tokenizer, mode=mode)


def run(config: Dict[str, Any]) -> Dict[str, Any]:
    from ..data.datasets import build_dataset_multimodal

    device = config_device(config)
    work_dir = Path(config["working_dir"]) / config["job_name"]
    work_dir.mkdir(parents=True, exist_ok=True)
    setup_logging(work_dir / "training.log")
    device = initialize_multihost(device)
    seed = seed_everything()

    data_config = dict(config["data"])
    model_config: Dict[str, Any] = dict(config["model"])

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

    # Device-side mixture synthesis (data/device_mixture.py): the pool on
    # the device, only the sampling decisions from the host.
    # ``device_mixing=false`` keeps the host generator (the parity route).
    batch_transform = None
    if config.get("mixture") and config.get("device_mixing", True):
        from ..data.device_mixture import try_build_device_mixture

        device_mix = try_build_device_mixture(dataset["train"], data_config, preprocessors,
                                              collator, batch_size, seed=seed, device=device)
        if device_mix is not None:
            loaders["train"] = device_mix.loader
            batch_transform = device_mix.expand

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
        # Only an explicit YAML null takes the default: 0 abandons an
        # in-flight save at once at the end of the fit.
        checkpoint_wait_timeout_s=(
            600.0 if trainer_config.get("checkpoint_wait_timeout_s") is None
            else trainer_config["checkpoint_wait_timeout_s"]),
        batch_transform=batch_transform,
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
    if is_main():
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
        metrics_writer=metrics_writer, resume=resume, max_steps=trainer_config.get("max_steps"),
        profile_dir=config.get("profile_dir"))

    # Reload the best checkpoint for the final evaluation (reference
    # cli/training.py:167-187); the final state when there is none.
    best_dir = work_dir / "checkpoints" / "best"
    if best_dir.exists():
        model.load_state_dict(restore_params(best_dir))
        logger.info("Loaded best checkpoint (step %s)", checkpoints.best_step)
    else:
        logger.info("No best checkpoint; evaluating final state")

    n_beams = model_config.get("n_beams", 10)
    predictions = trainer.predict(loaders["test"], n_beams=n_beams,
                                  guided=build_guided(model_config, tokenizer))
    metrics = score_predictions(predictions, molecules=config.get("molecules", True),
                                predict_class=predict_class)
    # Per-rank artifacts across processes (reference cli/training.py:230-251).
    suffix = rank_suffix()
    write_json(work_dir / f"test_data_logits_beam_{n_beams}{suffix}.json", predictions)
    metrics_path = work_dir / f"metrics_beam_{n_beams}{suffix}.json"
    write_json(metrics_path, metrics)
    logger.info("Metrics saved to: %s", metrics_path)
    return metrics


def main(argv: List[str] | None = None) -> None:
    run(compose("config_train", sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
