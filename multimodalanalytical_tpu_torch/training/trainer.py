"""The train step and a step-bounded fit loop (counterpart of ``training/trainer.py``).

One step, as the JAX ``Trainer`` takes it: modality dropout as encoder-mask
zeroing (shape-stable, numerically the reference's input removal), the
training forward (dropout drawn from the trainer's generator), the gradient
of the loss with respect to every fp32 master parameter, then
``training/optim.py``'s clip -> Adam/AdamW -> OneCycle update.

Mixed precision comes from the model's own casts: ``Dense`` and ``Embed``
cast weights and inputs to the compute dtype where flax does
(``ops/layers.py``), so no ``torch.autocast`` is used; autocast would round
at other places than flax does.

Not ported yet: validation, checkpoints and the CLI (``ROADMAP.md``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from .optim import build_optimizer, global_norm

logger = logging.getLogger(__name__)

BATCH_KEYS = ("encoder_inputs", "encoder_mask", "decoder_ids", "decoder_mask", "labels")


def modality_segments(encoder_inputs: Dict[str, Any], order: Sequence[str]
                      ) -> List[Tuple[str, int, int]]:
    """(modality, start, end) over the concatenated source axis, in the data
    config's ``order`` (the embedding concatenates in that order)."""
    segments, offset = [], 0
    for modality in (m for m in order if m in encoder_inputs):
        length = encoder_inputs[modality].shape[1]
        segments.append((modality, offset, offset + length))
        offset += length
    return segments


def apply_modality_dropout(encoder_mask: torch.Tensor, droppable: Sequence[Tuple[int, int]],
                           generator: torch.Generator) -> torch.Tensor:
    """Zero the mask over a random subset of the ``droppable`` (start, end)
    segments: k is drawn from [0, n) and the first k of a random order are
    dropped, so every listed modality is never dropped at once."""
    if not droppable:
        return encoder_mask
    n = len(droppable)
    k = int(torch.randint(0, n, (1,), generator=generator))
    order = torch.randperm(n, generator=generator).tolist()
    mask = encoder_mask.clone()
    for rank, (start, end) in zip(order, droppable):
        if rank < k:
            mask[:, start:end] = 0
    return mask


def device_batch(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """The model inputs of a collated batch as tensors on ``device``
    (host-only fields such as ``n_valid`` and ``target_strings`` dropped)."""
    out = {key: torch.as_tensor(batch[key], device=device) for key in BATCH_KEYS[1:]}
    out["encoder_inputs"] = {m: torch.as_tensor(x, device=device)
                             for m, x in batch["encoder_inputs"].items()}
    return out


class Trainer:
    def __init__(self, model: torch.nn.Module, optimiser: str = "adam", lr: float = 1e-3,
                 weight_decay: float = 0.0, adam_beta1: float = 0.9, adam_beta2: float = 0.999,
                 num_steps: int = 1000, acc_batches: int = 1, clip_grad: float = 1.0,
                 modality_dropout: Optional[Sequence[str]] = None, seed: int = 0):
        """As the JAX ``Trainer``'s optimizer and step arguments. ``seed``
        seeds the dropout stream (on the model's device) and the modality
        dropout draws (on the host)."""
        self.model = model
        self.params = list(model.parameters())
        self.device = self.params[0].device
        self.optimizer = build_optimizer(self.params, optimiser, lr, num_steps, weight_decay,
                                         adam_beta1, adam_beta2, clip_grad, acc_batches)
        self.modality_dropout = list(modality_dropout or [])
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(seed)
        self.modality_generator = torch.Generator().manual_seed(seed)
        self.global_step = 0

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One step on a collated batch; returns 0-d tensors (no host sync):
        loss, model_only_loss, alignment_loss and grad_norm (the global norm
        of this batch's gradients, before clipping)."""
        batch = device_batch(batch, self.device)
        segments = modality_segments(batch["encoder_inputs"], self.model.embedding.modalities)
        droppable = [(start, end) for m, start, end in segments if m in self.modality_dropout]
        encoder_mask = apply_modality_dropout(batch["encoder_mask"], droppable,
                                              self.modality_generator)
        out = self.model(batch["encoder_inputs"], encoder_mask, batch["decoder_ids"],
                         batch["decoder_mask"], batch["labels"], deterministic=False,
                         generator=self.dropout_generator)
        grads = torch.autograd.grad(out["loss"], self.params, allow_unused=True,
                                    materialize_grads=True)
        grad_norm = global_norm(grads)
        self.optimizer.step(grads)
        self.global_step += 1
        return {"loss": out["loss"].detach(), "model_only_loss": out["model_only_loss"].detach(),
                "alignment_loss": out["alignment_loss"], "grad_norm": grad_norm}

    def fit(self, train_loader: Iterable[Dict[str, Any]], max_steps: int,
            log_every: int = 10) -> List[float]:
        """Take ``max_steps`` train steps, cycling over ``train_loader``
        (epochs), logging the loss every ``log_every`` steps. Returns the
        per-step losses."""
        losses: List[torch.Tensor] = []
        while len(losses) < max_steps:
            started = len(losses)
            for batch in train_loader:
                metrics = self.train_step(batch)
                losses.append(metrics["loss"])
                if self.global_step % log_every == 0:
                    logger.info("step %d train_loss %.4f grad_norm %.4f", self.global_step,
                                float(metrics["loss"]), float(metrics["grad_norm"]))
                if len(losses) == max_steps:
                    break
            if len(losses) == started:
                raise ValueError("train_loader yielded no batch")
        return torch.stack(losses).tolist()
