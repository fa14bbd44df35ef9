"""What the reference computes for the comparisons that decide ``correct``.

* :func:`beam_readings`: the score of each returned beam as the reference
  sees it: the teacher-forced log-probabilities of the beam's tokens after
  BOS up to and including its first EOS (0 for the EOS forced at step
  ``max_length - 2``), summed and divided by their count, as the beam
  search normalises a finished hypothesis (length penalty 1); and whether
  the search kept each token as the top K would. Each step keeps the best
  2K of the K x V continuations and makes the best K that do not end in
  EOS the live beams, so a live beam's token is among the K best tokens
  other than EOS under its parent, and a finished hypothesis's EOS among
  the 2K best: a token below that, in the reference, was not chosen by
  the top K, or was altered after it.
* :func:`train_readings`: three training steps (clip by global norm, AdamW
  with optax's bias corrections, the OneCycle schedule) from the same
  weights on the same batches with the same dropout masks: each step's
  loss, each parameter's gradient norm at step 1 as the optimizer takes it
  (clipped), and each parameter's change after step 3.
* :func:`train_gaps`: the gaps between the program's and the reference's
  readings: of the losses, relative; of the per-parameter norms, at the
  worst parameter, against the reference's norm of that parameter or of
  the median parameter, whichever is larger; the change over the elements
  :func:`moved` keeps.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .model import Reference

ADAM_EPS = 1e-8
NEG_INF = float("-inf")


def beam_readings(ref: Reference, inputs: Dict[str, torch.Tensor], mask: torch.Tensor,
                  seqs: torch.Tensor, eos: int, int8_kv: bool,
                  control: Optional[Reference] = None, rows_per_block: int = 16
                  ) -> Dict[str, torch.Tensor]:
    """``seqs`` (B, K, L) -> per beam (B, K): ``scores``, the reference's
    score of the beam, and ``rank_gap``, the widest gap over the beam's
    tokens by which a token lies below the least log-probability that the
    search could have kept there (see the module's docstring). With
    ``control`` (a lower-precision reference), ``control_scores`` and
    ``control_rank_gap``: its score of the same beams, and the gap of the
    token it would keep in each token's place (its own token of the rank
    that the served token has in the reference, at most K)."""
    batch, beams, length = seqs.shape
    out = {"scores": torch.empty(batch, beams, dtype=torch.float32, device=seqs.device),
           "rank_gap": torch.empty(batch, beams, dtype=torch.float32, device=seqs.device)}
    if control is not None:
        out["control_scores"] = torch.empty_like(out["scores"])
        out["control_rank_gap"] = torch.empty_like(out["scores"])
    steps = torch.arange(length - 1, device=seqs.device)
    with torch.no_grad():
        memory = ref.encode(inputs, mask)
        other = control.encode(inputs, mask) if control is not None else None
        for start in range(0, batch, rows_per_block):
            rows = slice(start, min(start + rows_per_block, batch))
            n = rows.stop - rows.start
            block = seqs[rows].reshape(n * beams, length).long()
            mem_mask = mask[rows].repeat_interleave(beams, dim=0)
            logp_all = torch.log_softmax(ref.decode(
                block[:, :-1], None, memory[rows].repeat_interleave(beams, dim=0), mem_mask,
                int8_kv=int8_kv), dim=-1)
            tokens = block[:, 1:]
            is_eos = tokens == eos
            has_eos = is_eos.any(dim=1)
            first = torch.where(has_eos, is_eos.float().argmax(dim=1) + 1, length - 1)
            counted = steps[None, :] < first[:, None]
            forced = steps == length - 2
            norm = torch.where(has_eos, first, length).float()

            def score(logp_all: torch.Tensor) -> torch.Tensor:
                logp = logp_all.gather(-1, tokens[..., None])[..., 0]
                logp = torch.where(forced, 0.0, logp)
                return ((logp * counted).sum(dim=1) / norm).reshape(n, beams)

            # The least log-probability a kept token can have: the K-th best
            # of the tokens other than EOS for a live beam's token, the 2K-th
            # best of all for a finished hypothesis's EOS.
            logp_tok = logp_all.gather(-1, tokens[..., None])[..., 0]
            no_eos = logp_all.clone()
            no_eos[..., eos] = NEG_INF
            least = torch.where(is_eos, logp_all.topk(2 * beams, dim=-1).values[..., -1],
                                no_eos.topk(beams, dim=-1).values[..., -1])
            judged = counted & ~forced

            def rank_gap(logp_kept: torch.Tensor) -> torch.Tensor:
                gap = torch.where(judged, (least - logp_kept).clamp(min=0.0), 0.0)
                return gap.max(dim=1).values.reshape(n, beams)

            out["scores"][rows] = score(logp_all)
            out["rank_gap"][rows] = rank_gap(logp_tok)
            if control is not None:
                logp_low = torch.log_softmax(control.decode(
                    block[:, :-1], None, other[rows].repeat_interleave(beams, dim=0), mem_mask,
                    int8_kv=int8_kv), dim=-1)
                out["control_scores"][rows] = score(logp_low)
                rank = (no_eos > logp_tok[..., None]).sum(dim=-1).clamp(max=beams - 1)
                low_no_eos = logp_low.clone()
                low_no_eos[..., eos] = NEG_INF
                kept = low_no_eos.argsort(dim=-1, descending=True, stable=True).gather(
                    -1, rank[..., None])
                kept = torch.where(is_eos[..., None], tokens[..., None], kept)
                out["control_rank_gap"][rows] = rank_gap(
                    logp_all.gather(-1, kept)[..., 0])
    return out


def onecycle_lr(count: int, steps: int, peak: float, pct_start: float = 0.3,
                div: float = 25.0, final_div: float = 1e4) -> float:
    """optax's cosine_onecycle_schedule at update ``count`` (horizon floored at 4)."""
    steps = max(steps, 4)
    bounds = (0, int(pct_start * steps), steps)
    values = (peak / div, peak, peak / div / (div * final_div))
    for i in range(2):
        if bounds[i] <= count < bounds[i + 1]:
            pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
            return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (math.cos(math.pi * pct) + 1)
    return values[2]


def step_seed(seed: int, step: int) -> int:
    """The training stream's seed at a step."""
    return (seed * 1_000_003 + step) % 2 ** 63


def train_readings(params: Dict[str, torch.Tensor], config: Dict[str, Any],
                   batches: Sequence[Dict[str, Any]], seed: int, fp8: bool = False,
                   half_batch: bool = False) -> Dict[str, Any]:
    """Three steps from ``params`` (left as they are) on ``batches``, with
    the dropout masks of trainer seed ``seed``: the losses, the clipped
    gradients of step 1 and the change of every parameter after step 3.
    ``half_batch`` leaves out the second half of each batch's rows (the
    mean over the rest)."""
    model, trainer = config["model"], config["trainer"]
    names = list(params)
    live = {n: params[n].detach().clone().requires_grad_(True) for n in names}
    ref = Reference(live, config, fp8=fp8)
    b1, b2 = model["adam_beta1"], model["adam_beta2"]
    decay = float(model["weight_decay"]) if model["optimiser"] == "adamw" else 0.0
    mu = {n: torch.zeros_like(live[n]) for n in names}
    nu = {n: torch.zeros_like(live[n]) for n in names}
    device = next(iter(params.values())).device
    losses: List[float] = []
    first: Dict[str, torch.Tensor] = {}
    for step, batch in enumerate(batches[:3]):
        if half_batch:
            labels = batch["labels"].clone()
            labels[labels.shape[0] // 2:] = -100
            batch = dict(batch, labels=labels)
        generator = torch.Generator(device=device).manual_seed(step_seed(seed, step))
        loss = ref.loss(batch, generator)
        grads = torch.autograd.grad(loss, [live[n] for n in names], allow_unused=True)
        grads = [torch.zeros_like(live[n]) if g is None else g for n, g in zip(names, grads)]
        losses.append(loss.item())
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
            if float(norm) >= trainer["clip_grad"]:
                grads = [g / norm * trainer["clip_grad"] for g in grads]
            if step == 0:
                first = dict(zip(names, grads))
            count = step + 1
            lr = onecycle_lr(step, trainer["num_steps"], model["lr"])
            for n, g in zip(names, grads):
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                update = (mu[n] / (1 - b1 ** count)) / ((nu[n] / (1 - b2 ** count)).sqrt()
                                                        + ADAM_EPS)
                live[n].sub_(lr * (update + decay * live[n]))
    with torch.no_grad():
        change = {n: live[n] - params[n] for n in names}
    return {"losses": losses, "grads": first, "change": change}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   names: Optional[Sequence[str]] = None) -> float:
    """max over ``names`` (all of ``want`` by default) of |got - want| over
    max(want's norm there, want's median norm)."""
    names = list(want) if names is None else list(names)
    median = float(np.median([want[n] for n in names]))
    return max(abs(got[n] - want[n]) / max(want[n], median) for n in names)


def moved(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per parameter, the elements whose reference gradient at step 1 is not
    nought to rounding: at least a thousandth of the median parameter's
    root-mean-square element gradient. (A key projection's bias under
    softmax has none: it moves under Adam by round-off alone.)"""
    rms = [float(g.norm()) / math.sqrt(g.numel()) for g in grads.values()]
    floor = 1e-3 * float(np.median(rms))
    return {n: g.abs() >= floor for n, g in grads.items()}


def train_gaps(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
    """The three compared numbers of a training cell. ``got``: the
    program's ``losses``, per-parameter gradient norms at step 1
    (``grad_norms``) and changes after step 3 (``change``, tensors)."""
    loss_gap = max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"]))
    keep = moved(want["grads"])
    names = [n for n, k in keep.items() if bool(k.any())]
    grad_norms = {n: float(want["grads"][n].norm()) for n in names}
    change_want = {n: float(want["change"][n][keep[n]].norm()) for n in names}
    change_got = {n: float(got["change"][n].to(keep[n].device)[keep[n]].norm()) for n in names}
    return {"loss_gap": loss_gap,
            "grad_gap": worst_leaf_gap(got["grad_norms"], grad_norms, names),
            "update_gap": worst_leaf_gap(change_got, change_want, names)}
