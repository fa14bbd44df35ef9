"""The optimizer of the JAX trainer, as optax computes it (counterpart of
``training/trainer.py`` ``build_optimizer``).

``clip_by_global_norm -> adam | adamw`` with ``cosine_onecycle_schedule``,
wrapped in ``MultiSteps`` when gradients are accumulated. Three points
where PyTorch's stock pieces compute something else:

* clipping scales by exactly ``max_norm / norm``, and only when
  ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
  ``norm + 1e-6`` and always multiplies);
* the schedule moves the learning rate only (``OneCycleLR`` also cycles
  Adam's beta1 by default) and is a plain function of the update count;
* AdamW decays every parameter, decoupled from the adaptive step, with
  optax's bias correction.

Updates are applied in place to the model's fp32 parameters. Under tensor
parallelism a rank holds slices of some parameters and whole copies of the
rest: the update is elementwise, so it runs on the slices as they are, and
the global norm counts the sharded gradients' squares summed over the model
group and the replicated ones once (the optimizer's ``sharded`` and
``mesh``), so that the clip equals the one-process clip.

A step has a host half and a device half, so that the device half can be
captured once in a CUDA graph and replayed, as ``jax.jit`` compiles the
JAX step once: :meth:`Optimizer.plan` takes every value that depends on
the update count (the schedule's learning rate, optax's float32 bias
corrections, the accumulation's running-mean divisor, and whether this
gradient completes an accumulation) and writes the numbers into the
device tensor :attr:`Optimizer.scalars`; :meth:`Optimizer.step` runs the
update and reads those numbers only from that tensor.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..ops._cuda import copy_from_host_

ADAM_EPS = 1e-8   # optax's adam/adamw default


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4
                             ) -> Callable[[int], float]:
    """optax's ``cosine_onecycle_schedule``: cosine from ``peak / div`` up to
    ``peak`` over the first ``int(pct_start * steps)`` updates, then cosine
    down to ``peak / (div * final_div)``, constant after ``steps``."""
    if transition_steps <= 0:
        raise ValueError("a onecycle schedule needs a positive number of steps")
    bounds = (0, int(pct_start * transition_steps), int(transition_steps))
    values = [peak_value / div_factor]
    values.append(values[0] * div_factor)
    values.append(values[1] * (1.0 / (div_factor * final_div_factor)))

    def schedule(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (
                    math.cos(math.pi * pct) + 1)
        return values[2]

    return schedule


def global_norm(tensors: Sequence[torch.Tensor], sharded: Optional[Sequence[bool]] = None,
                mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (a 0-d tensor):
    the norm of the per-tensor norms, a few fused launches for any count.
    With ``sharded`` (per tensor: a slice over ``mesh``'s model group) the
    squares of the sharded tensors are summed over the model group, and the
    replicated ones counted once."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if mesh is None or mesh.n_model == 1 or not any(sharded or ()):
        return torch.linalg.vector_norm(torch.stack(norms))
    # Selected on the host, so that nothing here reads the device.
    split = torch.stack([n for n, s in zip(norms, sharded) if s]).square().sum().reshape(1)
    mesh.all_reduce_model_(split)
    whole = [n for n, s in zip(norms, sharded) if not s]
    return (split[0] + torch.stack(whole).square().sum()).sqrt() if whole else split[0].sqrt()


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: ``g / norm * max_norm`` for every
    gradient when ``norm >= max_norm``, the gradients unchanged otherwise.
    ``norm``: the gradients' global norm when computed already."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm) for g in grads]


class Optimizer:
    """``chain(clip_by_global_norm(clip_grad), adam | adamw(schedule))``,
    in ``MultiSteps(every_k=acc_batches)`` when ``acc_batches > 1``.

    ``count`` is the number of updates applied (the schedule's and the bias
    correction's step); ``mini_step`` counts the gradients accumulated
    towards the next update, whose mean it applies. Both live on the host:
    :meth:`plan` turns them into :attr:`scalars` (the learning rate, the
    bias corrections ``1 - b1**count`` and ``1 - b2**count`` in float32,
    and the running mean's divisor ``mini_step + 1``) on the parameters'
    device, which is all :meth:`step` reads of them. ``grad_norm`` is the
    global norm of the gradient :meth:`step` took last, before clipping."""

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999,
                 weight_decay: Optional[float] = None, clip_grad: float = 1.0,
                 acc_batches: int = 1, sharded: Optional[Sequence[bool]] = None, mesh=None):
        self.params = list(params)
        self.sharded, self.mesh = sharded, mesh
        self.schedule = schedule
        self.b1, self.b2 = b1, b2
        self.weight_decay = weight_decay
        self.clip_grad = clip_grad
        self.acc_batches = max(int(acc_batches), 1)
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.acc = ([torch.zeros_like(p, dtype=torch.float32) for p in self.params]
                    if self.acc_batches > 1 else None)
        self.count = 0
        self.mini_step = 0
        # lr, bias1, bias2, divisor (plan() writes them, step() reads them).
        self.scalars = torch.zeros(4, dtype=torch.float32, device=self.params[0].device)
        self.grad_norm: Optional[torch.Tensor] = None

    def state_dict(self) -> dict:
        """The moments, the accumulator and the two counts (what a
        checkpoint's ``opt_state`` holds)."""
        return {"mu": list(self.mu), "nu": list(self.nu),
                "acc": list(self.acc) if self.acc is not None else None,
                "count": self.count, "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` into this optimizer's buffers."""
        pairs = [(self.mu, state["mu"]), (self.nu, state["nu"])]
        if self.acc is not None:
            pairs.append((self.acc, state["acc"]))
        for own, saved in pairs:
            if len(own) != len(saved):
                raise ValueError(f"optimizer state for {len(saved)} parameters, not {len(own)}")
            for dst, src in zip(own, saved):
                dst.copy_(src)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])

    def plan(self) -> bool:
        """The host half of the next gradient's step: write its values into
        :attr:`scalars` and advance the counts. Returns whether the
        gradient completes an accumulation (every gradient without
        accumulation): :meth:`step` then clips and updates."""
        divisor = self.mini_step + 1
        completes = divisor == self.acc_batches
        lr = 0.0
        if completes:
            lr = self.schedule(self.count)
            self.count += 1
            self.mini_step = 0
        else:
            self.mini_step += 1
        # optax forms the bias corrections 1 - b**count in float32.
        count = np.float32(max(self.count, 1))
        values = np.array([lr, 1 - np.float32(self.b1) ** count,
                           1 - np.float32(self.b2) ** count, divisor], dtype=np.float32)
        copy_from_host_(self.scalars, values)
        return completes

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], completes: Optional[bool] = None) -> None:
        """Take one gradient: add it to the running mean when gradients are
        accumulated, and clip and update when it completes an update. The
        device half of the step, under the plan :meth:`plan` made, which
        returned ``completes`` (None: the plan is made here); it reads the
        count's values from :attr:`scalars` only, so a CUDA graph of it
        stays right at every count. Sets :attr:`grad_norm`."""
        if completes is None:
            completes = self.plan()
        grads = [g.float() for g in grads]
        self.grad_norm = self.norm(grads)
        norm = self.grad_norm
        if self.acc is not None:
            # Welford running mean, as MultiSteps(use_grad_mean=True).
            divisor = self.scalars[3]
            for acc, g in zip(self.acc, grads):
                acc.add_((g - acc) / divisor)
            if not completes:
                return
            grads = self.acc
            norm = self.norm(grads)
        self._update(clip_by_global_norm(grads, self.clip_grad, norm))
        if self.acc is not None:
            for acc in self.acc:
                acc.zero_()

    def norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of gradients of :attr:`params` (the sharded ones'
        squares summed over the mesh's model group)."""
        return global_norm(grads, self.sharded, self.mesh)

    def _update(self, grads: List[torch.Tensor]) -> None:
        lr, bias1, bias2 = self.scalars[0], self.scalars[1], self.scalars[2]
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        mu_hat = torch._foreach_div(self.mu, bias1)
        denom = torch._foreach_div(self.nu, bias2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        updates = torch._foreach_div(mu_hat, denom)
        if self.weight_decay is not None:
            torch._foreach_add_(updates, self.params, alpha=self.weight_decay)
        # optax scales by -lr and adds: p + (-lr * u) == p - lr * u exactly.
        torch._foreach_mul_(updates, lr)
        torch._foreach_sub_(self.params, updates)


def build_optimizer(params: Sequence[torch.Tensor], optimiser: str, lr: float, num_steps: int,
                    weight_decay: float = 0.0, adam_beta1: float = 0.9,
                    adam_beta2: float = 0.999, clip_grad: float = 1.0,
                    acc_batches: int = 1, sharded: Optional[Sequence[bool]] = None,
                    mesh=None) -> Optimizer:
    """clip -> adam/adamw with the OneCycle schedule -> accumulation, as the
    JAX ``build_optimizer``; the horizon is floored at 4 updates there too
    (its warmup segment would be empty below that). ``sharded`` (per
    parameter: a slice over ``mesh``'s model group) and ``mesh`` make the
    clip's global norm the one-process norm under tensor parallelism."""
    schedule = cosine_onecycle_schedule(max(num_steps, 4), float(lr))
    return Optimizer(params, schedule, b1=adam_beta1, b2=adam_beta2,
                     weight_decay=float(weight_decay) if optimiser == "adamw" else None,
                     clip_grad=clip_grad, acc_batches=acc_batches, sharded=sharded, mesh=mesh)
