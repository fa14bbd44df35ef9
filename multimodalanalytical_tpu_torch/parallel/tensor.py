"""The collectives of tensor parallelism, with their gradients (Megatron's form).

What GSPMD inserts around the JAX package's sharded products
(``parallel/mesh.py`` there), written out over a :class:`~.mesh.Mesh`'s
model group:

* :func:`copy_to_model` in front of a column-parallel product: the
  identity forward; its backward sums the input's gradient over the model
  group (each rank's columns contributed a part of it);
* :func:`reduce_from_model` after a row-parallel product: the sum of the
  ranks' partial products forward; the identity backward (the sum is
  replicated, so every rank's gradient of it is the whole gradient);
* :func:`gather_from_model` for the column-parallel lm_head: each rank
  writes its vocabulary columns into a zeroed (..., V) fp32 buffer, which is
  summed over the model group (adding zeros is exact, so every backend only
  needs ``all_reduce``); the backward takes this rank's columns of the
  gradient.

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
sums the gradient again, which :func:`reduce_from_model` must not. Every
function here is the identity when the mesh has no model axis (n_model 1),
so a one-process model takes none of them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import Mesh


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_model_(grad.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_model_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        width = x.shape[-1]
        ctx.cols = slice(mesh.model_index * width, (mesh.model_index + 1) * width)
        full = x.new_zeros(*x.shape[:-1], width * mesh.n_model)
        full[..., ctx.cols] = x
        return mesh.all_reduce_model_(full)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.cols].contiguous(), None


def _split(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.n_model > 1


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Identity forward; gradient summed over the model group."""
    return _CopyToModel.apply(x, mesh) if _split(mesh) else x


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum over the model group forward; gradient passed through."""
    return _ReduceFromModel.apply(x, mesh) if _split(mesh) else x


def gather_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """(..., V / n) column shards -> (..., V), in rank order; gradient sliced."""
    return _GatherFromModel.apply(x, mesh) if _split(mesh) else x
