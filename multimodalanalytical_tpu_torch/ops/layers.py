"""The flax layers the JAX package builds on, with flax's numerics.

* :class:`Dense` is ``flax.linen.Dense(dtype=...)``: input, weight and bias
  are cast to the compute dtype, the product is rounded to it, then the
  bias is added (and rounded again). Weights are kept in fp32 and stored in
  PyTorch's (out_features, in_features) layout: flax's kernel transposed.
  Under tensor parallelism (``mesh`` and ``shard_axis``) it holds only this
  rank's slice (``parallel/mesh.py``): column-parallel (axis 0) takes the
  replicated input and gives this rank's output columns; row-parallel
  (axis 1) takes this rank's input columns, forms its fp32 partial product
  without the bias (:meth:`Dense.partial`), sums the partials over the model
  group, rounds to the compute dtype once and adds the bias once, so it
  rounds where the one-process Dense rounds and differs from it only by the
  order of the fp32 sums. The partial product upcasts its operands to fp32
  (exact for bf16 ones) and runs as an fp32 product, which PyTorch keeps out
  of TF32 by default (``torch.backends.cuda.matmul.allow_tf32`` False).
* :class:`LayerNorm` always runs in fp32 (eps 1e-5); callers cast its output.
* :class:`RMSNorm` is ``flax.linen.RMSNorm(dtype=float32)`` (eps 1e-6, T5's
  layer_norm_epsilon): fp32, no mean subtraction and no bias.
* :class:`Embed` is ``flax.linen.Embed(dtype=...)``.

Initialisation draws from an explicit ``torch.Generator`` with the flax
initialisers' distributions (Xavier-uniform kernels and tables, zero
biases, unit norm scales); the draws differ from JAX's, so tests that need
equal weights map the JAX params with ``models/weights.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import Mesh, Shard, local_slice
from ..parallel.tensor import copy_to_model, reduce_from_model


def xavier_uniform_(weight: torch.Tensor, generator: torch.Generator,
                    blocks: int = 1) -> torch.Tensor:
    """Xavier-uniform over (out, in), applied per block of output rows so a
    fused (n*D, D) projection draws like n separate (D, D) ones."""
    out_total, in_dim = weight.shape
    block = out_total // blocks
    limit = math.sqrt(6.0 / (in_dim + block))
    with torch.no_grad():
        return weight.uniform_(-limit, limit, generator=generator)


class Dense(nn.Module):
    """``mesh`` and ``shard_axis`` (0: column-parallel, 1: row-parallel)
    split it over the mesh's model group; the full weight is drawn first and
    sliced, so a rank's slice is the one-process weight's."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 dtype: torch.dtype = torch.float32, blocks: int = 1,
                 device=None, generator: torch.Generator, mesh: Optional[Mesh] = None,
                 shard_axis: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        weight = xavier_uniform_(torch.empty(out_features, in_features, device=device),
                                 generator, blocks)
        bias_value = torch.zeros(out_features, device=device) if bias else None
        self.mesh, self.shard = None, None
        if shard_axis is not None and mesh is not None and mesh.n_model > 1:
            self.mesh = mesh
            self.shard = Shard(shard_axis, blocks if shard_axis == 0 else 1)
            weight = local_slice(weight, self.shard, mesh.n_model, mesh.model_index)
            if bias_value is not None and shard_axis == 0:
                bias_value = local_slice(bias_value, self.shard, mesh.n_model, mesh.model_index)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias_value) if bias else None

    @property
    def row_parallel(self) -> bool:
        return self.shard is not None and self.shard.axis == 1

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """Row-parallel: this rank's fp32 partial product, without the bias."""
        return x.to(self.dtype).float() @ self.weight.to(self.dtype).float().t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.row_parallel:
            y = reduce_from_model(self.partial(x), self.mesh).to(self.dtype)
        else:
            if self.shard is not None:
                x = copy_to_model(x, self.mesh)
            y = x.to(self.dtype) @ self.weight.to(self.dtype).t()
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), self.eps)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean_square = x.square().mean(dim=-1, keepdim=True)
        return x * (torch.rsqrt(mean_square + self.eps) * self.weight.float())


class Embed(nn.Module):
    """``stddev`` draws the table from N(0, stddev^2) (flax's ``normal``
    initialiser) instead of Xavier-uniform."""

    def __init__(self, num_embeddings: int, dim: int, *, dtype: torch.dtype = torch.float32,
                 stddev: Optional[float] = None, device=None, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        table = torch.empty(num_embeddings, dim, device=device)
        if stddev is None:
            xavier_uniform_(table, generator)
        else:
            table.normal_(0.0, stddev, generator=generator)
        self.weight = nn.Parameter(table)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return _GatherRows.apply(self.weight.to(self.dtype), ids.long())


class _GatherRows(torch.autograd.Function):
    """``table[ids]``, whose backward sums each row's gradients as one fp32
    product of a one-hot matrix (rows x ids) with the gradient, rounded to
    the table's dtype once. Its order is fixed, so it gives the same bits at
    every call, as a train step's graph and its eager body must agree;
    on the card ``F.embedding``'s backward does not, run to run, and
    indexing's (a sorted ``index_put``) adds an id's rows one after
    another, which a padded batch's thousands of pad ids make take
    milliseconds."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        ids, = ctx.saved_tensors
        rows = torch.arange(ctx.rows, device=ids.device)
        one_hot = (rows[:, None] == ids.reshape(1, -1)).float()
        summed = one_hot @ grad.reshape(-1, grad.shape[-1]).float()
        return summed.to(grad.dtype), None


def make_generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    """The generator to initialise with: the caller's, or one seeded with 0."""
    if generator is not None:
        return generator
    return torch.Generator(device=torch.device(device or "cpu")).manual_seed(0)
