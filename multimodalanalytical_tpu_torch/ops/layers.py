"""The flax layers the JAX package builds on, with flax's numerics.

* :class:`Dense` is ``flax.linen.Dense(dtype=...)``: input, weight and bias
  are cast to the compute dtype, the product is rounded to it, then the
  bias is added (and rounded again). Weights are kept in fp32 and stored in
  PyTorch's (out_features, in_features) layout: flax's kernel transposed.
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
    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 dtype: torch.dtype = torch.float32, blocks: int = 1,
                 device=None, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(xavier_uniform_(
            torch.empty(out_features, in_features, device=device), generator, blocks))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
        return F.embedding(ids.long(), self.weight.to(self.dtype))


def make_generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    """The generator to initialise with: the caller's, or one seeded with 0."""
    if generator is not None:
        return generator
    return torch.Generator(device=torch.device(device or "cpu")).manual_seed(0)
