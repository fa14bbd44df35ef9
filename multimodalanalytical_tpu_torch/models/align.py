"""Encoder-alignment head (counterpart of ``models/align.py``).

Reconstructs the pure compound's spectrum from the mean-pooled encoder
state (the IR-mixture paper). Runs in fp32; parameter names follow the JAX
param tree (``fc1``, ``fc2``, ``conv1``, ``conv2``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import Dense
from .config import AlignConfig


def kl_div_batchmean(p: torch.Tensor, q: torch.Tensor, eps: float = 1e-16) -> torch.Tensor:
    p = p.clamp_min(eps)
    q = q.clamp_min(eps)
    return (p * torch.log(p / q)).sum() / p.shape[0]


def sid(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Spectral information divergence (reference modeling/utils.py:8-22)."""
    return kl_div_batchmean(x, y) + kl_div_batchmean(y, x)


ALIGN_LOSSES = {
    "mse": lambda pred, target: ((pred - target) ** 2).mean(),
    "mae": lambda pred, target: (pred - target).abs().mean(),
    "sid": sid,
}


class Conv1d(nn.Module):
    """``flax.linen.Conv`` over one spatial axis, with padding k // 2 on both
    sides; the weight in PyTorch's (out, in, k) layout, which is the flax
    kernel (k, in, out) with all axes reversed."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        weight = torch.empty(kernel_size, out_channels, in_channels, device=device)
        # Xavier-uniform with flax's fans for a (k, in, out) kernel: the
        # receptive field k multiplies both.
        limit = (6.0 / (kernel_size * (in_channels + out_channels))) ** 0.5
        with torch.no_grad():
            weight.uniform_(-limit, limit, generator=generator)
        self.weight = nn.Parameter(weight.permute(1, 2, 0).contiguous())
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        self.padding = kernel_size // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C_in, W) -> (B, C_out, W + 2 (k // 2) - k + 1)."""
        return F.conv1d(x, self.weight, self.bias, padding=self.padding)


class AlignNetwork(nn.Module):
    def __init__(self, config: AlignConfig, d_model: int, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        if config.align_network not in ("convolutional", "mlp"):
            raise ValueError(f"Unknown align network {config.align_network}")
        self.config = config
        hidden = config.hidden_dimension
        self.fc1 = Dense(d_model, hidden, device=device, generator=generator)
        if config.align_network == "convolutional":
            self.fc2 = Dense(hidden, hidden, device=device, generator=generator)
            self.conv1 = Conv1d(hidden, config.conv_channels, config.kernel_size,
                                device=device, generator=generator)
            self.conv2 = Dense(config.conv_channels, config.output_dimension, device=device,
                               generator=generator)
        else:
            self.fc2 = Dense(hidden, config.output_dimension, device=device,
                             generator=generator)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        """(B, d_model) mean-pooled encoder state -> (B, output_dimension)."""
        x = torch.relu(self.fc1(pooled.float()))
        x = self.fc2(x)
        if self.config.align_network == "convolutional":
            # The reference's Conv1d over a singleton spatial axis: (B, C, 1).
            # With an odd kernel and padding k // 2 the output keeps one
            # position, on which only the centre tap sees data; the whole
            # kernel is applied all the same.
            x = torch.relu(self.conv1(x[:, :, None])[:, :, 0])
            x = self.conv2(x)
        return torch.sigmoid(x)
