"""Inverted dropout drawn from an explicit generator (counterpart of ``ops/dropout.py``).

The JAX package's ``Dropout`` keeps each element with probability
``1 - rate`` and scales kept elements by ``1 / (1 - rate)`` (``lax.select``
of ``x / keep_prob``), drawing its mask from the flax ``dropout`` stream.
Here the mask comes from the ``torch.Generator`` the caller passes down, so
a training run is reproducible per seed; the two frameworks' streams differ,
so train-step parity with the JAX package holds only with dropout off.

The JAX module's key-saving VJP (regenerate the mask in the backward instead
of storing it) answers a TPU memory problem and is not carried over:
autograd keeps the boolean mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            columns: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``x`` with inverted dropout; the identity for rate 0 or no generator
    (deterministic mode). ``columns`` = (n, i): ``x`` is block i of n equal
    blocks of the last axis of a wider tensor (a tensor-parallel rank's
    slice); the mask is drawn for the wider tensor and block i of it kept,
    so that the ranks together drop what one process drops."""
    if generator is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    if columns is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    else:
        n, i = columns
        width = x.shape[-1]
        keep = (torch.rand(*x.shape[:-1], n * width, generator=generator, device=x.device)
                [..., i * width:(i + 1) * width] < keep_prob)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
