"""Dropout whose random bits are made inside the kernel (counterpart of ``ops/fused_dropout.py``).

:func:`fused_dropout` replaces the Pallas ``pallas_dropout`` (``_run`` /
``_kernel``): inverted dropout whose mask is a pure function of a seed and
the element's flat index, so the backward rebuilds it from the seed and no
mask is stored. The TPU kernel takes its bits from the TPU core's PRNG;
here they are Philox4x32-10 (key = the 64-bit seed, counter = flat index
// 4, one 32-bit word per element), computed by the CUDA kernel
(``csrc/fused_dropout.cu``) and, bit for bit, by :func:`philox4x32_10` in
the plain version. The streams of the two packages differ; the contract is
the same:

* drop iff ``bits < min(round(rate * 2**32), 2**32 - 1)``;
* a kept value is ``float32(x) * float32(1 / (1 - rate))``, rounded once to
  ``x.dtype`` (``ops/dropout.py`` divides in ``x.dtype`` instead);
* the gradient is the same pass on the cotangent with the same seed.

As in the JAX package it is a library function, not a model option:
:func:`dropout` has ``ops/dropout.py``'s signature, so a caller can route
dropout sites through it. The seed is drawn from the caller's generator as
an int64 tensor on ``x``'s device and read by the kernel through a pointer:
no host sync per site.

Dispatch: a CPU tensor takes :func:`fused_dropout_plain`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import _cuda

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def drop_threshold(rate: float) -> int:
    """The 32-bit threshold below which an element is dropped."""
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def keep_scale(rate: float) -> float:
    """``1 / (1 - rate)`` rounded to float32, as the Pallas kernel forms it."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_dropout: rate {rate} outside [0, 1)")


def _mulhilo32(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``a * b`` for 32-bit ``a`` and int64
    tensors ``b`` of 32-bit values, by 16-bit halves of ``b`` so that no
    int64 product overflows."""
    p_lo = a * (b & 0xFFFF)                      # < 2**48
    p_hi = a * (b >> 16)                         # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)         # < 2**49
    return (p_hi >> 16) + (mid >> 32), mid & MASK32


def philox4x32_10(counter: List[torch.Tensor], key: Tuple[torch.Tensor, torch.Tensor]
                  ) -> List[torch.Tensor]:
    """Philox4x32-10 on int64 tensors holding 32-bit words: four counter
    words and two key words in, four random words out (Random123's
    ``philox4x32_R(10, ctr, key)``)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & MASK32
        k1 = (k1 + PHILOX_W[1]) & MASK32
    return [c0, c1, c2, c3]


def dropout_bits(seed: torch.Tensor, n: int) -> torch.Tensor:
    """The 32-bit words (as int64) of elements 0..n-1 for an int64 ``seed``
    tensor of one element."""
    groups = (n + 3) // 4
    index = torch.arange(groups, dtype=torch.int64, device=seed.device)
    zeros = torch.zeros_like(index)
    s = seed.reshape(()).to(torch.int64)
    words = philox4x32_10([index & MASK32, index >> 32, zeros, zeros],
                          (s & MASK32, (s >> 32) & MASK32))
    return torch.stack(words, dim=1).reshape(-1)[:n]


def fused_dropout_plain(x: torch.Tensor, seed: torch.Tensor, rate: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_dropout`."""
    _check_rate(rate)
    keep = dropout_bits(seed, x.numel()) >= drop_threshold(rate)
    inv = torch.tensor(keep_scale(rate), dtype=torch.float32, device=x.device)
    kept = (x.reshape(-1).float() * inv).to(x.dtype)
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype, device=x.device)).reshape(
        x.shape)


def fused_dropout(x: torch.Tensor, seed: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout of ``x`` (any shape; bf16 or fp32 on the card) with
    the mask of ``seed`` (an int64 tensor of one element on ``x``'s device).
    ``fused_dropout.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return fused_dropout_plain(x, seed, rate)
    require = _cuda.require
    _check_rate(rate)
    require(x.is_cuda, f"fused_dropout: unsupported device {x.device}")
    require(x.dtype in KERNEL_DTYPES, f"fused_dropout: dtype {x.dtype} is not bf16 or fp32")
    require(seed.dtype == torch.int64 and seed.numel() == 1 and seed.device == x.device,
            "fused_dropout: seed must be one int64 on x's device")
    x = x.contiguous()
    require(x.data_ptr() % 16 == 0, "fused_dropout: x must be 16-byte aligned")
    out = torch.empty_like(x)
    lib = _cuda.library()
    _cuda.check(lib.mmt_fused_dropout(
        int(x.dtype == torch.bfloat16), _cuda.ptr(x), _cuda.ptr(out), _cuda.ptr(seed),
        x.numel(), drop_threshold(rate), keep_scale(rate), _cuda.stream()), "fused_dropout")
    fused_dropout.launches += 1
    return out


_cuda.count_launches(fused_dropout)


class FusedDropoutFunction(torch.autograd.Function):
    """Counterpart of the JAX custom VJP (``_fwd`` / ``_bwd``): saves only
    the seed; the backward is the same pass on the gradient."""

    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.save_for_backward(seed)
        ctx.rate = rate
        return fused_dropout(x, seed, rate)

    @staticmethod
    def backward(ctx, grad):
        (seed,) = ctx.saved_tensors
        return fused_dropout(grad, seed, ctx.rate), None, None


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """One int64 seed from ``generator``, made on ``device`` (no host sync)."""
    return torch.randint(-2 ** 63, 2 ** 63 - 1, (1,), generator=generator, device=device,
                         dtype=torch.int64)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """``ops/dropout.py``'s ``dropout`` through the fused pass: the identity
    for rate 0 or no generator, zeros for rate 1 (as the JAX callers guard
    it), otherwise :class:`FusedDropoutFunction` with a seed drawn from
    ``generator``."""
    if generator is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    return FusedDropoutFunction.apply(x, draw_seed(generator, x.device), rate)
