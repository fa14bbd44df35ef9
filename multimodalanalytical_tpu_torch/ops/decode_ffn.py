"""Decode-step feed-forward: hand-written CUDA kernel and its plain version.

Counterpart of ``multimodalanalytical_tpu/ops/decode_ffn.py`` (Pallas
``_ffn_kernel``). The kernel is ``csrc/decode_ffn.cu``: a tiled bf16 GEMM on
the tensor cores (``nvcuda::wmma``, fp32 accumulation) launched twice, once
for the up projection with the bias, exact-erf GELU and optional gate in its
epilogue, and once for the down projection, with a bf16 (M, F) activation
between the two. The source note there says what bounds it on the H100.

Numerics (both versions): every product accumulates in fp32 and rounds to
bf16, every bias add rounds to bf16 (flax ``Dense(dtype=bfloat16)``), and
GELU runs in fp32 on the bf16 value. CUDA's ``erff`` stands in for the
Cephes rational the TPU kernel uses; the difference vanishes in the bf16
rounding.

Dispatch: a CPU tensor takes :func:`geglu_ffn_plain`; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda

BF16 = torch.bfloat16


def geglu_ffn_plain(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    wg: Optional[torch.Tensor],
    bg: Optional[torch.Tensor],
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version; weights in Linear layout (out, in)."""
    x = x.to(BF16)
    h = (x @ w1.to(BF16).t()) + b1.to(BF16)
    act = F.gelu(h.float()).to(BF16)
    if wg is not None:
        act = act * ((x @ wg.to(BF16).t()) + bg.to(BF16))
    return (act @ w2.to(BF16).t()) + b2.to(BF16)


def geglu_ffn(
    x: torch.Tensor,               # (M, D)
    w1: torch.Tensor,              # (F, D)
    b1: torch.Tensor,              # (F,)
    wg: Optional[torch.Tensor],    # (F, D) | None (ungated)
    bg: Optional[torch.Tensor],    # (F,)   | None
    w2: torch.Tensor,              # (D, F)
    b2: torch.Tensor,              # (D,)
) -> torch.Tensor:
    """Fused (optionally gated) GELU FFN; returns (M, D) bf16.

    ``geglu_ffn.launches`` counts the calls that launched the kernel (one
    per call: the up and down GEMM launches of one call count once).
    """
    if x.device.type == "cpu":
        return geglu_ffn_plain(x, w1, b1, wg, bg, w2, b2)
    _cuda.require(x.is_cuda, f"geglu_ffn: unsupported device {x.device}")
    m, d = x.shape
    f = w1.shape[0]
    gated = wg is not None
    ops = [t.to(BF16).contiguous() if t is not None else None
           for t in (x, w1, b1, wg, bg, w2, b2)]
    x, w1, b1, wg, bg, w2, b2 = ops
    _cuda.require(d % 8 == 0 and f % 8 == 0,
                  f"geglu_ffn: d_model {d} and ffn_dim {f} must be multiples of 8")
    _cuda.require(w1.shape == (f, d) and w2.shape == (d, f)
                  and b1.shape == (f,) and b2.shape == (d,)
                  and (not gated or (wg.shape == (f, d) and bg.shape == (f,))),
                  "geglu_ffn: weight shapes do not match x")
    _cuda.require(all(t.is_cuda and t.device == x.device and t.data_ptr() % 16 == 0
                      for t in ops if t is not None),
                  "geglu_ffn: operands must be 16-byte aligned on x's device")
    hidden = torch.empty((m, f), dtype=BF16, device=x.device)
    out = torch.empty((m, d), dtype=BF16, device=x.device)
    lib = _cuda.library()
    _cuda.check(lib.mmt_geglu_ffn(
        _cuda.ptr(x), _cuda.ptr(w1), _cuda.ptr(b1), _cuda.ptr(wg), _cuda.ptr(bg),
        _cuda.ptr(w2), _cuda.ptr(b2), _cuda.ptr(hidden), _cuda.ptr(out),
        m, d, f, _cuda.stream()), "geglu_ffn")
    geglu_ffn.launches += 1
    return out


geglu_ffn.launches = 0
