"""Flash attention for the long-sequence encoder: CUDA kernels and their plain versions.

Counterpart of ``multimodalanalytical_tpu/ops/flash_attention.py``:

* :func:`flash_attention_fwd` replaces the Pallas ``_fwd`` (``_fwd_kernel``):
  online-softmax self-attention of every query row against all keys plus a
  (B, Lk) additive key bias, returning the output in q's dtype and the fp32
  logsumexp of every row;
* :func:`flash_attention_bwd` replaces the Pallas ``_bwd`` (``_bwd_kernel``):
  dq, dk and dv recomputed from the saved logsumexp.

The kernels are in ``csrc/flash_attention.cu``, whose source note says what
bounds them on the H100 and how their design answers it.

Numerics of the plain versions, as the Pallas kernels compute on every
backend, interpret mode included: q, k and v are upcast to fp32 and the
``head_dim**-0.5`` scale is applied to q in fp32; logits, probabilities and
every sum stay in fp32; the output is rounded once to q's dtype. The
backward takes ``delta = rowsum(dO * O)`` from the SAVED output in the
compute dtype (not a re-computed fp32 one), and dk / dv are summed in fp32
and cast once. The plain versions are the fp32-faithful reference.

The bf16 CUDA kernels run their products on the tensor cores: bf16 products
are exact in fp32, the scale is applied to S in fp32 (at head_dim 64,
2**-3, equal to scaling q), the bias is added in fp32, and the running max
and the denominator are summed from the fp32 probabilities, so lse stays
fp32-faithful. P (forward, dV) and dS (dQ, dK) are rounded to bf16 only as
tensor-core operands; every sum stays in fp32 and outputs are rounded once.
``tests/test_torch_flash_numerics.py`` models those roundings against the
Pallas kernels. The fp32 kernels compute as the plain versions do.

Padding is part of the function's meaning: :func:`flash_attention` pads Lq
and Lk to multiples of 256 (``BLK``) with zero rows and ``NEG_INF`` key bias,
as the JAX wrapper does, so a row whose real keys are all masked spreads its
weight over the real and the padded keys alike (-1e9 + x against -1e9 in
fp32). The running max starts at ``NEG_INF`` in both versions.

Dispatch: a CPU tensor takes the ``*_plain`` version; a CUDA tensor launches
the kernels or raises. The kernels take head_dim 64 (every shipped model
config) and 128: every width the gate routes here up to 128. The gate also
admits 192, 256, ...; the wrapper raises on those.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _cuda

NEG_INF = -1e9
BLK = 256               # the JAX wrapper's BLK_Q = BLK_K; Lq and Lk are padded to it
FLASH_MIN_LENGTH = 2048
KERNEL_HEAD_DIMS = (64, 128)   # the gate's multiples of 64 up to 128, one instantiation each


def flash_qualifies(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor],
                    scale: Optional[float]) -> bool:
    """The JAX package's flash gate: the baked 1/sqrt(Dh) scale
    (``ops/attention.py``: ``scale is None``), self-attention shapes with
    Lq == Lk >= 2048, head_dim a multiple of 64 and a key-padding bias of
    shape (B, 1, 1, Lk) (``flash_attention.py`` ``qualifies``)."""
    lq, d = q.shape[2], q.shape[3]
    return (scale is None and lq >= FLASH_MIN_LENGTH and lq == k.shape[2] and d % 64 == 0
            and (bias is None or (bias.ndim == 4 and bias.shape[-2] == 1)))


def flash_attention_fwd_plain(q, k, v, bias_row) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`flash_attention_fwd` on whole matrices."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    logits = logits + bias_row.float()[:, None, None, :]
    row_max = logits.amax(dim=-1).clamp_min(NEG_INF)
    probs = torch.exp(logits - row_max[..., None])
    denom = probs.sum(dim=-1)
    safe_denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    out = torch.matmul(probs, v.float()) / safe_denom[..., None]
    return out.to(q.dtype), row_max + torch.log(safe_denom)


def flash_attention_bwd_plain(q, k, v, bias_row, out, lse, do
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`flash_attention_bwd` on whole matrices."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * out.float()).sum(dim=-1)
    logits = torch.matmul(qf * scale, kf.transpose(-1, -2)) + bias_row.float()[:, None, None, :]
    probs = torch.exp(logits - lse[..., None])
    dprobs = torch.matmul(dof, vf.transpose(-1, -2))
    dlogits = probs * (dprobs - delta[..., None])
    dq = torch.matmul(dlogits, kf) * scale
    dk = torch.matmul(dlogits.transpose(-1, -2), qf) * scale
    dv = torch.matmul(probs.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_operands(name: str, q, k, v, bias_row, *more) -> None:
    require = _cuda.require
    require(q.is_cuda, f"{name}: unsupported device {q.device}")
    b, h, length, d = q.shape
    require(q.dtype in (torch.bfloat16, torch.float32) and k.dtype == q.dtype == v.dtype,
            f"{name}: q, k and v must share one dtype, bf16 or fp32")
    require(d in KERNEL_HEAD_DIMS, f"{name}: head_dim {d} is not one of {KERNEL_HEAD_DIMS}")
    require(length % 64 == 0 and k.shape == q.shape == v.shape,
            f"{name}: q, k and v must be (B, H, L, Dh) with L a multiple of 64")
    require(bias_row.shape == (b, length) and bias_row.dtype == torch.float32,
            f"{name}: bias_row must be (B, L) fp32")
    tensors = (q, k, v, bias_row) + more
    require(all(t.is_cuda and t.device == q.device and t.is_contiguous()
                and t.data_ptr() % 16 == 0 for t in tensors),
            f"{name}: operands must be contiguous, 16-byte aligned and on one device")


def flash_attention_fwd(q: torch.Tensor,          # (B, H, L, Dh), L padded to 64
                        k: torch.Tensor,
                        v: torch.Tensor,
                        bias_row: torch.Tensor,   # (B, L) fp32 additive key bias
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, H, L, Dh) in q's dtype, lse (B, H, L) fp32).

    ``flash_attention_fwd.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, bias_row)
    q, k, v, bias_row = (t.contiguous() for t in (q, k, v, bias_row))
    _check_operands("flash_attention_fwd", q, k, v, bias_row)
    b, h, length, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, length), dtype=torch.float32, device=q.device)
    lib = _cuda.library()
    _cuda.check(lib.mmt_flash_attention_fwd(
        int(q.dtype == torch.bfloat16), _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v),
        _cuda.ptr(bias_row), _cuda.ptr(out), _cuda.ptr(lse), b, h, length, d,
        d ** -0.5, _cuda.stream()), "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, bias_row, out, lse, do
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (dq, dk, dv), each in its operand's dtype.

    ``flash_attention_bwd.launches`` counts calls that launched the three
    backward kernels (delta, dk/dv, dq)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, bias_row, out, lse, do)
    q, k, v, bias_row, out, lse, do = (
        t.contiguous() for t in (q, k, v, bias_row, out, lse, do))
    _check_operands("flash_attention_bwd", q, k, v, bias_row, out, lse, do)
    _cuda.require(out.shape == q.shape == do.shape and out.dtype == q.dtype == do.dtype
                  and lse.shape == q.shape[:3] and lse.dtype == torch.float32,
                  "flash_attention_bwd: out and do must match q, lse must be (B, H, L) fp32")
    b, h, length, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    lib = _cuda.library()
    _cuda.check(lib.mmt_flash_attention_bwd(
        int(q.dtype == torch.bfloat16), _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v),
        _cuda.ptr(bias_row), _cuda.ptr(out), _cuda.ptr(lse), _cuda.ptr(do), _cuda.ptr(delta),
        _cuda.ptr(dq), _cuda.ptr(dk), _cuda.ptr(dv), b, h, length, d, d ** -0.5,
        _cuda.stream()), "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Counterpart of the JAX ``_flash`` custom VJP on padded operands: saves
    (q, k, v, bias_row, out, lse) and recomputes in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, bias_row):
        out, lse = flash_attention_fwd(q, k, v, bias_row)
        ctx.save_for_backward(q, k, v, bias_row, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = flash_attention_bwd(*ctx.saved_tensors, do)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, H, L, Dh) self-attention with a (B, 1, 1, L) key-padding bias, for
    shapes where :func:`flash_qualifies` holds (the caller checks)."""
    b, _, lq, _ = q.shape
    lk = k.shape[2]
    if bias is None:
        bias_row = torch.zeros(b, lk, dtype=torch.float32, device=q.device)
    else:
        bias_row = bias[:, 0, 0, :].expand(b, lk).float()
    pad_q, pad_k = (-lq) % BLK, (-lk) % BLK
    if pad_q or pad_k:
        q = F.pad(q, (0, 0, 0, pad_q))
        k = F.pad(k, (0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, pad_k))
        bias_row = F.pad(bias_row, (0, pad_k), value=NEG_INF)
    out = FlashAttentionFunction.apply(q, k, v, bias_row)
    return out[:, :, :lq, :]
