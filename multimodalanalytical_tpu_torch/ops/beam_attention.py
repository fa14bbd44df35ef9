"""Beam-decode attention: hand-written CUDA kernels and their plain versions.

Counterpart of ``multimodalanalytical_tpu/ops/beam_attention.py``:

* :func:`beam_select_attention_update` replaces the Pallas
  ``beam_select_attention_update`` (``_kernel_upd`` / ``_kernel_upd_q8``):
  one lazy-ancestry decode step of self-attention for every beam, plus the
  append of this step's K/V rows (and int8 scales) to the cache;
* :func:`beam_select_attention` replaces the Pallas read-only
  ``beam_select_attention`` (``_kernel`` / ``_kernel_q8``): the same
  attention over a cache that already holds the time-``pos`` rows, which it
  reads through ``ancestry[:, :, pos]`` like every earlier time (the update
  reads them from this step's fresh rows instead, each beam at its own
  slot). The same CUDA kernel serves both, instantiated per mode;
* :func:`beam_cross_attention` replaces the Pallas ``beam_cross_attention``
  (``_cross_kernel``): all K beams of a batch row against that row's
  beam-invariant encoder K/V.

The kernels are in ``csrc/beam_attention.cu``, whose source note says what
bounds them on the H100 and how their design answers it.

Layout contract (as in the JAX package, see
``models/seq2seq.py init_beam_cache``): the cache is (2, B, L*K, D), int8 or
bf16, and flat row ``l*K + s`` holds what beam slot ``s`` wrote at time
``l``; int8 dequant scales are (2, B, H, F_pad) fp32 with F_pad >= L*K;
``ancestry[b, n, l]`` is the slot that holds beam n's time-l row, and
``ancestry[:, :, pos]`` is the identity (beam n writes slot n).

Numerics (both versions): q * Dh**-0.5 is rounded to bf16 before the dot,
dots accumulate in fp32, int8 logits are scaled by the key's per-(slot,
head) scale and probabilities by the value's, and probabilities are rounded
to bf16 before the value sum. In the update the time-``pos`` term reads
this step's fresh rows, which it stores in place first; an int8 cache
takes them un-quantized and quantizes them with :func:`quantize_kv_heads`'
arithmetic (the kernel bit for bit).

Dispatch: a CPU tensor takes the ``*_plain`` version; a CUDA tensor launches
the kernel or raises. The update is IN PLACE on ``cache`` and ``scales``
(the JAX package donated and aliased these buffers instead).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from . import _cuda

BF16 = torch.bfloat16


def beam_kernel_supports(beams: int, d_model: int, num_heads: int) -> bool:
    """Whether the CUDA beam kernels take this shape: head_dim a multiple of
    8 up to 256 (8-element row pieces), 1 to 256 beams, and K x head_dim at
    most 8192, within which both kernels' shared-memory plans fit the
    H100's 227 KB at any stage length and any encoder length (the select
    kernel moves its per-time tables to global memory when they outgrow
    shared memory; the cross kernel takes the keys in tiles). The launchers
    refuse a plan they cannot make, and stages beyond 65536 (time, slot)
    rows."""
    head_dim = d_model // num_heads
    return (head_dim * num_heads == d_model and head_dim % 8 == 0 and head_dim <= 256
            and 1 <= beams <= 256 and beams * head_dim <= 8192)


def quantize_kv_heads(x: torch.Tensor, num_heads: int):
    """Per-(row, head) symmetric int8 quantization of K/V rows.

    ``x``: (..., D). Returns (q int8 same shape, scales (..., H) fp32) with
    ``x ~= q * scales`` per head block. The scale is an IEEE division by
    127 on every device: the divisor is a tensor on ``x``'s device, since
    PyTorch's CUDA division by a Python number multiplies by its reciprocal
    instead, which may differ in the last bit (the update kernel divides)."""
    head_dim = x.shape[-1] // num_heads
    xh = x.reshape(*x.shape[:-1], num_heads, head_dim).float()
    amax = xh.abs().amax(dim=-1).clamp_min(1e-8)
    scales = amax / torch.full((), 127.0, device=x.device)
    q = torch.clamp(torch.round(xh / scales[..., None]), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scales


def _store_fresh_rows(cache, scales, k_new, v_new, pos, beams, num_heads):
    """Append this step's rows at flat rows pos*K .. pos*K+K-1 (in place),
    quantized by :func:`quantize_kv_heads` for an int8 cache."""
    batch, d_model = cache.shape[1], cache.shape[3]
    rows = slice(pos * beams, (pos + 1) * beams)
    if scales is not None:
        (k_new, k_scale), (v_new, v_scale) = (quantize_kv_heads(t, num_heads)
                                              for t in (k_new, v_new))
        scales[0, :, :, rows] = k_scale.reshape(batch, beams, num_heads).transpose(1, 2)
        scales[1, :, :, rows] = v_scale.reshape(batch, beams, num_heads).transpose(1, 2)
    cache[0, :, rows] = k_new.reshape(batch, beams, d_model)
    cache[1, :, rows] = v_new.reshape(batch, beams, d_model)


def beam_select_attention_update_plain(
    q, k_new, v_new, cache, ancestry, position, num_heads, scales=None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`beam_select_attention_update`."""
    beams = ancestry.shape[1]
    pos = int(position)
    _store_fresh_rows(cache, scales, k_new, v_new, pos, beams, num_heads)
    slot = ancestry[:, :, : pos + 1].long().clone()
    slot[:, :, pos] = torch.arange(beams, device=slot.device)
    return _attend_plain(q, cache, slot, num_heads, scales)


def _attend_plain(q, cache, slot, num_heads, scales) -> torch.Tensor:
    """Attention of the (B*K, D) queries over the cache rows that ``slot``
    (B, K, pos + 1) selects at every time; (B*K, D) bf16."""
    batch, beams, steps = slot.shape
    pos = steps - 1
    d_model = cache.shape[3]
    head_dim = d_model // num_heads
    times = torch.arange(pos + 1, device=slot.device)
    flat = times * beams + slot                                  # (B, K, P)
    b_idx = torch.arange(batch, device=slot.device)[:, None, None]

    def rows(plane):                                             # (B, K, P, H, Dh)
        return cache[plane][b_idx, flat].float().reshape(
            batch, beams, pos + 1, num_heads, head_dim)

    qh = (q.float() * head_dim ** -0.5).to(BF16).float().reshape(
        batch, beams, num_heads, head_dim)
    logits = torch.einsum("bnhd,bnlhd->bnhl", qh, rows(0))
    if scales is not None:
        # scales[plane][b, :, f] for every (b, n, l): (B, K, P, H) -> (B, K, H, P)
        logits = logits * scales[0][b_idx, :, flat].permute(0, 1, 3, 2)
    probs = torch.softmax(logits, dim=-1)
    if scales is not None:
        probs = probs * scales[1][b_idx, :, flat].permute(0, 1, 3, 2)
    out = torch.einsum("bnhl,bnlhd->bnhd", probs.to(BF16).float(), rows(1))
    return out.to(BF16).reshape(batch * beams, d_model)


def _check_cache_operands(name, q, cache, ancestry, num_heads, scales):
    """The checks both select-attention wrappers make on the cache, the
    ancestry slice (the stage) and the int8 scales (and that q is a CUDA
    tensor)."""
    require = _cuda.require
    require(q.is_cuda, f"{name}: unsupported device {q.device}")
    two, batch, flat, d_model = cache.shape
    _, beams, length = ancestry.shape
    quantized = scales is not None
    require(cache.dtype == (torch.int8 if quantized else BF16),
            f"{name}: int8 cache needs scales, bf16 cache none")
    require(beam_kernel_supports(beams, d_model, num_heads),
            f"{name}: unsupported shape K={beams} D={d_model} H={num_heads}")
    require(two == 2 and ancestry.shape[0] == batch and 1 <= length
            and length * beams <= min(flat, 65536), f"{name}: stage longer than the cache")
    require(ancestry.dtype == torch.int32 and ancestry.stride(2) == 1
            and ancestry.stride(0) == beams * ancestry.stride(1),
            f"{name}: ancestry must be int32 rows with unit stride")
    if quantized:
        require(scales.dtype == torch.float32 and scales.shape[:3] == (2, batch, num_heads)
                and scales.shape[3] >= length * beams and scales.is_contiguous(),
                f"{name}: scales must be contiguous (2, B, H, F) fp32")


def _device_position(name, position, device) -> torch.Tensor:
    """The step index as the kernel reads it: a 0-d int32 tensor on the
    operands' device (an int becomes one, by a fill on the device, which a
    CUDA graph can capture). The kernel checks it against the stage."""
    if isinstance(position, torch.Tensor):
        _cuda.require(position.dim() == 0 and position.dtype == torch.int32
                      and position.device == device,
                      f"{name}: position must be an int or a 0-d int32 tensor on {device}")
        return position
    return torch.full((), int(position), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _workspace_bytes(kind: int, batch: int, beams: int, heads: int, head_dim: int,
                     length: int) -> int:
    """Bytes of global workspace the select kernel's plan needs for this
    stage (0 unless its per-time tables spill out of shared memory)."""
    nbytes = _cuda.library().mmt_beam_select_workspace_bytes(kind, batch, beams, heads,
                                                             head_dim, length)
    _cuda.require(nbytes >= 0, f"beam select attention: no plan for K={beams} "
                               f"head_dim={head_dim} L={length}")
    return nbytes


def _workspace(kind, batch, beams, heads, head_dim, length, device) -> Optional[torch.Tensor]:
    nbytes = _workspace_bytes(kind, batch, beams, heads, head_dim, length)
    return torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes else None


def beam_select_attention_update(
    q: torch.Tensor,             # (B*K, D) bf16 queries (post q-projection)
    k_new: torch.Tensor,         # (B*K, D) this step's K rows: bf16 for a bf16 cache;
    v_new: torch.Tensor,         #   bf16 or fp32 for an int8 cache (quantized here)
    cache: torch.Tensor,         # (2, B, L_max*K, D) int8 | bf16, updated in place
    ancestry: torch.Tensor,      # (B, K, L) int32 stage slice, L <= L_max
    position,                    # step index < L: int, or 0-d int32 tensor on q's device
    num_heads: int,
    scales: Optional[torch.Tensor] = None,   # (2, B, H, F_pad) fp32, int8 cache
) -> torch.Tensor:
    """Lazy-ancestry beam self-attention with the in-place cache append;
    with an int8 cache the fresh rows are quantized per (row, head) as
    :func:`quantize_kv_heads` does, and rows and scales stored in place.

    The kernel reads ``position`` from device memory and is planned for the
    stage (``ancestry.shape[2]``), so a CUDA graph of a decode step serves
    every step of its stage. Returns the (B*K, D) bf16 attention output
    (pre out-projection). ``beam_select_attention_update.launches`` counts
    kernel launches.
    """
    if q.device.type == "cpu":
        return beam_select_attention_update_plain(
            q, k_new, v_new, cache, ancestry, position, num_heads, scales)
    require = _cuda.require
    name = "beam_select_attention_update"
    _check_cache_operands(name, q, cache, ancestry, num_heads, scales)
    _, batch, flat, d_model = cache.shape
    beams, length = ancestry.shape[1:]
    head_dim = d_model // num_heads
    quantized = scales is not None
    require(q.dtype == BF16 and q.shape == (batch * beams, d_model),
            f"{name}: q must be (B*K, D) bf16")
    fresh_types = (BF16, torch.float32) if quantized else (BF16,)
    require(k_new.dtype in fresh_types and v_new.dtype == k_new.dtype
            and k_new.shape == q.shape and v_new.shape == q.shape,
            f"{name}: fresh rows must be (B*K, D) bf16 (or fp32 for an int8 cache)")
    tensors = [q, k_new, v_new, cache, ancestry] + ([scales] if quantized else [])
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    require(all(t.is_cuda and t.device == q.device for t in tensors)
            and cache.is_contiguous()
            and all(t.data_ptr() % 16 == 0 for t in (q, k_new, v_new, cache)),
            f"{name}: operands must be contiguous, 16-byte aligned and on one device")
    pos = _device_position(name, position, q.device)
    kind = 0 if not quantized else 1 if k_new.dtype == BF16 else 2
    workspace = _workspace(kind, batch, beams, num_heads, head_dim, length, q.device)
    out = torch.empty_like(q)
    lib = _cuda.library()
    _cuda.check(lib.mmt_beam_select_attention_update(
        kind, _cuda.ptr(q), _cuda.ptr(k_new), _cuda.ptr(v_new), _cuda.ptr(cache),
        _cuda.ptr(scales), _cuda.ptr(ancestry), _cuda.ptr(out), _cuda.ptr(workspace), batch,
        beams, num_heads, head_dim, flat, scales.shape[3] if quantized else 0,
        ancestry.stride(1), _cuda.ptr(pos), length, head_dim ** -0.5, _cuda.stream()), name)
    beam_select_attention_update.launches += 1
    return out


_cuda.count_launches(beam_select_attention_update)


def beam_select_attention_plain(q, cache, ancestry, position, num_heads,
                                scales=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`beam_select_attention`."""
    batch, beams = ancestry.shape[:2]
    pos = int(position)
    out = _attend_plain(q.reshape(batch * beams, -1), cache,
                        ancestry[:, :, : pos + 1].long(), num_heads, scales)
    return out.reshape(batch, beams, -1)


def beam_select_attention(
    q: torch.Tensor,          # (B, K, D) bf16 queries (post q-projection)
    cache: torch.Tensor,      # (2, B, L_max*K, D) int8 | bf16, rows for `position` present
    ancestry: torch.Tensor,   # (B, K, L) int32 stage slice, L <= L_max
    position,                 # step index < L: int, or 0-d int32 tensor on q's device
    num_heads: int,
    scales: Optional[torch.Tensor] = None,   # (2, B, H, F) fp32, int8 cache, F >= L*K
) -> torch.Tensor:
    """Read-only lazy-ancestry beam self-attention; returns (B, K, D) bf16
    (pre out-projection) and writes nothing else. ``position`` and the
    stage as :func:`beam_select_attention_update` takes them.
    ``beam_select_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return beam_select_attention_plain(q, cache, ancestry, position, num_heads, scales)
    require = _cuda.require
    name = "beam_select_attention"
    _check_cache_operands(name, q, cache, ancestry, num_heads, scales)
    _, batch, flat, d_model = cache.shape
    beams, length = ancestry.shape[1:]
    head_dim = d_model // num_heads
    quantized = scales is not None
    require(q.dtype == BF16 and q.shape == (batch, beams, d_model),
            f"{name}: q must be (B, K, D) bf16")
    q = q.contiguous()
    require(all(t.is_cuda and t.device == q.device
                for t in (cache, ancestry) + ((scales,) if quantized else ()))
            and cache.is_contiguous() and q.data_ptr() % 16 == 0 and cache.data_ptr() % 16 == 0,
            f"{name}: operands must be contiguous, 16-byte aligned and on one device")
    pos = _device_position(name, position, q.device)
    workspace = _workspace(4 if quantized else 3, batch, beams, num_heads, head_dim, length,
                           q.device)
    out = torch.empty_like(q)
    lib = _cuda.library()
    _cuda.check(lib.mmt_beam_select_attention(
        int(quantized), _cuda.ptr(q), _cuda.ptr(cache), _cuda.ptr(scales), _cuda.ptr(ancestry),
        _cuda.ptr(out), _cuda.ptr(workspace), batch, beams, num_heads, head_dim, flat,
        scales.shape[3] if quantized else 0, ancestry.stride(1), _cuda.ptr(pos), length,
        head_dim ** -0.5, _cuda.stream()), name)
    beam_select_attention.launches += 1
    return out


_cuda.count_launches(beam_select_attention)


def beam_cross_attention_plain(q, k, v, bias, num_heads, beams) -> torch.Tensor:
    """Plain PyTorch version of :func:`beam_cross_attention`."""
    batch, ls, d_model = k.shape
    head_dim = d_model // num_heads
    mm = k.dtype
    qh = (q.float() * head_dim ** -0.5).to(mm).float().reshape(
        batch, beams, num_heads, head_dim)
    kh = k.float().reshape(batch, ls, num_heads, head_dim)
    vh = v.float().reshape(batch, ls, num_heads, head_dim)
    logits = torch.einsum("bnhd,blhd->bnhl", qh, kh) + bias.float()[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(mm).float()
    out = torch.einsum("bnhl,blhd->bnhd", probs, vh)
    return out.to(q.dtype).reshape(batch * beams, d_model)


# The cross kernels' forms, by the C plan's number for each.
CROSS_FORMS = ("one_pass", "cluster", "split", "stream")


@dataclasses.dataclass(frozen=True)
class CrossPlan:
    """How the cross kernels take an encoder of Ls keys (the C side's
    cross_plan): ``form`` one of :data:`CROSS_FORMS`, in tiles of
    ``tile_keys`` keys, a block each (``tile_keys`` >= Ls rounded to 16:
    the one-pass form; the stream form's tile is the keys of a rank), and
    the bytes of workspace the split form needs (0 for the other three)."""
    form: str
    tile_keys: int
    workspace_bytes: int


@functools.lru_cache(maxsize=None)
def cross_plan(batch: int, beams: int, heads: int, head_dim: int, ls: int, elt: int) -> CrossPlan:
    """The plan for K beams against (B, Ls) encoder rows of ``heads`` heads
    of ``head_dim`` in ``elt``-byte elements (2 bf16, 4 fp32)."""
    form, nbytes = ctypes.c_int(), ctypes.c_longlong()
    tile_keys = _cuda.library().mmt_beam_cross_plan(int(elt == 2), batch, beams, heads,
                                                    head_dim, ls, ctypes.byref(form),
                                                    ctypes.byref(nbytes))
    _cuda.require(tile_keys > 0, f"beam_cross_attention: no plan for K={beams} "
                                 f"head_dim={head_dim} Ls={ls}")
    return CrossPlan(CROSS_FORMS[form.value], tile_keys, nbytes.value)


def beam_cross_attention(
    q: torch.Tensor,      # (B*K, D) post q-projection, in the K/V dtype
    k: torch.Tensor,      # (B, Ls, D) encoder K (beam-invariant)
    v: torch.Tensor,      # (B, Ls, D) encoder V
    bias: torch.Tensor,   # (B, Ls) fp32 additive padding bias
    num_heads: int,
    beams: int,
) -> torch.Tensor:
    """Beam cross-attention; returns (B*K, D) in q's dtype (pre out-projection).

    Products run in the K/V storage dtype (bf16, or fp32 for fp32 models);
    :func:`cross_plan` picks the one-pass, the cluster, the stream or the
    split form, whose workspace is a ``torch.empty`` here, so that a
    captured graph holds it. ``beam_cross_attention.launches`` counts wrapper calls that
    launch (the split form's two launches count once);
    ``beam_cross_attention.forms`` counts them by form, where ``launches``
    is counted, but as plain calls: a CUDA graph's capture counts, its
    replays do not.
    """
    if q.device.type == "cpu":
        return beam_cross_attention_plain(q, k, v, bias, num_heads, beams)
    require = _cuda.require
    require(q.is_cuda, f"beam_cross_attention: unsupported device {q.device}")
    batch, ls, d_model = k.shape
    require(k.dtype in (BF16, torch.float32) and q.dtype == k.dtype == v.dtype,
            "beam_cross_attention: q, k and v must share one dtype, bf16 or fp32")
    require(beam_kernel_supports(beams, d_model, num_heads),
            f"beam_cross_attention: unsupported shape K={beams} D={d_model} H={num_heads}")
    require(q.shape == (batch * beams, d_model) and v.shape == k.shape
            and bias.shape == (batch, ls) and bias.dtype == torch.float32,
            "beam_cross_attention: shapes must be q (B*K, D), k/v (B, Ls, D), bias (B, Ls)")
    q, k, v, bias = q.contiguous(), k.contiguous(), v.contiguous(), bias.contiguous()
    require(all(t.is_cuda and t.device == q.device and t.data_ptr() % 16 == 0
                for t in (q, k, v, bias)),
            "beam_cross_attention: operands must be 16-byte aligned on one device")
    head_dim = d_model // num_heads
    plan = cross_plan(batch, beams, num_heads, head_dim, ls, k.element_size())
    workspace = (torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=q.device)
                 if plan.workspace_bytes else None)
    out = torch.empty_like(q)
    _cuda.check(_cuda.library().mmt_beam_cross_attention(
        int(q.dtype == BF16), _cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(bias),
        _cuda.ptr(out), _cuda.ptr(workspace), plan.workspace_bytes, batch, beams, num_heads,
        head_dim, ls, head_dim ** -0.5, _cuda.stream()), "beam_cross_attention")
    beam_cross_attention.launches += 1
    beam_cross_attention.forms[plan.form] += 1
    return out


_cuda.count_launches(beam_cross_attention)
beam_cross_attention.forms = dict.fromkeys(CROSS_FORMS, 0)
