"""Decode-step feed-forward: hand-written CUDA kernel and its plain version.

Counterpart of ``multimodalanalytical_tpu/ops/decode_ffn.py`` (Pallas
``_ffn_kernel``). The kernel is ``csrc/decode_ffn.cu``: two pipelined,
persistent wgmma GEMMs with TMA loads, the up product with the bias,
exact-erf GELU and optional gate in its epilogue, writing a bf16 (M, F)
activation, and the down product split over F into fp32 partials that a
reduction adds in split order before the bias (:func:`ffn_plan` sets the
splits, the tile widths and the ping-pong). The source note there
says what bounds it on the H100.

Numerics (both versions): every product accumulates in fp32 and rounds to
bf16, every bias add rounds to bf16 (flax ``Dense(dtype=bfloat16)``), and
GELU runs in fp32 on the bf16 value. CUDA's ``erff`` stands in for the
Cephes rational the TPU kernel uses; the difference vanishes in the bf16
rounding. A split down product adds its fp32 partials in a fixed order,
so reruns give the same bits.

Partial mode (``partial=True``, tensor parallelism: the caller holds F / n
columns of W1 and the gate, and the matching rows of W2): the result is the
fp32 (M, D) down product over this F without b2 and without rounding; the
caller sums it over the ranks, then rounds to bf16, adds b2 and rounds,
where the full mode rounds.

Dispatch: a CPU tensor takes :func:`geglu_ffn_plain`; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _cuda

BF16 = torch.bfloat16
# Tiles of csrc/decode_ffn.cu: 64 output rows per tile (one wgmma warpgroup),
# 64-deep stages of K, 64-wide tiles in the up GEMM.
TILE_M, STAGE_K, UP_TILE_N = 64, 64, 64


class FfnPlan(NamedTuple):
    up_groups: int      # consumer warpgroups per up-GEMM block: 2 takes turns (ping-pong)
    down_tile_n: int    # columns of a down-GEMM tile: 64 or 128
    splits: int         # splits of F in the down GEMM


def ffn_plan(m: int, d: int, f: int, sms: int) -> FfnPlan:
    """How the kernel runs (M, D) x (D, F) -> (M, F) x (F, D) on ``sms`` SMs.

    * The up GEMM's blocks take two 64 x 64 tiles at a time, one per
      consumer warpgroup, so that one's GELU epilogue overlaps the other's
      products, once there are at least two tiles per SM; below that, one.
    * The down GEMM takes 64 x 128 tiles, or 64 x 64 when the wide tiles
      would not give every second SM one, and splits F so that its tiles
      times the splits give at least one block per SM, at most one split
      per 64-deep stage of F.
    """
    m_tiles = -(-m // TILE_M)
    up_groups = 2 if m_tiles * -(-f // UP_TILE_N) >= 2 * sms else 1
    down_tile_n = 128 if 2 * m_tiles * -(-d // 128) >= sms else 64
    tiles = m_tiles * -(-d // down_tile_n)
    return FfnPlan(up_groups, down_tile_n, max(1, min(-(-f // STAGE_K), -(-sms // tiles))))


def split_stages(f: int, splits: int) -> List[Tuple[int, int]]:
    """The [first, last) 64-deep stages of F that each split takes, as the
    kernel computes them: split z of S takes [z T / S, (z + 1) T / S) of
    T = ceil(F / 64)."""
    stages = -(-f // STAGE_K)
    return [(z * stages // splits, (z + 1) * stages // splits) for z in range(splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def geglu_ffn_plain(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    wg: Optional[torch.Tensor],
    bg: Optional[torch.Tensor],
    w2: torch.Tensor,
    b2: Optional[torch.Tensor],
    partial: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version; weights in Linear layout (out, in)."""
    x = x.to(BF16)
    h = (x @ w1.to(BF16).t()) + b1.to(BF16)
    act = F.gelu(h.float()).to(BF16)
    if wg is not None:
        act = act * ((x @ wg.to(BF16).t()) + bg.to(BF16))
    if partial:
        return act.float() @ w2.to(BF16).float().t()
    return (act @ w2.to(BF16).t()) + b2.to(BF16)


def geglu_ffn(
    x: torch.Tensor,               # (M, D)
    w1: torch.Tensor,              # (F, D)
    b1: torch.Tensor,              # (F,)
    wg: Optional[torch.Tensor],    # (F, D) | None (ungated)
    bg: Optional[torch.Tensor],    # (F,)   | None
    w2: torch.Tensor,              # (D, F)
    b2: Optional[torch.Tensor],    # (D,) | None (partial mode)
    partial: bool = False,
) -> torch.Tensor:
    """Fused (optionally gated) GELU FFN; returns (M, D) bf16, or in partial
    mode the (M, D) fp32 down product without b2.

    ``geglu_ffn.launches`` counts the calls that launched the kernel (one
    per call: the up, down and reduction launches of one call count once).
    """
    if x.device.type == "cpu":
        return geglu_ffn_plain(x, w1, b1, wg, bg, w2, b2, partial)
    return _launch(x, w1, b1, wg, bg, w2, b2, partial=partial)


def _launch(x, w1, b1, wg, bg, w2, b2, plan: Optional[FfnPlan] = None,
            partial: bool = False) -> torch.Tensor:
    """The kernel on CUDA tensors, run as ``plan`` says (:func:`ffn_plan`'s
    unless given)."""
    _cuda.require(x.is_cuda, f"geglu_ffn: unsupported device {x.device}")
    m, d = x.shape
    f = w1.shape[0]
    gated = wg is not None
    ops = [t.to(BF16).contiguous() if t is not None else None
           for t in (x, w1, b1, wg, bg, w2, b2)]
    x, w1, b1, wg, bg, w2, b2 = ops
    _cuda.require(m >= 1 and d % 8 == 0 and f % 8 == 0,
                  f"geglu_ffn: {m} rows; d_model {d} and ffn_dim {f} must be multiples of 8")
    _cuda.require(w1.shape == (f, d) and w2.shape == (d, f)
                  and b1.shape == (f,) and (partial or b2.shape == (d,))
                  and (not gated or (wg.shape == (f, d) and bg.shape == (f,))),
                  "geglu_ffn: weight shapes do not match x")
    _cuda.require(all(t.is_cuda and t.device == x.device and t.data_ptr() % 16 == 0
                      for t in ops if t is not None),
                  "geglu_ffn: operands must be 16-byte aligned on x's device")
    sms = _sm_count(x.device)
    plan = plan or ffn_plan(m, d, f, sms)
    _cuda.require(1 <= plan.splits <= -(-f // STAGE_K),
                  f"geglu_ffn: {plan.splits} splits of ffn_dim {f}")
    hidden = torch.empty((m, f), dtype=BF16, device=x.device)
    workspace = (torch.empty((plan.splits, m, d), dtype=torch.float32, device=x.device)
                 if plan.splits > 1 else None)
    out = torch.empty((m, d), dtype=torch.float32 if partial else BF16, device=x.device)
    lib = _cuda.library()
    _cuda.check(lib.mmt_geglu_ffn(
        _cuda.ptr(x), _cuda.ptr(w1), _cuda.ptr(b1), _cuda.ptr(wg), _cuda.ptr(bg),
        _cuda.ptr(w2), _cuda.ptr(None if partial else b2), _cuda.ptr(hidden),
        _cuda.ptr(workspace), _cuda.ptr(out), m, d, f, *plan, int(partial), sms,
        _cuda.stream()), "geglu_ffn")
    geglu_ffn.launches += 1
    return out


_cuda.count_launches(geglu_ffn)
