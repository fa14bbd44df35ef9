#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port's serving, training and evaluation paths.

    python3 chip_smoke.py                  # the checks below
    python3 chip_smoke.py --profile-eval   # phase 5's decodes under torch.profiler
    python3 chip_smoke.py --profile-train  # phase 3's train step under torch.profiler

Needs one CUDA device (an H100: the kernels are built for sm_90a), ``nvcc``
and ``g++``; it imports torch, numpy, the standard library and
``multimodalanalytical_tpu_torch``, never JAX. (The port's scoring reaches
its copy of the chemistry binding, which builds the repository's
framework-free engine, ``csrc/chem``, with g++ at first use.) Phases, one
line each, any failure raises and exits non-zero:

0. device and build: the card's name and power limit, and the time to
   compile the package's CUDA kernels from ``csrc/``;
1. each kernel against its plain PyTorch version, with both times, its
   bound (the larger of its operations over the bf16 tensor-core peak and
   its bytes over the HBM rate, from this run's inputs) and, where one
   PyTorch call computes the same function, that call's time: the
   decode kernels at the flagship decode shapes (B 128, D 512, H 8, F 2048,
   Ls 26) at each beam count an entry point runs: serving's K 10 (int8 and
   bf16 caches), validation's K 1 (bf16) and predict's K 30 (int8), the
   FFN at M 128, 1280 and 3840; the read-only select attention at B 128,
   L 128, pos 127, K 10 and 30, int8 and bf16 caches; fused dropout (rate
   0.1, bf16) at the train-site shapes (128, 48, 512), (128, 48, 2048) and
   (8, 4090, 512), bit for bit, forward and backward (also against
   ``ops/dropout.py``'s time); the flash attention forward and backward at
   the long RLE encoder's (B 8, H 8, L 4090 padded to 4096, head_dim 64,
   bf16, ragged key masks) and at head_dim 128 (B 8, H 4), two backward
   calls bit-equal, the check shown to reject the kernels with one key
   stage left out, timed in turns with
   ``scaled_dot_product_attention`` (the yardstick; the port never calls
   it), whose backend's kernels are printed;
2. serving: the flagship CustomModel (6 + 6 layers, bf16, int8 KV cache,
   seeded random weights) decodes 8 teacher-forced steps through the
   kernels and through ``use_beam_kernel=False`` at K 1, 10 and 30 (logits
   within LOGIT_TOL), then answers three seeded 128-spectrum requests
   (Formula 12 tokens + IR 14 x 125) through ``InferenceEngine.decode_batch``
   at beam 10 and max length 128. Every decode kernel's launch count must
   equal 6 x the decode steps run. The same requests then run with
   ``use_beam_kernel=False`` for the time and top-1 agreement;
3. training, long sequences: the flagship-width model on one run-length-
   encoded IR source (vocabulary 105, rows of 2173-4090 tokens padded to
   4090) -> SMILES (vocab 320, up to 128 tokens), B 8, seeded weights and
   batch. One dropout-0 step of the flash route against the
   ``use_flash_attention=False`` route (loss and gradient norm), then
   ``Trainer.fit`` takes 10 AdamW steps (dropout 0.1, clip 1.0) on the
   repeated batch: every loss finite, the last below the first, and each
   flash kernel launched 6 x the steps; then the same fit with every
   dropout site routed through fused dropout (this script's substitution,
   as ``benchmarks/exp_remat.py`` routes the JAX sites), with its s/step
   and peak memory beside the default route's;
4. training, the flagship IR recipe (Formula + IR patches, B 128): three
   AdamW steps, finite losses, no flash launch;
5. evaluation: the flagship model, 640 seeded spectra (384 train, 128
   validation, 128 test, real SMILES targets, a fixed-vocabulary stand-in
   for the target tokenizer: the card's machine has no ``tokenizers``).
   ``Trainer.fit`` takes 2 epochs (6 AdamW steps at B 128) with validation
   (greedy K 1 decode) every epoch and a ``CheckpointManager``; ``best`` is
   restored into a fresh model bit for bit; ``predict`` decodes the test
   spectra at beam 30, scored with rejection sampling off and on (the
   mixture paper's Table 4 recipe). Every decode kernel's launches must
   equal 6 x the decode steps of validation and predict.

The last two lines are the per-kernel JSON record and the device record.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
BATCH, BEAMS, D_MODEL, HEADS, FFN, LAYERS = 128, 10, 512, 8, 2048, 6
MAX_LENGTH = 128
FORMULA_LEN, N_PATCHES, PATCH = 12, 14, 125
VOCAB = 320
ATTN_TOL = 2e-2      # max|kernel - plain| <= ATTN_TOL * max(1, max|plain|)
FFN_REL_TOL = 0.02   # max|kernel - plain| / max|plain|
# Teacher-forced decode logits, kernel path vs the use_beam_kernel=False
# path on the same weights: the two differ only in bf16 rounding order
# inside attention, carried through 6 layers.
LOGIT_TOL = 5e-2
# Flash kernels vs their plain versions (fp32 math, one rounding): the bf16
# kernels also round P and dS to bf16 as tensor-core operands, which
# tests/test_torch_flash_numerics.py holds within these limits against the
# Pallas kernels. Each of out, dq, dk, dv: max|kernel - plain| <= FLASH_TOL *
# max|plain| and |kernel - plain|_2 <= FLASH_RMS_TOL * |plain|_2 (a typical
# value is ~10x below the peak, so the norm is what catches a skipped or
# misweighted key stage); lse is fp32 in both, elementwise relative.
FLASH_TOL = 2e-2
FLASH_RMS_TOL = 1e-2
LSE_REL_TOL = 1e-5
# Keys per stage of the bf16 forward kernel, by head_dim (Layout<HD>::kKeys
# in csrc/flash_attention.cu).
FLASH_KEY_STAGE = {64: 128, 128: 64}
# The long-sequence training slice (phase 3).
TRAIN_BATCH, TRAIN_STEPS, TARGET_LEN = 8, 10, 128
TRAIN_LR = 1e-4      # configs/model/custom_model.yaml: adamw, lr 1e-4, weight decay 0
RLE_MAX_LEN = 4090   # RunLengthEncodingPreprocessor caps sequences at 4090 tokens
RLE_MIN_LEN = 2173   # longest RLE row of tests/test_data/ir_dataset at native resolution
# Vocabulary of RunLengthEncodingPreprocessor fitted on tests/test_data/ir_dataset
# (20 spectra, 1791 points) at spectrum_tokens_x 400, 1791 and 4000 alike.
RLE_VOCAB = 105
# Flash route vs use_flash_attention=False on one dropout-0 step: the plain
# route rounds q*scale and the probabilities to bf16, the flash route keeps
# fp32 (as the JAX package does), through 6 + 6 bf16 layers.
ROUTE_LOSS_RTOL, ROUTE_GRAD_NORM_RTOL = 1e-2, 2e-2
IR_RECIPE_BATCH, IR_RECIPE_STEPS = 128, 3
# Fused dropout (#7): the model's rate at the JAX docstring's train-site
# shapes (FFN output and hidden at B 128, 48 tokens) and the RLE encoder's.
DROPOUT = 0.1
DROPOUT_SHAPES = [(128, 48, 512), (128, 48, 2048), (TRAIN_BATCH, RLE_MAX_LEN, 512)]
# The evaluation path (phase 5): the mixture paper's Table 4 predict recipe
# decodes at beam 30.
EVAL_BEAMS = 30
# The decode kernels at every beam count an entry point runs, each with the
# self-attention caches it takes there: serving's K 10 (int8, and bf16 as a
# model with kv_cache_dtype bfloat16 has it), validation's greedy K 1 (bf16:
# the int8 decision needs K >= 4) and predict's K 30 (int8).
DECODE_BEAMS = ((BEAMS, ("int8", "bf16")), (1, ("bf16",)), (EVAL_BEAMS, ("int8",)))

DATA_CONFIG = {
    "Formula": {"type": "text", "column": "molecular_formula", "target": False,
                "vocab_size": 32, "pad_token_id": 0, "preprocessor_arguments": {}},
    "IR": {"type": "1D_patches", "column": "ir_spectra", "target": False,
           "preprocessor_arguments": {"patch_size": PATCH}},
    "Smiles": {"type": "text", "column": "smiles", "target": True,
               "vocab_size": VOCAB, "pad_token_id": 0, "preprocessor_arguments": {}},
}
RLE_DATA_CONFIG = {
    "RLE": {"type": "run_length_encoding", "column": "ir_spectra", "target": False,
            "vocab_size": RLE_VOCAB, "pad_token_id": 0, "preprocessor_arguments": {}},
    "Smiles": DATA_CONFIG["Smiles"],
}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events over `iters` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# Published H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores
# and HBM3. A kernel's bound is the larger of its operations over the first
# and its bytes (each input read once, each output written once) over the
# second.
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12


def _bound_ms(flops: float, nbytes: float) -> tuple:
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _select_bytes(anc, pos: int, quantized: bool, update: bool) -> int:
    """Bytes the select attention must move at this ancestry: the distinct
    cache rows (K and V planes, with their int8 scales) that the beams'
    slots select at times 0..pos, q, the ancestry, the output, and for the
    update the appended rows (and scales) of time pos."""
    import torch

    batch, beams, _ = anc.shape
    slot = anc[:, :, : pos + 1].long().clone()
    if update:
        slot[:, :, pos] = torch.arange(beams, device=anc.device)
    # distinct beams selected at each (row, time)
    present = torch.zeros(batch, pos + 1, beams, dtype=torch.bool, device=anc.device)
    present.scatter_(2, slot.permute(0, 2, 1), True)
    rows = int(present.sum())
    row_bytes = D_MODEL * (1 if quantized else 2) + (HEADS * 4 if quantized else 0)
    qo = 2 * batch * beams * D_MODEL * 2
    fresh = 2 * batch * beams * row_bytes if update else 0
    return 2 * rows * row_bytes + qo + anc[:, :, : pos + 1].numel() * 4 + fresh


def _attn_err(got, want) -> tuple:
    err = (got.float() - want.float()).abs().max().item()
    tol = ATTN_TOL * max(1.0, want.float().abs().max().item())
    return err, tol


# ---------------------------------------------------------------- phase 1
def check_kernels() -> list:
    """Each decode kernel vs its plain version at the flagship widths and at
    every beam count the entry points run (DECODE_BEAMS); returns records,
    timed at serving's K 10 as in earlier runs, the other times beside."""
    import torch
    import torch.nn.functional as F

    from multimodalanalytical_tpu_torch.ops import beam_attention as ba
    from multimodalanalytical_tpu_torch.ops import decode_ffn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    records = []

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def randint8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def rand_scales(*shape):
        return torch.rand(*shape, generator=g, device=dev) * 0.05 + 1e-3

    # #1 self-attention + in-place append.
    worst, timing, bounds = 0.0, {}, {}
    for beams, kinds in DECODE_BEAMS:
        bk, flat_max = BATCH * beams, MAX_LENGTH * beams
        q = randn(bk, D_MODEL)
        anc_full = torch.randint(0, beams, (BATCH, beams, MAX_LENGTH), generator=g,
                                 device=dev, dtype=torch.int32)
        for kind in kinds:
            quantized = kind == "int8"
            if quantized:
                cache0, scales0 = randint8(2, BATCH, flat_max, D_MODEL), rand_scales(
                    2, BATCH, HEADS, flat_max)
                k_new, v_new = randint8(bk, D_MODEL), randint8(bk, D_MODEL)
                k_s, v_s = rand_scales(bk, HEADS), rand_scales(bk, HEADS)
            else:
                cache0, scales0 = randn(2, BATCH, flat_max, D_MODEL), None
                k_new, v_new, k_s, v_s = randn(bk, D_MODEL), randn(bk, D_MODEL), None, None
            for stage in (32, 128):
                for pos in (0, 17, stage - 1):
                    anc_full[:, :, pos] = torch.arange(beams, device=dev, dtype=torch.int32)
                    anc = anc_full[:, :, :stage]
                    outs, stores = [], []
                    for fn in (ba.beam_select_attention_update,
                               ba.beam_select_attention_update_plain):
                        cache = cache0.clone()
                        scales = scales0.clone() if quantized else None
                        outs.append(fn(q, k_new, v_new, cache, anc, pos, HEADS, scales, k_s, v_s))
                        stores.append((cache, scales))
                    torch.cuda.synchronize()
                    err, tol = _attn_err(outs[0], outs[1])
                    rows_equal = torch.equal(stores[0][0], stores[1][0]) and (
                        not quantized or torch.equal(stores[0][1], stores[1][1]))
                    print(f"kernel beam_select_attention_update {kind} K={beams} L={stage} "
                          f"pos={pos}: max_abs_err={err:.3e} tol={tol:.3e} "
                          f"cache_rows_equal={rows_equal}", flush=True)
                    _require(err <= tol,
                             "beam_select_attention_update disagrees with its plain version")
                    _require(rows_equal, "beam_select_attention_update appended other rows/scales")
                    worst = max(worst, err)
                    del outs, stores
                    if pos == stage - 1:
                        cache, scales = cache0.clone(), scales0.clone() if quantized else None
                        args = (q, k_new, v_new, cache, anc, pos, HEADS, scales, k_s, v_s)
                        ms = _time_ms(lambda: ba.beam_select_attention_update(*args))
                        plain_ms = _time_ms(lambda: ba.beam_select_attention_update_plain(*args))
                        timing[f"{kind} K={beams} L={stage}"] = (ms, plain_ms)
                        bound = _bound_ms(4 * BATCH * beams * (pos + 1) * D_MODEL,
                                          _select_bytes(anc, pos, quantized, update=True))
                        bounds[f"{kind} K={beams} L={stage}"] = bound
                        print(f"time beam_select_attention_update {kind} K={beams} L={stage} "
                              f"pos={pos}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                              f"{bound[0]:.4f} ms ({bound[1]})", flush=True)
                        del cache, scales, args
            del cache0, scales0
    ms, plain_ms = timing[f"int8 K={BEAMS} L=128"]
    bound, bound_by = bounds[f"int8 K={BEAMS} L=128"]
    records.append({"name": "beam_select_attention_update", "route": "cuda",
                    "source": "multimodalanalytical_tpu_torch/csrc/beam_attention.cu",
                    "replaces": "multimodalanalytical_tpu/ops/beam_attention.py:570",
                    "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
                    "other_bounds_ms": {k: v[0] for k, v in bounds.items()},
                    "timed_at": f"int8 cache, K={BEAMS}, L=128, pos=127",
                    "other_times_ms": {k: list(v) for k, v in timing.items()}})

    # #2 cross-attention with padded keys (row 0 fully masked, as batch
    # padding rows are).
    ls = FORMULA_LEN + N_PATCHES
    kx, vx = randn(BATCH, ls, D_MODEL), randn(BATCH, ls, D_MODEL)
    valid = torch.randint(ls - 8, ls + 1, (BATCH, 1), generator=g, device=dev)
    keep = torch.arange(ls, device=dev)[None, :] < valid
    keep[0] = False
    bias = torch.where(keep, 0.0, -1e9).float()
    worst, timing, bounds = 0.0, {}, {}
    for beams, _ in DECODE_BEAMS:
        qx = randn(BATCH * beams, D_MODEL)
        got = ba.beam_cross_attention(qx, kx, vx, bias, HEADS, beams)
        want = ba.beam_cross_attention_plain(qx, kx, vx, bias, HEADS, beams)
        err, tol = _attn_err(got, want)
        ms = _time_ms(lambda: ba.beam_cross_attention(qx, kx, vx, bias, HEADS, beams))
        plain_ms = _time_ms(lambda: ba.beam_cross_attention_plain(qx, kx, vx, bias, HEADS, beams))
        # SDPA on the same inputs (yardstick only): beams as query rows of
        # their batch row, the key bias as an additive mask.
        qh = qx.reshape(BATCH, beams, HEADS, -1).transpose(1, 2)
        kh, vh = (t.reshape(BATCH, ls, HEADS, -1).transpose(1, 2) for t in (kx, vx))
        mask = bias[:, None, None, :].to(qx.dtype)
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
        bounds[f"K={beams}"] = _bound_ms(
            4 * BATCH * beams * ls * D_MODEL,
            (2 * BATCH * beams + 2 * BATCH * ls) * D_MODEL * 2 + bias.numel() * 4)
        timing[f"K={beams}"] = (ms, plain_ms, library_ms)
        print(f"kernel beam_cross_attention K={beams} Ls={ls}: max_abs_err={err:.3e} "
              f"tol={tol:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"{library_ms:.4f} ms, bound {bounds[f'K={beams}'][0]:.5f} ms "
              f"({bounds[f'K={beams}'][1]})", flush=True)
        _require(bool(torch.isfinite(got.float()).all()) and err <= tol,
                 "beam_cross_attention disagrees with its plain version")
        worst = max(worst, err)
    ms, plain_ms, library_ms = timing[f"K={BEAMS}"]
    records.append({"name": "beam_cross_attention", "route": "cuda",
                    "source": "multimodalanalytical_tpu_torch/csrc/beam_attention.cu",
                    "replaces": "multimodalanalytical_tpu/ops/beam_attention.py:536",
                    "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bounds[f"K={BEAMS}"][0], "bound_by": bounds[f"K={BEAMS}"][1],
                    "library_ms": library_ms,
                    "library": "torch.nn.functional.scaled_dot_product_attention, additive mask",
                    "timed_at": f"K={BEAMS}, Ls={ls}",
                    "other_times_ms": {k: list(v) for k, v in timing.items()}})

    # #3 decode FFN, ungated (flagship) and gated, at M = B x K.
    w1, wg, w2 = randn(FFN, D_MODEL, scale=0.05), randn(FFN, D_MODEL, scale=0.05), randn(
        D_MODEL, FFN, scale=0.03)
    b1, bg, b2 = randn(FFN, scale=0.1), randn(FFN, scale=0.1), randn(D_MODEL, scale=0.1)
    worst, timing, bounds = 0.0, {}, {}
    for beams, _ in DECODE_BEAMS:
        m = BATCH * beams
        x = randn(m, D_MODEL)
        for gated in (False, True):
            args = (x, w1, b1, wg if gated else None, bg if gated else None, w2, b2)
            got = decode_ffn.geglu_ffn(*args)
            want = decode_ffn.geglu_ffn_plain(*args)
            err = (got.float() - want.float()).abs().max().item()
            rel = err / max(want.float().abs().max().item(), 1e-6)
            ms = _time_ms(lambda: decode_ffn.geglu_ffn(*args))
            plain_ms = _time_ms(lambda: decode_ffn.geglu_ffn_plain(*args))
            key = f"{'gated' if gated else 'ungated'} M={m}"
            timing[key] = (ms, plain_ms)
            weights = (3 if gated else 2) * FFN * D_MODEL
            bounds[key] = _bound_ms(2 * m * weights,
                                    (weights + (3 if gated else 2) * FFN + D_MODEL) * 2
                                    + 2 * m * D_MODEL * 2)
            print(f"kernel geglu_ffn gated={gated} M={m} D={D_MODEL} F={FFN}: "
                  f"max_abs_err={err:.3e} rel={rel:.3e} tol={FFN_REL_TOL}; kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms", flush=True)
            _require(bool(torch.isfinite(got.float()).all()) and rel <= FFN_REL_TOL,
                     "geglu_ffn disagrees with its plain version")
            worst = max(worst, err)
    ms, plain_ms = timing[f"ungated M={BATCH * BEAMS}"]
    bound, bound_by = bounds[f"ungated M={BATCH * BEAMS}"]
    records.append({"name": "geglu_ffn", "route": "cuda",
                    "source": "multimodalanalytical_tpu_torch/csrc/decode_ffn.cu",
                    "replaces": "multimodalanalytical_tpu/ops/decode_ffn.py:68",
                    "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
                    "other_bounds_ms": {k: v[0] for k, v in bounds.items()},
                    "timed_at": f"ungated, M={BATCH * BEAMS} D={D_MODEL} F={FFN}",
                    "other_times_ms": {k: list(v) for k, v in timing.items()}})
    return records


def check_read_only_attention() -> dict:
    """#4 the read-only select attention vs its plain version at B 128,
    L 128, pos 127, K 10 and 30, int8 and bf16 caches, with ancestry[:, :,
    pos] drawn at random; returns its record (launches: the checks')."""
    import torch

    from multimodalanalytical_tpu_torch.ops import beam_attention as ba

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    pos = MAX_LENGTH - 1
    worst, timing, bounds, launches = 0.0, {}, {}, 0
    for beams in (BEAMS, EVAL_BEAMS):
        flat = MAX_LENGTH * beams
        q = torch.randn(BATCH, beams, D_MODEL, generator=g, device=dev).bfloat16()
        anc = torch.randint(0, beams, (BATCH, beams, MAX_LENGTH), generator=g, device=dev,
                            dtype=torch.int32)
        for kind in ("int8", "bf16"):
            if kind == "int8":
                cache = torch.randint(-127, 128, (2, BATCH, flat, D_MODEL), generator=g,
                                      device=dev, dtype=torch.int8)
                scales = torch.rand(2, BATCH, HEADS, flat, generator=g, device=dev) * 0.05 + 1e-3
            else:
                cache = torch.randn(2, BATCH, flat, D_MODEL, generator=g, device=dev).bfloat16()
                scales = None
            args = (q, cache, anc, pos, HEADS, scales)
            before = ba.beam_select_attention.launches
            got = ba.beam_select_attention(*args)
            launches += ba.beam_select_attention.launches - before
            want = ba.beam_select_attention_plain(*args)
            torch.cuda.synchronize()
            err, tol = _attn_err(got, want)
            ms = _time_ms(lambda: ba.beam_select_attention(*args))
            plain_ms = _time_ms(lambda: ba.beam_select_attention_plain(*args), iters=5)
            timing[(kind, beams)] = (ms, plain_ms)
            bounds[(kind, beams)] = _bound_ms(4 * BATCH * beams * (pos + 1) * D_MODEL,
                                              _select_bytes(anc, pos, kind == "int8", False))
            print(f"kernel beam_select_attention {kind} K={beams} L={MAX_LENGTH} pos={pos}: "
                  f"max_abs_err={err:.3e} tol={tol:.3e}; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bounds[(kind, beams)][0]:.4f} ms "
                  f"({bounds[(kind, beams)][1]})", flush=True)
            _require(bool(torch.isfinite(got.float()).all()) and err <= tol,
                     "beam_select_attention disagrees with its plain version")
            worst = max(worst, err)
            del cache, scales
    ms, plain_ms = timing[("int8", EVAL_BEAMS)]
    bound, bound_by = bounds[("int8", EVAL_BEAMS)]
    return {"name": "beam_select_attention", "route": "cuda",
            "source": "multimodalanalytical_tpu_torch/csrc/beam_attention.cu",
            "replaces": "multimodalanalytical_tpu/ops/beam_attention.py:703",
            "launches": launches, "launches_by_phase": {"1": launches},
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "other_bounds_ms": {f"{k} K={b}": v[0] for (k, b), v in bounds.items()},
            "timed_at": f"int8 cache, B={BATCH}, K={EVAL_BEAMS}, L={MAX_LENGTH}, pos={pos}",
            "other_times_ms": {f"{k} K={b}": list(v) for (k, b), v in timing.items()}}


def check_fused_dropout() -> tuple:
    """#7 fused dropout vs its plain version at the train-site shapes, bf16,
    rate 0.1: forward and backward bit-equal, the backward's mask the
    forward's, the keep fraction within 5 sigma of 1 - rate. Returns (its
    record, the phase-1 launches)."""
    import math

    import torch

    from multimodalanalytical_tpu_torch.ops import dropout as plain_dropout
    from multimodalanalytical_tpu_torch.ops import fused_dropout as fd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    rate = DROPOUT
    times, launches = {}, 0
    for shape in DROPOUT_SHAPES:
        # No exact zeros (randn draws some), so that a kept element is non-zero.
        x = torch.randn(shape, generator=g, device=dev).bfloat16()
        x[x == 0] = 1.0
        seed = fd.draw_seed(g, dev)
        leaf = x.detach().requires_grad_()
        before = fd.fused_dropout.launches
        out = fd.FusedDropoutFunction.apply(leaf, seed, rate)
        out.backward(torch.ones_like(out))
        launches += fd.fused_dropout.launches - before
        want = fd.fused_dropout_plain(x, seed, rate)
        want_grad = fd.fused_dropout_plain(torch.ones_like(x), seed, rate)
        torch.cuda.synchronize()
        kept = (out != 0).float().mean().item()
        sigma = math.sqrt(rate * (1 - rate) / x.numel())
        fwd_equal, bwd_equal = torch.equal(out, want), torch.equal(leaf.grad, want_grad)
        same_mask = torch.equal(leaf.grad != 0, out != 0)
        ms = _time_ms(lambda: fd.fused_dropout(x, seed, rate))
        plain_ms = _time_ms(lambda: fd.fused_dropout_plain(x, seed, rate), iters=5)
        default_ms = _time_ms(lambda: plain_dropout.dropout(x, rate, g))
        times[shape] = (ms, plain_ms, default_ms)
        print(f"kernel fused_dropout {tuple(shape)} bf16 rate {rate}: forward bit-equal "
              f"{fwd_equal}, backward bit-equal {bwd_equal}, backward mask = forward mask "
              f"{same_mask}, keep fraction {kept:.6f} (want {1 - rate} +- {5 * sigma:.2e}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, ops/dropout.py {default_ms:.4f} ms",
              flush=True)
        _require(fwd_equal and bwd_equal and same_mask,
                 "fused_dropout differs from its plain version")
        _require(abs(kept - (1 - rate)) <= 5 * sigma, "fused_dropout keep fraction off")
    _require(launches == 2 * len(DROPOUT_SHAPES), "fused_dropout did not launch")
    ms, plain_ms, default_ms = times[DROPOUT_SHAPES[1]]
    numel = math.prod(DROPOUT_SHAPES[1])
    bound, bound_by = _bound_ms(numel, 2 * numel * 2)   # bf16 in and out
    return {"name": "fused_dropout", "route": "cuda",
            "source": "multimodalanalytical_tpu_torch/csrc/fused_dropout.cu",
            "replaces": "multimodalanalytical_tpu/ops/fused_dropout.py:59",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": default_ms,
            "library": "ops/dropout.py (torch.rand mask, then a multiply)",
            "timed_at": f"{DROPOUT_SHAPES[1]} bf16, rate {rate}",
            "other_times_ms": {str(s): list(v) for s, v in times.items()}}, launches


def _flash_inputs(g, b, h, d):
    """bf16 q, k, v, dout (B, H, L, Dh) of the long RLE encoder, L 4090
    padded to 4096 with zero rows, ragged key masks; the (B, L) keep mask
    and its additive bias."""
    import torch
    import torch.nn.functional as F

    from multimodalanalytical_tpu_torch.ops import flash_attention as flash

    dev = torch.device("cuda")
    pad = (-RLE_MAX_LEN) % flash.BLK
    length = RLE_MAX_LEN + pad
    q, k, v, dout = (F.pad(torch.randn(b, h, RLE_MAX_LEN, d, generator=g, device=dev),
                           (0, 0, 0, pad)).bfloat16() for _ in range(4))
    valid = torch.randint(RLE_MIN_LEN, RLE_MAX_LEN + 1, (b, 1), generator=g, device=dev)
    valid[0] = RLE_MAX_LEN
    keep = torch.arange(length, device=dev)[None, :] < valid
    bias = torch.where(keep, 0.0, flash.NEG_INF).float()
    return q, k, v, dout, keep, bias


def _sdpa_backends(fn) -> str:
    """The device kernels one call of ``fn`` launches, by name: which SDPA
    backend ran."""
    import torch

    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                    and ("attention" in e.name.lower() or "fmha" in e.name.lower()
                         or "flash" in e.name.lower() or "cudnn" in e.name.lower())})
    return "; ".join(n[:90] for n in names) or "no attention kernel found"


def _flash_errors(got, want) -> tuple:
    """(max|got - want|, max|want|, |got - want|_2 / |want|_2) and whether
    they are within FLASH_TOL and FLASH_RMS_TOL."""
    import torch

    diff = got.float() - want.float()
    err, peak = diff.abs().max().item(), want.float().abs().max().item()
    rms = (diff.norm() / want.float().norm()).item()
    finite = bool(torch.isfinite(got.float()).all())
    return err, peak, rms, finite and peak > 0 and err <= FLASH_TOL * peak and rms <= FLASH_RMS_TOL


def _check_flash_shape(g, b, h, d) -> dict:
    """Kernels vs plain versions at (B, H, L 4090 -> 4096, Dh), bf16: out,
    dq, dk, dv within FLASH_TOL / FLASH_RMS_TOL, lse within LSE_REL_TOL, two
    backward calls bit-equal; the same check fails the kernels run with the
    second key stage masked (a kernel that skipped it); then kernel, plain
    and SDPA times, the kernel and SDPA in turns."""
    import torch

    from multimodalanalytical_tpu_torch.ops import flash_attention as flash

    q, k, v, dout, keep, bias = _flash_inputs(g, b, h, d)
    length = q.shape[2]
    shape = f"B {b}, H {h}, L {RLE_MAX_LEN} (padded to {length}), Dh {d}, bf16"
    out, lse = flash.flash_attention_fwd(q, k, v, bias)
    want_out, want_lse = flash.flash_attention_fwd_plain(q, k, v, bias)
    grads = flash.flash_attention_bwd(q, k, v, bias, out, lse, dout)
    rerun = flash.flash_attention_bwd(q, k, v, bias, out, lse, dout)
    want_grads = flash.flash_attention_bwd_plain(q, k, v, bias, out, lse, dout)
    torch.cuda.synchronize()
    names, wants = ("out", "dq", "dk", "dv"), (want_out,) + want_grads
    errs = {}
    for name, got, want in zip(names, (out,) + grads, wants):
        err, peak, rms, ok = _flash_errors(got, want)
        print(f"kernel flash {name} {shape}: max_abs_err={err:.3e} tol={FLASH_TOL * peak:.3e} "
              f"(of max|plain|={peak:.3e}), rel_rms_err={rms:.3e} tol={FLASH_RMS_TOL:.1e}",
              flush=True)
        _require(ok, f"flash {name} disagrees with its plain version")
        errs[name] = err
    lse_err = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
    same_bits = all(torch.equal(a, c) for a, c in zip(grads, rerun))
    print(f"kernel flash lse {shape}: max_rel_err={lse_err:.3e} tol={LSE_REL_TOL:.1e}; "
          f"two backward calls bit-equal {same_bits}", flush=True)
    _require(lse_err <= LSE_REL_TOL, "flash lse disagrees with its plain version")
    _require(same_bits, "two flash backward calls differ")
    del grads, rerun

    # A planted fault: the kernels with the second key stage masked are a
    # kernel that skipped that stage; the check above must reject it.
    stage = FLASH_KEY_STAGE[d]
    skipped = bias.clone()
    skipped[:, stage:2 * stage] = flash.NEG_INF
    bad_out, bad_lse = flash.flash_attention_fwd(q, k, v, skipped)
    bad = (bad_out,) + flash.flash_attention_bwd(q, k, v, skipped, bad_out, bad_lse, dout)
    caught = {}
    for name, got, want in zip(names, bad, wants):
        err, peak, rms, ok = _flash_errors(got, want)
        caught[name] = (not ok, round(err / peak, 4), round(rms, 4))
    print(f"kernel flash {shape}, key stage {stage}-{2 * stage - 1} skipped: rejected "
          f"(max_err/max|plain|, rel_rms_err) {caught}", flush=True)
    _require(all(c[0] for c in caught.values()),
             "the flash check passes a kernel that skips a key stage")
    del want_out, want_lse, want_grads, wants, bad, bad_lse, skipped

    # SDPA on the same inputs, as a yardstick only: the key mask as a bool
    # (B, 1, 1, L) mask; its backward is forward + backward minus forward.
    mask = keep[:, None, None, :]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd():
        with torch.no_grad():
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    def sdpa_fwd_grad():
        return torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask)

    def sdpa_fwd_bwd():
        sdpa_fwd_grad().backward(dout)

    fwd = (lambda: flash.flash_attention_fwd(q, k, v, bias),
           lambda: flash.flash_attention_fwd_plain(q, k, v, bias))
    bwd = (lambda: flash.flash_attention_bwd(q, k, v, bias, out, lse, dout),
           lambda: flash.flash_attention_bwd_plain(q, k, v, bias, out, lse, dout))
    times = {"fwd": [], "bwd": [], "sdpa_fwd": [], "sdpa_fwd_grad": [], "sdpa_fwd_bwd": []}
    for _ in range(2):   # in turns: kernel, SDPA, kernel, SDPA
        times["fwd"].append(_time_ms(fwd[0], iters=10))
        times["sdpa_fwd"].append(_time_ms(sdpa_fwd, iters=10))
        times["bwd"].append(_time_ms(bwd[0], iters=10))
        times["sdpa_fwd_grad"].append(_time_ms(sdpa_fwd_grad, iters=10))
        times["sdpa_fwd_bwd"].append(_time_ms(sdpa_fwd_bwd, iters=10))
    mean = {key: sum(val) / len(val) for key, val in times.items()}
    valid_keys = int(keep.sum())
    result = {
        "shape": shape, "errs": errs,
        "ms": {"fwd": mean["fwd"], "bwd": mean["bwd"]},
        "plain_ms": {"fwd": _time_ms(fwd[1], iters=3), "bwd": _time_ms(bwd[1], iters=3)},
        "library_ms": {"fwd": mean["sdpa_fwd"],
                       "bwd": mean["sdpa_fwd_bwd"] - mean["sdpa_fwd_grad"]},
        # 2 Dh per (query, valid key) pair, product and head: 2 products
        # forward, 5 backward. Masked keys (bias -1e9) add exactly 0 to out,
        # dq, dk and dv of a row with a valid key, so the work this data needs
        # counts the RLE_MAX_LEN queries against each row's valid keys only.
        "valid_keys": valid_keys,
        "flops": {"fwd": 4 * h * d * RLE_MAX_LEN * valid_keys,
                  "bwd": 10 * h * d * RLE_MAX_LEN * valid_keys},
        # each input read once, each output written once (bf16; bias, lse fp32)
        "bytes": {"fwd": 4 * q.numel() * 2 + bias.numel() * 4 + lse.numel() * 4,
                  "bwd": 8 * q.numel() * 2 + bias.numel() * 4 + lse.numel() * 4},
        "sdpa_kernels": {"fwd": _sdpa_backends(sdpa_fwd), "bwd": _sdpa_backends(sdpa_fwd_bwd)},
    }
    for part in ("fwd", "bwd"):
        bound, by = _bound_ms(result["flops"][part], result["bytes"][part])
        result.setdefault("bound_ms", {})[part] = bound
        result.setdefault("bound_by", {})[part] = by
        ms = result["ms"][part]
        print(f"time flash_attention_{part} {shape}: kernel {ms:.4f} ms "
              f"({result['flops'][part] / ms / 1e9:.1f} TFLOP/s of the {valid_keys} valid "
              f"keys' work; in turns "
              f"{[round(x, 4) for x in times[part]]}), plain {result['plain_ms'][part]:.4f} ms, "
              f"SDPA {result['library_ms'][part]:.4f} ms, bound {bound:.4f} ms ({by}); SDPA "
              f"kernels: {result['sdpa_kernels'][part]}", flush=True)
    del leaves
    torch.cuda.empty_cache()
    return result


def check_flash_kernels() -> list:
    """#5/#6 flash attention forward and backward vs their plain versions at
    the long RLE encoder's shapes, head_dim 64 (B 8, H 8: the records) and
    128 (B 8, H 4: the same d_model 512); returns records."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(5)
    main = _check_flash_shape(g, TRAIN_BATCH, HEADS, D_MODEL // HEADS)
    wide = _check_flash_shape(g, TRAIN_BATCH, HEADS // 2, 2 * D_MODEL // HEADS)
    records = []
    for name, part, line, err in (
            ("flash_attention_fwd", "fwd", 115, main["errs"]["out"]),
            ("flash_attention_bwd", "bwd", 204,
             max(main["errs"][x] for x in ("dq", "dk", "dv")))):
        ms = main["ms"][part]
        records.append({
            "name": name, "route": "cuda",
            "source": "multimodalanalytical_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"multimodalanalytical_tpu/ops/flash_attention.py:{line}",
            "max_abs_err": err, "ms": ms, "plain_ms": main["plain_ms"][part],
            "bound_ms": main["bound_ms"][part], "bound_by": main["bound_by"][part],
            "library_ms": main["library_ms"][part], "tflops": main["flops"][part] / ms / 1e9,
            "library": "torch.nn.functional.scaled_dot_product_attention, bool key mask"
                       + (" (forward + backward minus forward)" if part == "bwd" else ""),
            "library_kernels": main["sdpa_kernels"][part], "timed_at": main["shape"],
            "valid_keys": main["valid_keys"],
            "head_dim_128": {"timed_at": wide["shape"], "ms": wide["ms"][part],
                             "plain_ms": wide["plain_ms"][part],
                             "library_ms": wide["library_ms"][part],
                             "bound_ms": wide["bound_ms"][part],
                             "valid_keys": wide["valid_keys"],
                             "tflops": wide["flops"][part] / wide["ms"][part] / 1e9}})
    return records


# ---------------------------------------------------------------- phase 2
def _flagship(use_beam_kernel: bool = True, kv_cache_dtype: str = "int8"):
    import torch

    from multimodalanalytical_tpu_torch.models.config import ModelConfig
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel

    cfg = ModelConfig(
        d_model=D_MODEL, encoder_layers=LAYERS, decoder_layers=LAYERS,
        encoder_attention_heads=HEADS, decoder_attention_heads=HEADS,
        encoder_ffn_dim=FFN, decoder_ffn_dim=FFN, vocab_size=VOCAB,
        dtype="bfloat16", max_target_length=MAX_LENGTH,
        use_beam_kernel=use_beam_kernel, kv_cache_dtype=kv_cache_dtype,
    )
    dev = torch.device(DEVICE)
    return Seq2SeqModel(cfg, DATA_CONFIG, "Smiles", device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))


def _request(seed: int, batch: int = BATCH):
    """A seeded request batch: Formula ids with tail padding + IR patches."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(6, FORMULA_LEN + 1, batch)
    formula_keep = np.arange(FORMULA_LEN)[None, :] < lengths[:, None]
    formula = np.where(formula_keep, rng.integers(4, 32, (batch, FORMULA_LEN)), 0)
    ir = rng.random((batch, N_PATCHES, PATCH)).astype(np.float32)
    mask = np.concatenate([formula_keep, np.ones((batch, N_PATCHES), bool)], axis=1)
    return {"Formula": formula.astype(np.int64), "IR": ir}, mask.astype(np.int32)


def check_teacher_forced(model, plain_model) -> None:
    """Decode logits of the kernel path vs the use_beam_kernel=False path
    on the same weights, for 8 teacher-forced steps with permuted ancestry,
    at each beam count and cache of DECODE_BEAMS."""
    import torch

    from multimodalanalytical_tpu_torch.generation.beam_search import decode_model

    dev = torch.device(DEVICE)
    batch, steps = 8, 8
    inputs, mask = _request(seed=99, batch=batch)
    inputs = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
    mask = torch.as_tensor(mask, device=dev)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        hidden = model.encode(inputs, mask)
        for beams, kinds in DECODE_BEAMS:
            tokens = torch.randint(4, VOCAB, (batch, beams, steps), generator=g).to(dev)
            anc = torch.randint(0, beams, (batch, beams, steps), generator=g,
                                dtype=torch.int32).to(dev)
            for kind in kinds:
                logits = []
                for m in (model, plain_model):
                    dm = decode_model(m)
                    cache = dm.init_beam_cache(batch, beams, steps, hidden, kind == "int8")
                    out = []
                    for t in range(steps):
                        a = anc.clone()
                        a[:, :, t] = torch.arange(beams, device=dev, dtype=torch.int32)
                        out.append(dm.beam_decode_step(tokens[:, :, t], t, cache, a, mask))
                    logits.append(torch.stack(out).float())
                err = (logits[0] - logits[1]).abs().max().item()
                tol = LOGIT_TOL * max(1.0, logits[1].abs().max().item())
                print(f"teacher-forced logits K={beams} {kind} cache, kernel vs plain path: "
                      f"max_abs_err={err:.3e} tol={tol:.3e}", flush=True)
                _require(bool(torch.isfinite(logits[0]).all()) and err <= tol,
                         "kernel path disagrees with the plain path")


def run_slice() -> dict:
    import numpy as np
    import torch

    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine

    counters = _decode_counters()
    model = _flagship()
    plain_model = _flagship(use_beam_kernel=False)
    plain_model.load_state_dict(model.state_dict())
    check_teacher_forced(model, plain_model)

    engine = InferenceEngine(model, n_beams=BEAMS, batch_size=BATCH)
    engine.decode_batch(*_request(seed=100))          # warm-up, not counted
    requests = [_request(seed) for seed in (1, 2, 3)]
    for fn in counters:
        fn.launches = 0
    results, seconds, steps = [], [], 0
    for inputs, mask in requests:
        t0 = time.perf_counter()
        seqs, scores = engine.decode_batch(inputs, mask)
        seconds.append(time.perf_counter() - t0)
        steps += engine.last_steps
        results.append((seqs, scores))
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"slice: 3 requests x {BATCH} spectra, beam {BEAMS}, {steps} decode steps, "
          f"launches {launches}", flush=True)
    for name, count in launches.items():
        _require(count == LAYERS * steps, f"{name} launched {count} times, want {LAYERS * steps}")
    for seqs, scores in results:
        _require(seqs.shape == (BATCH, BEAMS, MAX_LENGTH) and scores.shape == (BATCH, BEAMS),
                 "unexpected output shapes")
        _require(bool(np.isfinite(scores).all()), "non-finite scores")
        _require(bool((np.diff(scores, axis=1) <= 0).all()), "beams not sorted by score")
        _require(bool((seqs[:, :, 0] == model.config.bos_token_id).all()),
                 "a sequence does not start with BOS")
    per_batch = sum(seconds) / len(seconds)
    print(f"slice kernel path: {per_batch:.4f} s/batch ({BATCH / per_batch:.2f} spectra/s), "
          f"per request {[round(s, 4) for s in seconds]}", flush=True)

    plain_engine = InferenceEngine(plain_model, n_beams=BEAMS, batch_size=BATCH)
    plain_engine.decode_batch(*_request(seed=100))
    plain_seconds, agree = [], []
    for (inputs, mask), (seqs, _) in zip(requests, results):
        t0 = time.perf_counter()
        plain_seqs, _ = plain_engine.decode_batch(inputs, mask)
        plain_seconds.append(time.perf_counter() - t0)
        agree.append(float((plain_seqs[:, 0] == seqs[:, 0]).all(axis=1).mean()))
    plain_per_batch = sum(plain_seconds) / len(plain_seconds)
    print(f"slice use_beam_kernel=False: {plain_per_batch:.4f} s/batch "
          f"({BATCH / plain_per_batch:.2f} spectra/s); top-1 agreement with the kernel "
          f"path {np.mean(agree):.4f} (random weights: reported, not asserted)", flush=True)
    return launches


# ---------------------------------------------------------- phases 3 and 4
def _flash_counters():
    from multimodalanalytical_tpu_torch.ops import flash_attention as flash

    return flash.flash_attention_fwd, flash.flash_attention_bwd


def _decode_counters():
    from multimodalanalytical_tpu_torch.ops import beam_attention as ba
    from multimodalanalytical_tpu_torch.ops import decode_ffn

    return ba.beam_select_attention_update, ba.beam_cross_attention, decode_ffn.geglu_ffn


def _rle_model(dropout: float, use_flash: bool):
    """The flagship-width model on one RLE source; seeded, so every call
    builds the same weights."""
    import torch

    from multimodalanalytical_tpu_torch.models.config import ModelConfig
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel

    cfg = ModelConfig(
        d_model=D_MODEL, encoder_layers=LAYERS, decoder_layers=LAYERS,
        encoder_attention_heads=HEADS, decoder_attention_heads=HEADS,
        encoder_ffn_dim=FFN, decoder_ffn_dim=FFN, vocab_size=VOCAB, dtype="bfloat16",
        dropout=dropout, max_position_embeddings=4096, max_target_length=TARGET_LEN,
        use_flash_attention=use_flash,
    )
    dev = torch.device(DEVICE)
    return Seq2SeqModel(cfg, RLE_DATA_CONFIG, "Smiles", device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))


def _targets(rng, batch: int) -> dict:
    """BOS-started teacher-forcing ids, padded to TARGET_LEN, with -100 labels
    on the padding."""
    import numpy as np

    lengths = rng.integers(20, TARGET_LEN + 1, batch)
    lengths[0] = TARGET_LEN
    keep = np.arange(TARGET_LEN)[None, :] < lengths[:, None]
    tokens = rng.integers(4, VOCAB, (batch, TARGET_LEN + 1))
    tokens[:, 0] = 2
    return {"decoder_ids": np.where(keep, tokens[:, :-1], 0),
            "decoder_mask": keep.astype(np.int32),
            "labels": np.where(keep, tokens[:, 1:], -100)}


def _rle_batch(seed: int = 7) -> dict:
    """B rows of RLE ids, lengths drawn from RLE_MIN_LEN..RLE_MAX_LEN, tail-
    padded to RLE_MAX_LEN, and SMILES targets."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(RLE_MIN_LEN, RLE_MAX_LEN + 1, TRAIN_BATCH)
    lengths[0] = RLE_MAX_LEN
    keep = np.arange(RLE_MAX_LEN)[None, :] < lengths[:, None]
    ids = np.where(keep, rng.integers(4, RLE_VOCAB, (TRAIN_BATCH, RLE_MAX_LEN)), 0)
    return {"encoder_inputs": {"RLE": ids}, "encoder_mask": keep.astype(np.int32),
            **_targets(rng, TRAIN_BATCH)}


def _step_twice(model, batch) -> tuple:
    """(loss, grad_norm) of one dropout-0 train step, and the seconds of a
    second step (its time only), with the peak device memory."""
    import torch

    from multimodalanalytical_tpu_torch.training import Trainer

    trainer = Trainer(model, optimiser="adamw", lr=TRAIN_LR, num_steps=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    metrics = trainer.train_step(batch)
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    return loss, grad_norm, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def _fit_rle(batch, real_tokens: int, route: str) -> tuple:
    """Ten dropout-0.1 AdamW steps of the RLE model on the repeated batch;
    returns (losses, s/step, peak GiB) after checking the losses."""
    import math

    import torch

    from multimodalanalytical_tpu_torch.training import Trainer

    model = _rle_model(dropout=DROPOUT, use_flash=True)
    trainer = Trainer(model, optimiser="adamw", lr=TRAIN_LR, num_steps=TRAIN_STEPS,
                      clip_grad=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = trainer.fit([batch], epochs=TRAIN_STEPS, max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train fit ({route}): {TRAIN_STEPS} AdamW steps, B {TRAIN_BATCH}, dropout "
          f"{DROPOUT}: {seconds:.4f} s/step ({real_tokens / seconds:.1f} encoder tokens/s "
          f"real, {TRAIN_BATCH * RLE_MAX_LEN / seconds:.1f} padded); peak {peak:.2f} GiB; "
          f"losses {[round(x, 4) for x in losses]}", flush=True)
    _require(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
             "non-finite training loss")
    _require(losses[-1] < losses[0], "the training loss did not fall")
    del model, trainer
    torch.cuda.empty_cache()
    return losses, seconds, peak


@contextlib.contextmanager
def _fused_dropout_sites(sites: list):
    """Every dropout site of the model through fused dropout, as
    benchmarks/exp_remat.py routes the JAX sites through pallas_dropout;
    counts the sites that drop in ``sites[0]``."""
    from multimodalanalytical_tpu_torch.models import transformer
    from multimodalanalytical_tpu_torch.ops import fused_dropout as fd

    def fused_sites(x, rate, generator):
        sites[0] += generator is not None and rate > 0.0
        return fd.dropout(x, rate, generator)

    original = transformer.dropout
    transformer.dropout = fused_sites
    try:
        yield
    finally:
        transformer.dropout = original


def run_training_slice() -> tuple:
    """Phase 3; returns the flash kernels' launch counts of the default fit
    and fused_dropout's of the fit that routes every dropout site through it."""
    import torch

    from multimodalanalytical_tpu_torch.ops import fused_dropout as fd

    batch = _rle_batch()
    real_tokens = int(batch["encoder_mask"].sum())
    padded_tokens = TRAIN_BATCH * RLE_MAX_LEN
    routes = {}
    for use_flash in (True, False):
        model = _rle_model(dropout=0.0, use_flash=use_flash)
        routes[use_flash] = _step_twice(model, batch)
        del model
        torch.cuda.empty_cache()
        loss, grad_norm, seconds, peak = routes[use_flash]
        print(f"train route use_flash_attention={use_flash}: loss {loss:.6f} grad_norm "
              f"{grad_norm:.6f}; {seconds:.4f} s/step ({real_tokens / seconds:.1f} encoder "
              f"tokens/s real, {padded_tokens / seconds:.1f} padded); peak {peak:.2f} GiB",
              flush=True)
    (f_loss, f_norm, *_), (p_loss, p_norm, *_) = routes[True], routes[False]
    loss_rel = abs(f_loss - p_loss) / abs(p_loss)
    norm_rel = abs(f_norm - p_norm) / abs(p_norm)
    print(f"train routes: loss rel diff {loss_rel:.3e} (tol {ROUTE_LOSS_RTOL}), grad_norm "
          f"rel diff {norm_rel:.3e} (tol {ROUTE_GRAD_NORM_RTOL})", flush=True)
    _require(loss_rel <= ROUTE_LOSS_RTOL and norm_rel <= ROUTE_GRAD_NORM_RTOL,
             "the flash and plain training routes disagree")

    counters = _flash_counters()
    for fn in counters:
        fn.launches = 0
    _, default_s, default_peak = _fit_rle(batch, real_tokens, "ops/dropout.py")
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"train fit launches {launches}", flush=True)
    for name, count in launches.items():
        _require(count == LAYERS * TRAIN_STEPS,
                 f"{name} launched {count} times, want {LAYERS * TRAIN_STEPS}")

    sites = [0]
    fd.fused_dropout.launches = 0
    with _fused_dropout_sites(sites):
        _, fused_s, fused_peak = _fit_rle(batch, real_tokens, "fused_dropout")
    fused_launches = fd.fused_dropout.launches
    print(f"train fit fused_dropout vs ops/dropout.py: {fused_s:.4f} vs {default_s:.4f} s/step, "
          f"peak {fused_peak:.2f} vs {default_peak:.2f} GiB; {sites[0]} dropout calls, "
          f"{fused_launches} fused_dropout launches (forward and backward)", flush=True)
    _require(sites[0] > 0 and fused_launches == 2 * sites[0],
             "fused_dropout did not launch at every dropout site, forward and backward")
    return launches, fused_launches


def run_ir_recipe() -> None:
    """Phase 4: the flagship IR recipe's optimizer at B 128."""
    import math

    import numpy as np
    import torch

    from multimodalanalytical_tpu_torch.training import Trainer

    inputs, mask = _request(seed=11, batch=IR_RECIPE_BATCH)
    batch = {"encoder_inputs": inputs, "encoder_mask": mask,
             **_targets(np.random.default_rng(12), IR_RECIPE_BATCH)}
    model = _flagship()
    trainer = Trainer(model, optimiser="adamw", lr=TRAIN_LR, num_steps=IR_RECIPE_STEPS,
                      clip_grad=1.0)
    counters = _flash_counters() + _decode_counters()
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = trainer.fit([batch], epochs=IR_RECIPE_STEPS, max_steps=IR_RECIPE_STEPS)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / IR_RECIPE_STEPS
    launched = {fn.__name__: fn.launches for fn in counters if fn.launches}
    print(f"IR recipe: {IR_RECIPE_STEPS} AdamW steps, B {IR_RECIPE_BATCH}: {seconds:.4f} s/step "
          f"(first step included); losses {[round(x, 4) for x in losses]}; kernel launches "
          f"{launched or 'none'}", flush=True)
    _require(all(math.isfinite(x) for x in losses), "non-finite training loss")
    _require(not launched, "a kernel ran in the IR recipe's train step")
    del model, trainer
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 5
# Real molecules as targets, so that canonicalisation and the formula
# filter of rejection sampling score real SMILES.
SMILES_CORPUS = [
    "CCO", "CC(=O)O", "c1ccccc1", "c1ccccc1O", "CC(C)O", "CCN(CC)CC", "O=C(O)c1ccccc1",
    "CC(=O)Nc1ccc(O)cc1", "COc1ccccc1", "CCOC(C)=O", "C1CCCCC1", "CC#N", "ClCCl",
    "Cc1ccccc1", "NCCO", "O=Cc1ccccc1", "CCCCBr", "c1ccncc1", "CC(C)(C)O", "OCC(O)CO",
]
SMILES_REGEX = (r"(\[[^\]]+]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p|\(|\)|\.|=|#|-|\+|\\|\/|:"
                r"|~|@|\?|>|\*|\$|\%[0-9]{2}|[0-9])")
EVAL_TRAIN, EVAL_VAL, EVAL_TEST = 384, 128, 128
EVAL_EPOCHS = 2
EVAL_TARGET_LEN = 32      # longest corpus target (19 tokens) + BOS/EOS, padded


class FixedVocabTokenizer:
    """Stand-in for the fitted target ``RegexTokenizer`` (``data/tokenizer.py``
    needs the ``tokenizers`` package, which the card's machine lacks): the
    SMILES regex's tokens, then fillers up to the flagship vocabulary of 320,
    with the same special ids (pad 0, bos 2, eos 3) and the same
    ``batch_decode`` output (tokens joined by spaces, specials skipped)."""

    def __init__(self):
        import re

        self.regex = re.compile(SMILES_REGEX)
        atoms = sorted({t for s in SMILES_CORPUS for t in self.regex.findall(s)})
        atoms += [t for t in ("S", "P", "F", "I", "n", "o", "s", "[nH]", "=", "#", "(", ")")
                  if t not in atoms]
        tokens = ["<pad>", "<unk>", "<bos>", "<eos>"] + atoms
        self.tokens = tokens + [f"<x{i}>" for i in range(VOCAB - len(tokens))]
        self.ids = {t: i for i, t in enumerate(self.tokens)}
        self.pad_token_id, self.bos_token_id, self.eos_token_id = 0, 2, 3
        self.vocab_size = VOCAB

    def encode(self, smiles: str) -> list:
        return [self.ids[t] for t in self.regex.findall(smiles)]

    def batch_decode(self, ids, skip_special_tokens: bool = True) -> list:
        specials = {self.pad_token_id, self.bos_token_id, self.eos_token_id}
        return [" ".join(self.tokens[int(i)] for i in row
                         if not (skip_special_tokens and int(i) in specials))
                for row in ids]


def _eval_loader(tokenizer, first: int, rows: int) -> list:
    """Collated batches of B 128 (the collator's layout) for spectra
    first .. first + rows - 1, seeded by index."""
    import numpy as np

    batches = []
    for start in range(first, first + rows, BATCH):
        rng = np.random.default_rng(1000 + start)
        inputs, mask = _request(seed=2000 + start, batch=BATCH)
        smiles = [SMILES_CORPUS[i] for i in rng.integers(0, len(SMILES_CORPUS), BATCH)]
        dec = np.zeros((BATCH, EVAL_TARGET_LEN), np.int64)
        labels = np.full((BATCH, EVAL_TARGET_LEN), -100, np.int64)
        for row, s in enumerate(smiles):
            ids = tokenizer.encode(s)
            dec[row, : len(ids) + 1] = [tokenizer.bos_token_id] + ids
            labels[row, : len(ids) + 1] = ids + [tokenizer.eos_token_id]
        batches.append({"encoder_inputs": inputs, "encoder_mask": mask, "decoder_ids": dec,
                        "decoder_mask": (labels != -100).astype(np.int32), "labels": labels,
                        "target_strings": smiles, "n_valid": BATCH})
    return batches


def run_eval_path() -> dict:
    """Phase 5: fit (2 epochs, validation each), checkpoints, restore of
    ``best`` into a fresh model, predict at K 30 and Table 4's scoring with
    rejection sampling off and on. Returns the decode kernels' launches."""
    import math
    import tempfile

    import torch

    from multimodalanalytical_tpu_torch.cli.common import score_predictions
    from multimodalanalytical_tpu_torch.training import Trainer
    from multimodalanalytical_tpu_torch.training.checkpoint import (
        CheckpointManager,
        restore_params,
    )

    tokenizer = FixedVocabTokenizer()
    train = _eval_loader(tokenizer, 0, EVAL_TRAIN)
    val = _eval_loader(tokenizer, EVAL_TRAIN, EVAL_VAL)
    test = _eval_loader(tokenizer, EVAL_TRAIN + EVAL_VAL, EVAL_TEST)
    steps = EVAL_EPOCHS * len(train)
    model = _flagship()
    trainer = Trainer(model, tokenizer, optimiser="adamw", lr=TRAIN_LR, num_steps=steps,
                      clip_grad=1.0, n_beams=EVAL_BEAMS)
    counters = _decode_counters()
    for fn in counters:
        fn.launches = 0

    spent = {"validate": [], "save": []}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name].append(time.perf_counter() - t0)
            return out
        return wrapper

    with tempfile.TemporaryDirectory() as tmp:
        checkpoints = CheckpointManager(Path(tmp) / "checkpoints")
        trainer.validate = timed("validate", trainer.validate)
        checkpoints.save = timed("save", checkpoints.save)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = trainer.fit(train, val, epochs=EVAL_EPOCHS, checkpoints=checkpoints)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        val_steps = trainer.decode_steps
        step_s = (fit_s - sum(spent["validate"]) - sum(spent["save"])) / steps
        print(f"eval path fit: {steps} AdamW steps at B {BATCH}: {step_s:.4f} s/step (train "
              f"steps only); validation {[round(x, 4) for x in spent['validate']]} s/pass "
              f"(K 1, {val_steps} decode steps in all); checkpoint saves "
              f"{[round(x, 3) for x in spent['save']]} s; losses "
              f"{[round(x, 4) for x in losses]}; best step {checkpoints.best_step}", flush=True)
        _require(len(losses) == steps and all(math.isfinite(x) for x in losses),
                 "non-finite training loss")
        _require(len(spent["validate"]) == EVAL_EPOCHS, "validation did not run every epoch")
        for name in ("last", "best"):
            _require((checkpoints.directory / name).is_dir(), f"no {name} checkpoint")

        # The best checkpoint into a fresh model: its params, bit for bit.
        best = checkpoints.restore("best")["params"]
        fresh = _flagship()
        fresh.load_state_dict(restore_params(checkpoints.directory / "best"))
        restored = fresh.state_dict()
        identical = all(torch.equal(restored[k].cpu(), best[k]) for k in best)
        print(f"restore best (step {checkpoints.best_step}) into a fresh model: "
              f"{len(best)} tensors bit-identical {identical}", flush=True)
        _require(identical and set(restored) == set(best), "restored params differ")

    predictor = Trainer(fresh, tokenizer, n_beams=EVAL_BEAMS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predictions = predictor.predict(test, n_beams=EVAL_BEAMS)
    torch.cuda.synchronize()
    predict_s = (time.perf_counter() - t0) / len(test)
    launches = {fn.__name__: fn.launches for fn in counters}
    decode_steps = val_steps + predictor.decode_steps
    cache_bytes = 2 * BATCH * MAX_LENGTH * EVAL_BEAMS * D_MODEL
    print(f"eval path predict: K {EVAL_BEAMS}, {len(test)} batch(es) of {BATCH}: "
          f"{predict_s:.4f} s/batch ({BATCH / predict_s:.2f} spectra/s), "
          f"{predictor.decode_steps} decode steps, avg_loss {predictions['avg_loss']:.4f}; "
          f"int8 KV cache {cache_bytes} B per layer ({cache_bytes / 2**30:.3f} GiB, "
          f"{LAYERS} layers); launches {launches} over {decode_steps} decode steps",
          flush=True)
    _require(len(predictions["predictions"]) == EVAL_TEST
             and all(len(p) == EVAL_BEAMS for p in predictions["predictions"])
             and predictions["targets"] == [s for b in test for s in b["target_strings"]],
             "predict returned other rows or beams")
    _require(math.isfinite(predictions["avg_loss"]), "non-finite predict loss")
    for name, count in launches.items():
        _require(count == LAYERS * decode_steps,
                 f"{name} launched {count} times, want {LAYERS * decode_steps}")
    for rejection in (False, True):
        metrics = score_predictions(predictions, molecules=True, rejection_sampling=rejection)
        tops = {k: round(v, 4) for k, v in metrics.items()
                if k in ("Top-1", "Top-5", "Top-10", f"Top-{EVAL_BEAMS}")}
        print(f"eval path scoring, rejection sampling {rejection}: {tops} (random weights: "
              f"reported, not asserted)", flush=True)
    return launches


# ------------------------------------------------------------- profiling
PROFILE_TOP = 14


def _device_time(prof) -> tuple:
    """(seconds, rows, kernel launches) of one profiled run. Only the
    device's own events count (kernels, copies, sets): the profiler's
    operator rows (``aten::...``) carry their kernels' time a second time.
    rows: (ms, calls, name) by name, largest first."""
    from torch.autograd import DeviceType

    by_name, launches = {}, 0
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            ms, calls = by_name.get(event.name, (0.0, 0))
            by_name[event.name] = (ms + event.time_range.elapsed_us() / 1e3, calls + 1)
        elif event.name.startswith("cudaLaunchKernel"):
            launches += 1
    rows = sorted(((ms, calls, name) for name, (ms, calls) in by_name.items()), reverse=True)
    return sum(ms for ms, _, _ in rows) / 1e3, rows, launches


def profile_eval() -> None:
    """The evaluation path under ``torch.profiler``: one beam-30 predict
    batch of 128 spectra and one greedy (K 1) validation pass over 128, on
    a fresh flagship model (random weights, so every row decodes all
    steps). Each runs once to warm up, once unprofiled for its wall time
    and once profiled; prints device time by kernel and the busy share
    (device time / unprofiled wall time)."""
    import torch

    from multimodalanalytical_tpu_torch.training import Trainer

    tokenizer = FixedVocabTokenizer()
    val = _eval_loader(tokenizer, EVAL_TRAIN, EVAL_VAL)
    test = _eval_loader(tokenizer, EVAL_TRAIN + EVAL_VAL, BATCH)
    trainer = Trainer(_flagship(), tokenizer, n_beams=EVAL_BEAMS)
    runs = {f"predict K {EVAL_BEAMS}": lambda: trainer.predict(test, n_beams=EVAL_BEAMS),
            "validate K 1": lambda: trainer.validate(val)}
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        steps = trainer.decode_steps
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = trainer.decode_steps - steps
        with torch.profiler.profile(activities=activities) as prof:
            run()
            torch.cuda.synchronize()
        device_s, rows, launches = _device_time(prof)
        print(f"profile {name}: {steps} decode steps; wall {wall:.4f} s unprofiled; device "
              f"time {device_s:.4f} s (kernels and copies only); busy share "
              f"{device_s / wall:.3f}; {launches} kernel launches", flush=True)
        for ms, calls, kernel in rows[:PROFILE_TOP]:
            print(f"  {100 * ms / (device_s * 1e3):5.1f}% {ms:10.2f} ms x {calls:6d}  "
                  f"{kernel[:100]}", flush=True)


def profile_train() -> None:
    """Phase 3's train step under ``torch.profiler``: the flagship-width RLE
    model (B 8, L 4090, dropout 0.1, flash route), with ``ops/dropout.py``
    and then with every dropout site through fused dropout, as phase 3's
    two fits. Each takes two warm-up steps, four unprofiled steps for the
    wall time and two profiled ones; prints device time per step by kernel
    (device events only, as ``--profile-eval``), host time per step in the
    dropout calls, the busy share and the peak memory."""
    import torch

    from multimodalanalytical_tpu_torch.training import Trainer

    batch = _rle_batch()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for route in ("ops/dropout.py", "fused_dropout"):
        trainer = Trainer(_rle_model(dropout=DROPOUT, use_flash=True), optimiser="adamw",
                          lr=TRAIN_LR, num_steps=100, clip_grad=1.0)
        steps = 2
        with _fused_dropout_sites([0]) if route == "fused_dropout" else contextlib.nullcontext():
            for _ in range(steps):
                trainer.train_step(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(2 * steps):
                trainer.train_step(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / (2 * steps)
            peak = torch.cuda.max_memory_allocated() / 2**30
            with torch.profiler.profile(activities=activities) as prof:
                for _ in range(steps):
                    trainer.train_step(batch)
                torch.cuda.synchronize()
        device_s, rows, launches = _device_time(prof)
        device_s /= steps
        host_ms = {}
        for row in prof.key_averages():
            if "dropout" in row.key.lower() and row.cpu_time_total > 0:
                host_ms[row.key] = round(row.cpu_time_total / 1e3 / steps, 3)
        print(f"profile train step (RLE, B {TRAIN_BATCH}, L {RLE_MAX_LEN}, dropout {DROPOUT}, "
              f"{route}): wall {wall:.4f} s/step unprofiled; device time {device_s:.4f} s/step "
              f"(kernels and copies only); busy share {device_s / wall:.3f}; "
              f"{launches // steps} kernel launches per step; peak {peak:.2f} GiB; host ms per "
              f"step in dropout calls {host_ms}", flush=True)
        for ms, calls, kernel in rows[:PROFILE_TOP]:
            print(f"  {100 * ms / (device_s * steps * 1e3):5.1f}% {ms / steps:10.2f} ms x "
                  f"{calls // steps:6d} per step  {kernel[:100]}", flush=True)
        del trainer, prof
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; this check "
                         "runs only on a CUDA device")
    if not (REPO / "multimodalanalytical_tpu_torch").is_dir():
        raise SystemExit("chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    from multimodalanalytical_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    lib_path = _cuda.library_path()
    _cuda.library()
    print(f"build: {lib_path.name} ready in {time.perf_counter() - t0:.2f} s", flush=True)
    if "--profile-eval" in sys.argv[1:]:
        print(smi, flush=True)
        profile_eval()
        return 0
    if "--profile-train" in sys.argv[1:]:
        print(smi, flush=True)
        profile_train()
        return 0

    records = check_kernels()
    read_only = check_read_only_attention()
    dropout, dropout_phase1 = check_fused_dropout()
    records += check_flash_kernels()
    by_phase = {name: {"2": n} for name, n in run_slice().items()}
    flash_launches, dropout_phase3 = run_training_slice()
    by_phase.update({name: {"3": n} for name, n in flash_launches.items()})
    run_ir_recipe()
    for name, n in run_eval_path().items():
        by_phase[name]["5"] = n
    for rec in records:
        rec["launches_by_phase"] = by_phase[rec["name"]]
        rec["launches"] = sum(by_phase[rec["name"]].values())
    dropout["launches_by_phase"] = {"1": dropout_phase1, "3": dropout_phase3}
    dropout["launches"] = dropout_phase1 + dropout_phase3
    records += [read_only, dropout]
    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
