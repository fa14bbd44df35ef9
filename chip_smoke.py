#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port's serving and training paths.

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and
``nvcc``; it imports torch, numpy, the standard library and
``multimodalanalytical_tpu_torch``, never JAX. Phases, one line each, any
failure raises and exits non-zero:

0. device and build: the card's name and power limit, and the time to
   compile the package's CUDA kernels from ``csrc/``;
1. each kernel against its plain PyTorch version, with both times: the
   decode kernels at the flagship decode shapes (B 128, K 10, D 512, H 8,
   F 2048, Ls 26), the flash attention forward and backward at the long
   RLE encoder's (B 8, H 8, L 4090 padded to 4096, head_dim 64, bf16,
   ragged key masks);
2. serving: the flagship CustomModel (6 + 6 layers, bf16, int8 KV cache,
   seeded random weights) answers three seeded 128-spectrum requests
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
   flash kernel launched 6 x the steps;
4. training, the flagship IR recipe (Formula + IR patches, B 128): three
   AdamW steps, finite losses, no flash launch.

The last two lines are the per-kernel JSON record and the device record.
"""

from __future__ import annotations

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
# Flash kernels vs their plain versions: both compute in fp32 and round
# once, so bf16 results differ by a flipped rounding (one or two bf16 ulps
# of max(1, |value|)); lse is fp32 in both, elementwise relative.
FLASH_TOL = 2e-2
LSE_REL_TOL = 1e-5
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


def _attn_err(got, want) -> tuple:
    err = (got.float() - want.float()).abs().max().item()
    tol = ATTN_TOL * max(1.0, want.float().abs().max().item())
    return err, tol


# ---------------------------------------------------------------- phase 1
def check_kernels() -> list:
    """Each kernel vs its plain version at flagship shapes; returns records."""
    import torch

    from multimodalanalytical_tpu_torch.ops import beam_attention as ba
    from multimodalanalytical_tpu_torch.ops import decode_ffn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bk, flat_max = BATCH * BEAMS, MAX_LENGTH * BEAMS
    records = []

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    # #1 self-attention + in-place append, int8 and bf16 caches.
    q = randn(bk, D_MODEL)
    anc_full = torch.randint(0, BEAMS, (BATCH, BEAMS, MAX_LENGTH), generator=g,
                             device=dev, dtype=torch.int32)
    worst, timing = 0.0, {}
    for quantized in (True, False):
        if quantized:
            cache0 = torch.randint(-127, 128, (2, BATCH, flat_max, D_MODEL), generator=g,
                                   device=dev, dtype=torch.int8)
            scales0 = torch.rand(2, BATCH, HEADS, flat_max, generator=g, device=dev) * 0.05 + 1e-3
            k_new = torch.randint(-127, 128, (bk, D_MODEL), generator=g, device=dev,
                                  dtype=torch.int8)
            v_new = torch.randint(-127, 128, (bk, D_MODEL), generator=g, device=dev,
                                  dtype=torch.int8)
            k_s = torch.rand(bk, HEADS, generator=g, device=dev) * 0.05 + 1e-3
            v_s = torch.rand(bk, HEADS, generator=g, device=dev) * 0.05 + 1e-3
        else:
            cache0, scales0 = randn(2, BATCH, flat_max, D_MODEL), None
            k_new, v_new, k_s, v_s = randn(bk, D_MODEL), randn(bk, D_MODEL), None, None
        for stage in (32, 128):
            for pos in (0, 17, stage - 1):
                anc_full[:, :, pos] = torch.arange(BEAMS, device=dev, dtype=torch.int32)
                anc = anc_full[:, :, :stage]
                outs, stores = [], []
                for fn in (ba.beam_select_attention_update, ba.beam_select_attention_update_plain):
                    cache = cache0.clone()
                    scales = scales0.clone() if quantized else None
                    outs.append(fn(q, k_new, v_new, cache, anc, pos, HEADS, scales, k_s, v_s))
                    stores.append((cache, scales))
                torch.cuda.synchronize()
                err, tol = _attn_err(outs[0], outs[1])
                rows_equal = torch.equal(stores[0][0], stores[1][0]) and (
                    not quantized or torch.equal(stores[0][1], stores[1][1]))
                kind = "int8" if quantized else "bf16"
                print(f"kernel beam_select_attention_update {kind} L={stage} pos={pos}: "
                      f"max_abs_err={err:.3e} tol={tol:.3e} cache_rows_equal={rows_equal}",
                      flush=True)
                _require(err <= tol, "beam_select_attention_update disagrees with its plain version")
                _require(rows_equal, "beam_select_attention_update appended other rows/scales")
                worst = max(worst, err)
                if pos == stage - 1:
                    cache, scales = cache0.clone(), scales0.clone() if quantized else None
                    args = (q, k_new, v_new, cache, anc, pos, HEADS, scales, k_s, v_s)
                    ms = _time_ms(lambda: ba.beam_select_attention_update(*args))
                    plain_ms = _time_ms(lambda: ba.beam_select_attention_update_plain(*args))
                    timing[(kind, stage)] = (ms, plain_ms)
                    print(f"time beam_select_attention_update {kind} L={stage} pos={pos}: "
                          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    ms, plain_ms = timing[("int8", 128)]
    records.append({"name": "beam_select_attention_update", "route": "cuda",
                    "source": "multimodalanalytical_tpu_torch/csrc/beam_attention.cu",
                    "replaces": "multimodalanalytical_tpu/ops/beam_attention.py:570",
                    "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                    "timed_at": "int8 cache, L=128, pos=127"})

    # #2 cross-attention with padded keys (row 0 fully masked, as batch
    # padding rows are).
    ls = FORMULA_LEN + N_PATCHES
    qx, kx, vx = randn(bk, D_MODEL), randn(BATCH, ls, D_MODEL), randn(BATCH, ls, D_MODEL)
    valid = torch.randint(ls - 8, ls + 1, (BATCH, 1), generator=g, device=dev)
    keep = torch.arange(ls, device=dev)[None, :] < valid
    keep[0] = False
    bias = torch.where(keep, 0.0, -1e9).float()
    got = ba.beam_cross_attention(qx, kx, vx, bias, HEADS, BEAMS)
    want = ba.beam_cross_attention_plain(qx, kx, vx, bias, HEADS, BEAMS)
    err, tol = _attn_err(got, want)
    ms = _time_ms(lambda: ba.beam_cross_attention(qx, kx, vx, bias, HEADS, BEAMS))
    plain_ms = _time_ms(lambda: ba.beam_cross_attention_plain(qx, kx, vx, bias, HEADS, BEAMS))
    print(f"kernel beam_cross_attention Ls={ls}: max_abs_err={err:.3e} tol={tol:.3e}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    _require(bool(torch.isfinite(got.float()).all()) and err <= tol,
             "beam_cross_attention disagrees with its plain version")
    records.append({"name": "beam_cross_attention", "route": "cuda",
                    "source": "multimodalanalytical_tpu_torch/csrc/beam_attention.cu",
                    "replaces": "multimodalanalytical_tpu/ops/beam_attention.py:536",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "timed_at": f"Ls={ls}"})

    # #3 decode FFN, ungated (flagship) and gated.
    x = randn(bk, D_MODEL)
    w1, wg, w2 = randn(FFN, D_MODEL, scale=0.05), randn(FFN, D_MODEL, scale=0.05), randn(
        D_MODEL, FFN, scale=0.03)
    b1, bg, b2 = randn(FFN, scale=0.1), randn(FFN, scale=0.1), randn(D_MODEL, scale=0.1)
    worst, times = 0.0, {}
    for gated in (False, True):
        args = (x, w1, b1, wg if gated else None, bg if gated else None, w2, b2)
        got = decode_ffn.geglu_ffn(*args)
        want = decode_ffn.geglu_ffn_plain(*args)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / max(want.float().abs().max().item(), 1e-6)
        ms = _time_ms(lambda: decode_ffn.geglu_ffn(*args))
        plain_ms = _time_ms(lambda: decode_ffn.geglu_ffn_plain(*args))
        times[gated] = (ms, plain_ms)
        print(f"kernel geglu_ffn gated={gated} M={bk} D={D_MODEL} F={FFN}: max_abs_err={err:.3e} "
              f"rel={rel:.3e} tol={FFN_REL_TOL}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
              flush=True)
        _require(rel <= FFN_REL_TOL, "geglu_ffn disagrees with its plain version")
        worst = max(worst, err)
    records.append({"name": "geglu_ffn", "route": "cuda",
                    "source": "multimodalanalytical_tpu_torch/csrc/decode_ffn.cu",
                    "replaces": "multimodalanalytical_tpu/ops/decode_ffn.py:68",
                    "max_abs_err": worst, "ms": times[False][0], "plain_ms": times[False][1],
                    "timed_at": f"ungated, M={bk} D={D_MODEL} F={FFN}"})
    return records


def check_flash_kernels() -> list:
    """#5/#6 flash attention forward and backward vs their plain versions at
    the long RLE encoder's shapes; returns records."""
    import torch
    import torch.nn.functional as F

    from multimodalanalytical_tpu_torch.ops import flash_attention as flash

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    b, h, d = TRAIN_BATCH, HEADS, D_MODEL // HEADS
    pad = (-RLE_MAX_LEN) % flash.BLK
    length = RLE_MAX_LEN + pad
    q, k, v, dout = (F.pad(torch.randn(b, h, RLE_MAX_LEN, d, generator=g, device=dev),
                           (0, 0, 0, pad)).bfloat16() for _ in range(4))
    valid = torch.randint(RLE_MIN_LEN, RLE_MAX_LEN + 1, (b, 1), generator=g, device=dev)
    valid[0] = RLE_MAX_LEN
    keep = torch.arange(length, device=dev)[None, :] < valid
    bias = torch.where(keep, 0.0, flash.NEG_INF).float()
    shape = f"B {b}, H {h}, L {RLE_MAX_LEN} (padded to {length}), Dh {d}, bf16"

    out, lse = flash.flash_attention_fwd(q, k, v, bias)
    want_out, want_lse = flash.flash_attention_fwd_plain(q, k, v, bias)
    grads = flash.flash_attention_bwd(q, k, v, bias, out, lse, dout)
    want_grads = flash.flash_attention_bwd_plain(q, k, v, bias, out, lse, dout)
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out,) + grads,
                               (want_out,) + want_grads):
        err = (got.float() - want.float()).abs().max().item()
        peak = want.float().abs().max().item()
        tol = FLASH_TOL * max(1.0, peak)
        finite = bool(torch.isfinite(got.float()).all())
        print(f"kernel flash {name} {shape}: max_abs_err={err:.3e} tol={tol:.3e} "
              f"max|plain|={peak:.3e}", flush=True)
        _require(finite and peak > 0 and err <= tol,
                 f"flash {name} disagrees with its plain version")
        errs[name] = err
    lse_err = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
    print(f"kernel flash lse {shape}: max_rel_err={lse_err:.3e} tol={LSE_REL_TOL:.1e}",
          flush=True)
    _require(lse_err <= LSE_REL_TOL, "flash lse disagrees with its plain version")

    fwd = (lambda: flash.flash_attention_fwd(q, k, v, bias),
           lambda: flash.flash_attention_fwd_plain(q, k, v, bias))
    bwd = (lambda: flash.flash_attention_bwd(q, k, v, bias, out, lse, dout),
           lambda: flash.flash_attention_bwd_plain(q, k, v, bias, out, lse, dout))
    records = []
    for name, fns, line, err in (
            ("flash_attention_fwd", fwd, 115, errs["out"]),
            ("flash_attention_bwd", bwd, 204, max(errs["dq"], errs["dk"], errs["dv"]))):
        ms, plain_ms = _time_ms(fns[0], iters=10), _time_ms(fns[1], iters=10)
        print(f"time {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        records.append({"name": name, "route": "cuda",
                        "source": "multimodalanalytical_tpu_torch/csrc/flash_attention.cu",
                        "replaces": f"multimodalanalytical_tpu/ops/flash_attention.py:{line}",
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "timed_at": shape})
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
    with a bf16 and with an int8 cache."""
    import torch

    from multimodalanalytical_tpu_torch.generation.beam_search import decode_model

    dev = torch.device(DEVICE)
    batch, steps = 8, 8
    inputs, mask = _request(seed=99, batch=batch)
    inputs = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
    mask = torch.as_tensor(mask, device=dev)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(4, VOCAB, (batch, BEAMS, steps), generator=g).to(dev)
    anc = torch.randint(0, BEAMS, (batch, BEAMS, steps), generator=g, dtype=torch.int32).to(dev)
    with torch.no_grad():
        hidden = model.encode(inputs, mask)
        for quantize in (False, True):
            logits = []
            for m in (model, plain_model):
                dm = decode_model(m)
                cache = dm.init_beam_cache(batch, BEAMS, steps, hidden, quantize)
                out = []
                for t in range(steps):
                    a = anc.clone()
                    a[:, :, t] = torch.arange(BEAMS, device=dev, dtype=torch.int32)
                    out.append(dm.beam_decode_step(tokens[:, :, t], t, cache, a, mask))
                logits.append(torch.stack(out).float())
            err = (logits[0] - logits[1]).abs().max().item()
            tol = LOGIT_TOL * max(1.0, logits[1].abs().max().item())
            print(f"teacher-forced logits {'int8' if quantize else 'bf16'} cache, kernel vs "
                  f"plain path: max_abs_err={err:.3e} tol={tol:.3e}", flush=True)
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


def run_training_slice() -> dict:
    """Phase 3; returns the flash kernels' launch counts of the fit."""
    import math

    import torch

    from multimodalanalytical_tpu_torch.training import Trainer

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

    model = _rle_model(dropout=0.1, use_flash=True)
    trainer = Trainer(model, optimiser="adamw", lr=TRAIN_LR, num_steps=TRAIN_STEPS,
                      clip_grad=1.0)
    counters = _flash_counters()
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = trainer.fit([batch], max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"train fit: {TRAIN_STEPS} AdamW steps, B {TRAIN_BATCH}, dropout 0.1: "
          f"{seconds:.4f} s/step ({real_tokens / seconds:.1f} encoder tokens/s real, "
          f"{padded_tokens / seconds:.1f} padded); losses {[round(x, 4) for x in losses]}; "
          f"launches {launches}", flush=True)
    _require(all(math.isfinite(x) for x in losses), "non-finite training loss")
    _require(losses[-1] < losses[0], "the training loss did not fall")
    for name, count in launches.items():
        _require(count == LAYERS * TRAIN_STEPS,
                 f"{name} launched {count} times, want {LAYERS * TRAIN_STEPS}")
    del model, trainer
    torch.cuda.empty_cache()
    return launches


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
    losses = trainer.fit([batch], max_steps=IR_RECIPE_STEPS)
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

    records = check_kernels() + check_flash_kernels()
    launches = run_slice()
    launches.update(run_training_slice())
    run_ir_recipe()
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
