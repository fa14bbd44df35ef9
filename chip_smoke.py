#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port's serving, training and evaluation paths.

    python3 chip_smoke.py                  # the checks below
    python3 chip_smoke.py --profile-eval   # phase 5's decodes and a serving request, profiled
    python3 chip_smoke.py --profile-train [eager|graph]  # phases 3 and 4's train steps, profiled
    python3 chip_smoke.py --time-ffn       # the decode FFN's times alone (one JSON line)
    python3 chip_smoke.py --time-cross     # cross attention and SDPA, device times (one JSON line)
    python3 chip_smoke.py --tensor-parallel  # phase 11 alone
    python3 chip_smoke.py --eval-path      # phase 5 alone
    python3 chip_smoke.py --time-host-copies  # the parts of a save's host copy, timed
    python3 chip_smoke.py --dp-rank SPEC   # one rank of phase 10's two-rank fit (the script starts it)
    python3 chip_smoke.py --tp-rank SPEC   # one rank of phase 11's tensor-parallel pair (likewise)

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
   FFN at M 128, 1280 and 3840, gated and ungated (held to FFN_REL_TOL and
   FFN_RMS_TOL, two calls bit-equal, a planted fault that skips one 64-deep
   stage of F rejected, eager and device times in turns with the cuBLAS
   route), and its partial mode (a tensor-parallel rank's fp32 down product
   without b2) at M 1280, D 512, F 1024 beside the full mode on the same
   shard, with its own planted fault; the read-only select attention at B 128,
   L 128, pos 127, K 10 and 30, int8 and bf16 caches. Decode attention is
   held to ATTN_TOL in max error and ATTN_RMS_TOL in error norm, the
   update's appended int8 rows and scales bit for bit to
   ``quantize_kv_heads`` of the same bf16 rows, and the check is shown to
   reject planted faults at pos 17 of a 32-time stage and pos 127 of the
   128-time one (a time's rows left out, the fresh row left out, slot n
   read in place of the ancestry's, a valid key dropped); every kernel's
   "ms" is its eager per-call time, and the decode attention kernels also
   carry their device time ("device_ms", CUDA-graph replays), cross
   attention timed both ways in turns with SDPA; fused dropout (rate
   0.1, bf16) at the train-site shapes (128, 48, 512), (128, 48, 2048) and
   (8, 4090, 512), bit for bit, forward and backward (also against
   ``ops/dropout.py``'s time); the flash attention forward and backward at
   the long RLE encoder's (B 8, H 8, L 4090 padded to 4096, head_dim 64,
   bf16, ragged key masks) and at head_dim 128 (B 8, H 4), 192 (B 8, H 4)
   and 256 (B 8, H 2), two backward calls bit-equal, the check shown to
   reject the kernels with one key stage left out, timed in turns with
   ``scaled_dot_product_attention`` (the yardstick; the port never calls
   it), whose backend's kernels are printed;
2. serving: the flagship CustomModel (6 + 6 layers, bf16, int8 KV cache,
   seeded random weights) decodes 8 teacher-forced steps through the
   kernels and through ``use_beam_kernel=False`` at K 1, 10 and 30 (logits
   within LOGIT_TOL); its ``InferenceEngine``, built with a collator as the
   serve CLI builds it, decodes a warm batch in its constructor, so the
   first request must capture nothing (``capture_s`` and ``warmup_steps``
   0; its wall time printed beside the steady one); then it answers three
   seeded 128-spectrum requests (Formula 12 tokens + IR 14 x 125) through
   ``InferenceEngine.decode_batch`` at beam 10 and max length 128, each
   decode stage a replayed CUDA graph.
   Every decode kernel's launch count must equal 6 x the graph replays
   (each replay adds what its capture recorded). The same requests then run
   through the eager loop (``cuda_graph=False``: the same step, launched
   eagerly), bit-equal and timed; a model whose lm_head bias favours EOS
   (EXIT_EOS_BIAS) must exit early, graphs and eager loop bit-equal; then
   ``use_beam_kernel=False`` for the time and top-1 agreement;
3. training, long sequences: the flagship-width model on one run-length-
   encoded IR source (vocabulary 105, rows of 2173-4090 tokens padded to
   4090) -> SMILES (vocab 320, up to 128 tokens), B 8, seeded weights and
   batch. One dropout-0 step of the flash route against the
   ``use_flash_attention=False`` route (loss and gradient norm), then
   ``Trainer.fit`` takes 10 AdamW steps (dropout 0.1, clip 1.0) on the
   repeated batch on each train-step route in turns (ROUTE_TURNS: the eager
   body, ``cuda_graph=False``, and the step replayed from its CUDA graph):
   every step's metrics and the final parameters and Adam moments
   bit-equal across routes, every loss finite, the last below the first,
   and each flash kernel launched 6 x the steps (a replay adds what its
   capture recorded); then the same fits (eager, graph) with every dropout
   site routed through fused dropout (this script's substitution, as
   ``benchmarks/exp_remat.py`` routes the JAX sites), launched forward and
   backward at every site of every step; s/step of steps 2-10 and 3-10,
   the capture's seconds, the graph pool and the peak memory of each;
4. training, the flagship IR recipe (Formula + IR patches, B 128): ten
   AdamW steps on each train-step route in turns, bit-equal at every step,
   s/step of steps 2-10 and 3-10, the capture's seconds and the graph
   pool's bytes; three more steps of each route profiled for the busy
   share and the kernels and launches per step; no flash launch;
5. evaluation: the flagship model, 640 seeded spectra (384 train, 128
   validation, 128 test, real SMILES targets, a fixed-vocabulary stand-in
   for the target tokenizer: the card's machine has no ``tokenizers``).
   (a) ``Trainer.fit`` takes 2 epochs (6 AdamW steps at B 128) with
   validation (greedy K 1 decode) every epoch and a ``CheckpointManager``,
   four times from the same seeded weights: with a planted fault first (a
   snapshot that hands over the live tensors, copied after the next step),
   then with asynchronous saves (the trainer's route) and with synchronous
   ones (``save_async`` made ``wait`` then ``save``), each replaying the
   train step's graph, and with asynchronous saves on the eager body
   (``cuda_graph=False``), whose checkpoints must be bit-equal to the graph
   route's; the main thread's
   seconds in each ``save_async``, the end-of-fit drain, each step's host
   seconds and each fit's wall time are printed; ``last``, ``best``, every
   ``step_N`` and the index of the asynchronous route must be bit-equal to
   the synchronous route's, the planted fault's must not; ``best`` is
   restored into a fresh model bit for bit; two more requests to the
   asynchronous fit's manager, each drained, print the main thread's
   seconds once the manager holds its pinned buffers and must write the
   trainer's weights; ``predict`` decodes the test spectra at
   beam 30, scored with rejection sampling off and on (the mixture paper's
   Table 4 recipe); (b) predict at K 30 and (c) validation over 4 more
   batches of 128 at the trainer's ``PIPELINE_DEPTH`` 0 and 8 (the module
   constant patched), in turns: s/batch, device time, busy share, replays
   and the calling thread's host seconds by part, every result equal to
   depth 0's. Every decode kernel's launches must equal 6 x the graph
   replays and capture warm-up steps of phase 5's decodes; one batch of
   each also through the eager loop, bit-equal;
6. guided decoding: phase 5's restored model predicts at beam 10 with the
   surrogate formula guide (inside the captured step) on the corpus
   targets, graphs against the eager loop bit for bit, every finished beam
   within rule 3's heavy-atom bound; the exact guide (one host call per
   step, eager by design) on one batch;
7. the multimodal recipe (configs/data/multimodal/multimodal.yaml on
   configs/model/custom_model.yaml): Formula 12 + multiplets 189 + carbon
   54 + IR 24 x 75 = Ls 279 -> SMILES, seeded token ids at the widths the
   preprocessors' fit rules give (MM_DATA_CONFIG). Three seeded 128-spectrum
   requests through ``InferenceEngine.decode_batch`` at beam 10 through the
   decode graphs (capture apart), every decode kernel launched 6 x the
   replays, bit-equal to the eager loop, with s/batch, device time, busy
   share and the kernel split; one dropout-0 train step of the bf16 model
   against its fp32 twin, three AdamW steps at B 128 with modality dropout
   over the dict-aware segments; the multiplets as XVal dicts through the
   forward and a train step;
8. the align recipe (configs/model/custom_model_align.yaml on
   configs/data/ir/patches_mixture_text_align.yaml): ``Trainer.fit`` takes
   6 AdamW steps at B 128 with one validation (K 1) and checkpoints; loss =
   ce + 50 x alignment_loss at every step, the alignment loss above 0 and
   falling, ``best`` restored bit for bit with the align network, dummy
   rows leaving the align loss unchanged.

9. every shipped BART / T5 model config (PRESET_MODEL_CONFIGS: bart_medium,
   hf_bart_medium, custom_hf_bart, t5_small, dict literals equal to their
   YAML files), resolved by the port at vocab 320 on Formula 12 + IR 14 x
   125 (each at d_model 512, 6 + 6 layers, 8 heads, FFN 2048): one seeded
   128-spectrum request at beam 10 through ``InferenceEngine.decode_batch``
   on the decode graphs (capture apart) and through the eager loop,
   bit-equal, with s/batch, device time, busy share and steps; #1-#3
   launched 6 x the replays for the three BART configs, never for t5_small
   (the JAX package's route: no scale, a relative bias), whose plain route's
   share of device time is printed; T5's relative buckets on the card equal
   to the CPU's for offsets -4096..4096; the reference's executed HF BART
   and T5 graphs (tests/golden/reference_model_goldens.npz) through
   ``load_reference_state_dict`` in fp32 with TF32 off, at the JAX test's
   tolerances; the checkpoint converter run on a Lightning-shaped ``.ckpt``
   of the T5 golden, restored by ``load_finetune_params``, logits bit-equal
   to the direct load; and for hf_bart_medium and t5_small one dropout-0
   train step in bf16 against fp32 and three AdamW steps at B 128 (finite,
   falling loss); the phase's peak device memory.

10. the mixture paper's Table 1 recipe (ALIGN_MODEL_CONFIG, MIX_DATA_CONFIG:
   custom_model_align on ir/patches_mixture_text_align, Formula 12 + IR 24 x
   75 -> SMILES with the pure spectrum as align target) with mixture=ir/binary
   and then ir/multitask (normalize over 5 modes), on a seeded pool of 38,000
   synthetic 1791-point spectra (phase 5's corpus as targets, stand-in
   tokenizers), built by the entry points' own calls (``build_loaders``,
   ``try_build_device_mixture``, ``build_model``): (a) the first 4 premixed
   B 128 batches on the card equal the host collator's batches of the same
   samples (ids, masks, labels bit for bit; patches and align target within
   MIX_FLOAT_TOL of their largest magnitude); ``Trainer.fit`` takes 6 AdamW
   steps in fp32 (dropout 0) on the device route and on the host generator,
   losses within MIX_FIT_RTOL; the recipe in bf16 on both routes for s/step,
   each through the train step's graph and again on its eager body
   (bit-equal), the device route with one validation (K 1) through the decode graphs,
   #1-#3 launched 6 x its replays; the loaders' host ms per batch, the pool
   bytes and the peak memory; (b) a world-1 NCCL process group drives the
   fp32 device-route fit again through the train step's graph (a data
   group of one rank runs no collective, so this graph holds none;
   ``tests/test_torch_cuda.py`` captures NCCL all-reduces in a train
   step on a forced two-rank data mesh), bit-equal to the fit with no group (cuDNN's
   deterministic algorithms for the phase), and DP_RANKS processes of this
   script (``--dp-rank``) share the card over gloo, whose train step runs
   eagerly (printed), on the host route (the
   device route refused there, as in the JAX package) at the same global
   batch, held to the one-process fit as DP_RTOL says, with their s/step and
   the gradient all-reduce's ms per step.

11. tensor parallelism (``run_tensor_parallel``): the flagship at full
   width on the (1, 2) layout, two ranks of this script (``--tp-rank``)
   sharing the card over gloo, against one process on the same weights:
   one fp32 AdamW step of the IR recipe at B 128 on the eager body (gloo's
   collectives are not captured; printed) (loss within TP_LOSS_TOL,
   gathered parameters within TP_PARAM_RTOL / TP_PARAM_ATOL), then bf16
   with the int8 cache at K 10: teacher-forced logits within LOGIT_TOL and
   phase 2's three requests decoded with eager steps (gloo collectives are
   not captured), every row's top beam rescored by the one-process model
   within TP_SCORE_TOL of its score; #1, #2 and #3 (partial mode) launched
   6 x the steps
   on each rank; s/step, s/request, the model all-reduces' ms and the peak
   memory per rank.

12. serving an RLE model (``run_rle_serving``): phase 3's flagship-width
   RLE model (bf16, int8 KV cache, seeded weights) behind an
   ``InferenceEngine`` built with a collator over RLE_DATA_CONFIG (its
   warm batch, a record without a spectrum, is a fully masked 4090-token
   row), three seeded 128-spectrum requests (rows of 2173-4090 tokens
   padded to 4090, one full, one fully padded) at beam 10 and max length
   128 through the decode graphs: #1-#3 launched 6 x the replays, flash #5
   6 x the requests (the encoder at L >= 2048), bit-equal to the eager
   loop; s/batch (the first request beside the steady ones), device time,
   busy share, #2's share of it, the encoder's ms and the peak memory
   with its parts (held between requests, a standalone encode, #2's
   workspace).

Phase 1 also holds #2's split form at the multimodal encoder's Ls 279 and
at an RLE encoder's Ls 4090 (B 128, K 1, 10 and 30; rows fully masked,
rows with a masked first tile or with every later tile masked) against
its plain version, two calls bit-equal, rejects one tile left out and one
tile's stats dropped, and times it beside SDPA; and times fused dropout beside
``torch.nn.functional.dropout``. It also times #1 at positions 33, 96 and 127 of a 128-time stage,
planned for the stage (as the decode loop launches it) and for pos + 1
times. ``--profile-eval`` prints, per decode path, the wall and device
time, the busy share, the host's ms per decode step and the launches per
step as the host makes them, beside the eager loop's (EAGER_LOOP_PROFILE).

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
# Decode attention (#1, #2, #4) vs its plain version: max|kernel - plain| <=
# ATTN_TOL * max(1, max|plain|) and |kernel - plain|_2 <= ATTN_RMS_TOL *
# |plain|_2. A correct kernel differs by bf16 rounding (probabilities and
# outputs rounded after fp32 sums taken in another order), 1e-5 to 5e-5 in
# norm; the norm is what catches a kernel that drops or misreads one time's
# rows (phase 1 plants such faults at pos 17 of a 32-time stage and at pos
# 127 of the 128-time stage, where one row weighs ~1/128 of the softmax, and
# requires the check to reject them).
ATTN_TOL = 2e-2
ATTN_RMS_TOL = 1e-3
FAULT_POSITIONS = {32: 17, 128: 127}   # stage -> pos
# "ms" of every kernel is the eager back-to-back time of its wrapper, as the
# decode path calls it (CUDA events; the wrappers' host dispatch paces it
# wherever the kernel is shorter). The decode attention kernels also carry
# "device_ms", their device time alone:
DEVICE_MS_IS = "device time: 20 calls in one CUDA graph, replayed 5 times between CUDA events"
# Decode FFN (#3) vs its plain version: max|kernel - plain| <= FFN_REL_TOL *
# max|plain| and |kernel - plain|_2 <= FFN_RMS_TOL * |plain|_2. A correct
# kernel differs by bf16 roundings of the activation and the output after
# fp32 sums taken in another order; the norm is what catches a down product
# that leaves out one 64-deep stage of F (FFN_FAULT_STAGE, planted in phase 1
# and required to be rejected).
FFN_REL_TOL = 0.02
FFN_RMS_TOL = 1e-2
FFN_FAULT_STAGE = 17
FFN_PARTIAL_FAULT_STAGE = 7        # of the 16 stages of a rank's F 1024 (phase 1, partial mode)
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
FLASH_KEY_STAGE = {64: 128, 128: 64, 192: 64, 256: 64}
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
IR_RECIPE_BATCH, IR_RECIPE_STEPS = 128, 10
# The train-step routes in turns within a call (phases 3 and 4): the eager
# body (cuda_graph=False), the replayed graph, the graph, the eager body.
ROUTE_TURNS = (False, True, True, False)
PROFILED_STEPS = 3             # phase 4: steps under torch.profiler per route, for the busy share
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

# The multimodal recipe (phases 1 and 7): configs/data/multimodal/multimodal.yaml,
# Formula + 1H-NMR multiplets + 13C-NMR peaks + IR -> SMILES. Token ids come
# from seeded numpy (the card's machine has no ``tokenizers``), at the widths
# the preprocessors' fit rules give the recipe's data: multiplets (encoding
# text) hold 4-32 multiplets of 5 tokens each, padded to the longest row's
# spaces + 30 (data/preprocessing/multiplets.py: 159 + 30 = 189); carbon rows
# hold 5-40 peaks, padded to spaces + 15 (data/preprocessing/carbon.py: 39 +
# 15 = 54); the IR spectrum's 1791 points are 24 patches of 75. Vocabularies:
# multiplets 1400 (the ppm grid 0.00-13.00 by 0.01, the categories, the nH
# tokens, the specials), carbon 2310 (the ppm grid 0.0-230.0 by 0.1 and the
# specials).
MM_FORMULA, MM_MULTIPLETS, MM_CARBON, MM_PATCHES, MM_PATCH = 12, 189, 54, 24, 75
MM_MULTIPLETS_PER_ROW, MM_PEAKS_PER_ROW = (4, 32), (5, 40)
MM_LS = MM_FORMULA + MM_MULTIPLETS + MM_CARBON + MM_PATCHES     # 279 encoder tokens
MM_DATA_CONFIG = {
    "Formula": DATA_CONFIG["Formula"],
    "Multiplets": {"type": "multiplets", "column": "h_nmr_peaks", "target": False,
                   "vocab_size": 1400, "pad_token_id": 0,
                   "preprocessor_arguments": {"encoding": "text"}},
    "Carbon": {"type": "carbon", "column": "c_nmr_peaks", "target": False,
               "vocab_size": 2310, "pad_token_id": 0, "preprocessor_arguments": {}},
    "IR": {"type": "1D_patches", "column": "ir_spectra", "target": False,
           "preprocessor_arguments": {"patch_size": MM_PATCH}},
    "Smiles": DATA_CONFIG["Smiles"],
}
MM_ORDER = list(MM_DATA_CONFIG)
MM_TRAIN_STEPS = 3
MM_MODALITY_DROPOUT = ["Multiplets", "Carbon", "IR"]
# The multimodal model's dropout-0 train step, bf16 against the same weights
# in fp32: bf16 rounding of every product through 6 + 6 layers.
MM_LOSS_RTOL, MM_GRAD_NORM_RTOL = 1e-2, 5e-2
# The align recipe (phase 8): configs/model/custom_model_align.yaml (the
# convolutional head: hidden 256, 512 channels, kernel 5, output 1800, loss
# lambda 50, mae) on configs/data/ir/patches_mixture_text_align.yaml (Formula
# + IR 24 x 75 -> SMILES, the pure component's 1800-point spectrum as the
# align target), B 128.
ALIGN_CONFIG = {"align_network": "convolutional", "hidden_dimension": 256,
                "conv_channels": 512, "kernel_size": 5, "output_dimension": 1800,
                "loss_lambda": 50.0, "loss_function": "mae"}
ALIGN_DATA_CONFIG = {"Formula": DATA_CONFIG["Formula"], "IR": MM_DATA_CONFIG["IR"],
                     "Smiles": DATA_CONFIG["Smiles"]}
ALIGN_STEPS, ALIGN_DUMMIES = 6, 28
# loss = ce + lambda * alignment_loss, all three fp32 scalars.
ALIGN_IDENTITY_RTOL = 1e-6
# The align loss of a batch with dummy rows against the batch without them:
# the encoder runs at another batch size (other cuBLAS tiles, bf16 roundings
# in another order), so the two agree to bf16 rounding averaged over the
# rows, not bit for bit; dummies whose contents differ at the same size must
# give the same bits.
ALIGN_DUMMY_RTOL = 1e-3


# Phase 9: the shipped BART and T5 model configs, as dict literals equal to
# configs/model/<name>.yaml (the card's machine has no yaml;
# tests/test_torch_presets.py holds each equal to the file as the config
# loader composes it).
_PRESET_COMMON = {
    "multimodal_norm": True, "adam_beta1": 0.9, "adam_beta2": 0.999,
    "model_checkpoint_path": None, "batch_size": 128, "cv_split": 0,
    "guided_generation": False, "max_position_embeddings": 1024, "align_config": None,
    "n_beams": 10, "rejection_sampling": False, "dtype": "bfloat16",
    "use_flash_attention": True, "weight_decay": 0.0, "lr": 1.0e-4,
}
_PRESET_WIDTHS = {
    "d_model": 512, "encoder_attention_heads": 8, "decoder_attention_heads": 8,
    "encoder_layers": 6, "decoder_layers": 6, "encoder_ffn_dim": 2048,
    "decoder_ffn_dim": 2048,
}
PRESET_MODEL_CONFIGS = {
    "bart_medium": {
        "model_type": "BartForConditionalGeneration", **_PRESET_WIDTHS,
        "final_layer_norm": True, "positional_encoding_type": "sin_cos",
        "gated_linear": False, "post_layer_normalisation": True, "optimiser": "adamw",
        **_PRESET_COMMON},
    "hf_bart_medium": {
        "model_type": "BartForConditionalGeneration", "model_name": "facebook/bart-base",
        **_PRESET_WIDTHS, "optimiser": "adam", **_PRESET_COMMON},
    "custom_hf_bart": {
        "model_type": "CustomBartForConditionalGeneration", **_PRESET_WIDTHS,
        "final_layer_norm": False, "positional_encoding_type": "sin_cos",
        "gated_linear": False, "post_layer_normalisation": True, "optimiser": "adam",
        **_PRESET_COMMON},
    "t5_small": {
        "model_type": "T5ForConditionalGeneration", "model_name": "google-t5/t5-small",
        "optimiser": "adam", **_PRESET_COMMON},
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


def _device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events, so that the host's dispatch
    (the wrappers' Python and ctypes time) does not pace the launches, as
    it does in :func:`_time_ms` for a kernel shorter than its dispatch."""
    import torch

    fn()                                       # build, shared-memory limit, allocator
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


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
    slots select at times 0..pos (0..pos-1 for the update, whose time-pos
    rows are this step's), q, the ancestry, the output, and for the update
    this step's bf16 K/V rows read and appended to the cache (int8 rows and
    scales, or bf16 rows)."""
    import torch

    batch, beams, _ = anc.shape
    times = pos if update else pos + 1
    slot = anc[:, :, :times].long()
    # distinct beams selected at each (row, time)
    present = torch.zeros(batch, times, beams, dtype=torch.bool, device=anc.device)
    present.scatter_(2, slot.permute(0, 2, 1), True)
    rows = int(present.sum())
    row_bytes = D_MODEL * (1 if quantized else 2) + (HEADS * 4 if quantized else 0)
    qo = 2 * batch * beams * D_MODEL * 2
    fresh = 2 * batch * beams * (D_MODEL * 2 + row_bytes) if update else 0
    return 2 * rows * row_bytes + qo + anc[:, :, : pos + 1].numel() * 4 + fresh


def _attn_err(got, want) -> tuple:
    """(max|got - want|, its limit, |got - want|_2 / |want|_2, whether both
    are within ATTN_TOL / ATTN_RMS_TOL and got is finite)."""
    import torch

    diff = got.float() - want.float()
    err = diff.abs().max().item()
    tol = ATTN_TOL * max(1.0, want.float().abs().max().item())
    rms = (diff.norm() / want.float().norm()).item()
    ok = bool(torch.isfinite(got.float()).all()) and err <= tol and rms <= ATTN_RMS_TOL
    return err, tol, rms, ok


def _rejected(name: str, faults: dict, want) -> None:
    """Each planted fault's output must fail the check against ``want``;
    prints (max_err / its limit, relative error norm) of each."""
    caught = {}
    for fault, got in faults.items():
        err, tol, rms, ok = _attn_err(got, want)
        caught[fault] = (not ok, round(err / tol, 3), round(rms, 4))
    print(f"kernel {name} planted faults: rejected (max_err / limit, rel_rms_err) {caught}",
          flush=True)
    _require(all(c[0] for c in caught.values()), f"the {name} check passes a planted fault")


def _select_faults(q, cache, scales, anc, pos: int) -> dict:
    """Outputs of select attention with one time's rows dropped or misread,
    from the plain math on the cache after this step's append: time 0 left
    out of every beam, the fresh row at pos left out, and (K > 1) slot n
    read in place of ancestry[b, n, 3]."""
    import torch

    from multimodalanalytical_tpu_torch.ops import beam_attention as ba

    beams = anc.shape[1]
    slot = anc[:, :, : pos + 1].long().clone()
    slot[:, :, pos] = torch.arange(beams, device=anc.device)
    shifted_scales = None if scales is None else scales[..., beams:]
    faults = {
        "time 0 left out": ba._attend_plain(q, cache[:, :, beams:], slot[:, :, 1:], HEADS,
                                            shifted_scales),
        f"fresh row at pos {pos} left out": ba._attend_plain(q, cache, slot[:, :, :pos], HEADS,
                                                            scales),
    }
    if beams > 1:
        misread = slot.clone()
        misread[:, :, 3] = torch.arange(beams, device=anc.device)
        faults["slot n read at time 3"] = ba._attend_plain(q, cache, misread, HEADS, scales)
    return faults


def _device_pos(pos: int):
    """A step index as the decode loop hands it to the kernels: a 0-d int32
    tensor on the card."""
    import torch

    return torch.tensor(pos, dtype=torch.int32, device=DEVICE)


# The select kernel reads the step index from device memory and plans its
# shared memory and grid for the whole stage, so that one captured decode
# step serves every step of a stage; a plan for pos + 1 times is what a
# launch that knows pos on the host would take.
SELECT_POSITIONS = (33, 96, 127)
SELECT_BY_POS_IS = ("device ms (CUDA-graph replay) of the update at pos p of a 128-time "
                    "stage (the decode loop's plan) and of a (p + 1)-time stage (the plan "
                    "sized for p + 1, as a launch that knew p on the host would size it)")


def _select_device_ms_by_pos(q, k_new, v_new, cache0, scales0, anc_full, kind, beams) -> dict:
    """#1's device time at SELECT_POSITIONS of a 128-time stage, beside the
    same launch planned for pos + 1 times (SELECT_BY_POS_IS)."""
    import torch

    from multimodalanalytical_tpu_torch.ops import beam_attention as ba

    out = {}
    for pos in SELECT_POSITIONS:
        anc_full[:, :, pos] = torch.arange(beams, device=anc_full.device, dtype=torch.int32)
        times = {}
        for plan, length in (("stage_128", 128), ("stage_pos+1", pos + 1)):
            cache = cache0.clone()
            scales = None if scales0 is None else scales0.clone()
            args = (q, k_new, v_new, cache, anc_full[:, :, :length], _device_pos(pos), HEADS,
                    scales)
            times[plan] = _device_ms(lambda: ba.beam_select_attention_update(*args))
            del cache, scales, args
        out[f"{kind} K={beams} pos={pos}"] = times
        print(f"time beam_select_attention_update {kind} K={beams} pos={pos}: device "
              f"{times['stage_128']:.4f} ms planned for the 128-time stage, "
              f"{times['stage_pos+1']:.4f} ms planned for {pos + 1} times", flush=True)
    return out


# ---------------------------------------------------------------- phase 1
def _cross_turns(qx, kx, vx, bias, beams: int) -> dict:
    """#2 and SDPA on the same inputs (SDPA the yardstick only: beams as
    query rows of their batch row, the key bias as an additive mask), each
    timed eagerly and as device time, in turns, twice: {"kernel", "sdpa",
    "kernel_device", "sdpa_device"} -> two times each."""
    import torch.nn.functional as F

    from multimodalanalytical_tpu_torch.ops import beam_attention as ba

    ls = kx.shape[1]
    qh = qx.reshape(BATCH, beams, HEADS, -1).transpose(1, 2)
    kh, vh = (t.reshape(BATCH, ls, HEADS, -1).transpose(1, 2) for t in (kx, vx))
    mask = bias[:, None, None, :].to(qx.dtype)

    def kernel():
        return ba.beam_cross_attention(qx, kx, vx, bias, HEADS, beams)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    turns = {"kernel": [], "sdpa": [], "kernel_device": [], "sdpa_device": []}
    for _ in range(2):
        for name, fn in (("kernel", kernel), ("sdpa", sdpa)):
            turns[name].append(_time_ms(fn, iters=50))
            turns[f"{name}_device"].append(_device_ms(fn, iters=50))
    return turns


def check_kernels() -> list:
    """Each decode kernel vs its plain version at the flagship widths and at
    every beam count the entry points run (DECODE_BEAMS); returns records,
    timed at serving's K 10 as in earlier runs, the other times beside."""
    import torch

    from multimodalanalytical_tpu_torch.ops import beam_attention as ba

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    records = []

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def randint8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def rand_scales(*shape):
        return torch.rand(*shape, generator=g, device=dev) * 0.05 + 1e-3

    # #1 self-attention + in-place append. An int8 cache takes this step's
    # rows as bf16, as the projection gives them: the kernel quantizes them,
    # and its appended rows and scales must equal quantize_kv_heads' bits.
    worst, timing, bounds, by_pos = 0.0, {}, {}, {}
    for beams, kinds in DECODE_BEAMS:
        bk, flat_max = BATCH * beams, MAX_LENGTH * beams
        q = randn(bk, D_MODEL)
        anc_full = torch.randint(0, beams, (BATCH, beams, MAX_LENGTH), generator=g,
                                 device=dev, dtype=torch.int32)
        k_new, v_new = randn(bk, D_MODEL), randn(bk, D_MODEL)
        for kind in kinds:
            quantized = kind == "int8"
            if quantized:
                cache0, scales0 = randint8(2, BATCH, flat_max, D_MODEL), rand_scales(
                    2, BATCH, HEADS, flat_max)
            else:
                cache0, scales0 = randn(2, BATCH, flat_max, D_MODEL), None
            for stage in (32, 128):
                for pos in sorted({0, FAULT_POSITIONS[32], stage - 1}):
                    anc_full[:, :, pos] = torch.arange(beams, device=dev, dtype=torch.int32)
                    anc = anc_full[:, :, :stage]
                    outs, stores = [], []
                    for fn in (ba.beam_select_attention_update,
                               ba.beam_select_attention_update_plain):
                        cache = cache0.clone()
                        scales = scales0.clone() if quantized else None
                        outs.append(fn(q, k_new, v_new, cache, anc, pos, HEADS, scales))
                        stores.append((cache, scales))
                    torch.cuda.synchronize()
                    err, tol, rms, ok = _attn_err(outs[0], outs[1])
                    rows_equal = torch.equal(stores[0][0], stores[1][0]) and (
                        not quantized or torch.equal(stores[0][1], stores[1][1]))
                    print(f"kernel beam_select_attention_update {kind} K={beams} L={stage} "
                          f"pos={pos}: max_abs_err={err:.3e} tol={tol:.3e} rel_rms_err="
                          f"{rms:.3e} tol={ATTN_RMS_TOL:.0e} appended_rows_and_scales_equal="
                          f"{rows_equal}", flush=True)
                    _require(ok, "beam_select_attention_update disagrees with its plain version")
                    _require(rows_equal, "beam_select_attention_update appended other rows/scales")
                    worst = max(worst, err)
                    if pos == FAULT_POSITIONS[stage]:
                        _rejected(f"beam_select_attention_update {kind} K={beams} L={stage} "
                                  f"pos={pos}", _select_faults(q, *stores[1], anc, pos), outs[1])
                    del outs, stores
                    if pos == stage - 1:
                        cache, scales = cache0.clone(), scales0.clone() if quantized else None
                        # The step index in device memory, as the decode loop passes it.
                        args = (q, k_new, v_new, cache, anc, _device_pos(pos), HEADS, scales)
                        plain_args = args[:5] + (pos,) + args[6:]
                        ms = _time_ms(lambda: ba.beam_select_attention_update(*args))
                        device_ms = _device_ms(lambda: ba.beam_select_attention_update(*args))
                        plain_ms = _time_ms(
                            lambda: ba.beam_select_attention_update_plain(*plain_args))
                        timing[f"{kind} K={beams} L={stage}"] = (ms, plain_ms, device_ms)
                        bound = _bound_ms(4 * BATCH * beams * (pos + 1) * D_MODEL,
                                          _select_bytes(anc, pos, quantized, update=True))
                        bounds[f"{kind} K={beams} L={stage}"] = bound
                        print(f"time beam_select_attention_update {kind} K={beams} L={stage} "
                              f"pos={pos}: kernel {ms:.4f} ms a call eagerly ({device_ms:.4f} "
                              f"ms device, CUDA graph), plain {plain_ms:.4f} ms, bound "
                              f"{bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / ms:.1f}% of "
                              f"bound eagerly, {100 * bound[0] / device_ms:.1f}% in device time",
                              flush=True)
                        del cache, scales, args
            by_pos.update(_select_device_ms_by_pos(q, k_new, v_new, cache0, scales0, anc_full,
                                                   kind, beams))
            del cache0, scales0
    ms, plain_ms, device_ms = timing[f"int8 K={BEAMS} L=128"]
    bound, bound_by = bounds[f"int8 K={BEAMS} L=128"]
    records.append({"name": "beam_select_attention_update", "route": "cuda",
                    "source": "multimodalanalytical_tpu_torch/csrc/beam_attention.cu",
                    "replaces": "multimodalanalytical_tpu/ops/beam_attention.py:570",
                    "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
                    "device_ms": device_ms, "device_ms_is": DEVICE_MS_IS,
                    "other_bounds_ms": {k: v[0] for k, v in bounds.items()},
                    "timed_at": f"int8 cache, K={BEAMS}, L=128, pos=127",
                    "other_times_ms_is": "(ms, plain_ms, device_ms)",
                    "other_times_ms": {k: list(v) for k, v in timing.items()},
                    "device_ms_by_pos_is": SELECT_BY_POS_IS, "device_ms_by_pos": by_pos})

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
        err, tol, rms, ok = _attn_err(got, want)
        print(f"kernel beam_cross_attention K={beams} Ls={ls}: max_abs_err={err:.3e} "
              f"tol={tol:.3e} rel_rms_err={rms:.3e} tol={ATTN_RMS_TOL:.0e}", flush=True)
        _require(ok, "beam_cross_attention disagrees with its plain version")
        # A planted fault: key 0 (valid in every row but the masked one)
        # dropped, as a kernel that skipped it would.
        dropped = bias.clone()
        dropped[:, 0] = -1e9
        _rejected(f"beam_cross_attention K={beams}",
                  {"key 0 dropped": ba.beam_cross_attention_plain(qx, kx, vx, dropped, HEADS,
                                                                  beams)}, want)
        worst = max(worst, err)
        turns = _cross_turns(qx, kx, vx, bias, beams)
        ms, library_ms, device_ms, library_device_ms = (
            sum(turns[x]) / 2 for x in ("kernel", "sdpa", "kernel_device", "sdpa_device"))
        plain_ms = _time_ms(lambda: ba.beam_cross_attention_plain(qx, kx, vx, bias, HEADS, beams))
        bounds[f"K={beams}"] = _bound_ms(
            4 * BATCH * beams * ls * D_MODEL,
            (2 * BATCH * beams + 2 * BATCH * ls) * D_MODEL * 2 + bias.numel() * 4)
        timing[f"K={beams}"] = (ms, plain_ms, library_ms, device_ms, library_device_ms)
        print(f"time beam_cross_attention K={beams} Ls={ls}: a call eagerly, in turns: kernel "
              f"{ms:.4f} ms {[round(x, 4) for x in turns['kernel']]}, SDPA {library_ms:.4f} ms "
              f"{[round(x, 4) for x in turns['sdpa']]} (no slower than SDPA: "
              f"{ms <= library_ms}); device, CUDA graphs, in turns: kernel {device_ms:.4f} ms "
              f"{[round(x, 4) for x in turns['kernel_device']]}, SDPA {library_device_ms:.4f} ms "
              f"{[round(x, 4) for x in turns['sdpa_device']]} (no slower than SDPA: "
              f"{device_ms <= library_device_ms}); plain {plain_ms:.4f} ms; bound "
              f"{bounds[f'K={beams}'][0]:.5f} ms ({bounds[f'K={beams}'][1]})", flush=True)
    ms, plain_ms, library_ms, device_ms, library_device_ms = timing[f"K={BEAMS}"]
    records.append({"name": "beam_cross_attention", "route": "cuda",
                    "source": "multimodalanalytical_tpu_torch/csrc/beam_attention.cu",
                    "replaces": "multimodalanalytical_tpu/ops/beam_attention.py:536",
                    "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bounds[f"K={BEAMS}"][0], "bound_by": bounds[f"K={BEAMS}"][1],
                    "library_ms": library_ms, "device_ms": device_ms,
                    "library_device_ms": library_device_ms, "device_ms_is": DEVICE_MS_IS,
                    "library": "torch.nn.functional.scaled_dot_product_attention, additive mask",
                    "timed_at": f"K={BEAMS}, Ls={ls}",
                    "other_times_ms_is": "(ms, plain_ms, library_ms, device_ms, "
                                         "library_device_ms)",
                    "other_times_ms": {k: list(v) for k, v in timing.items()}})

    return records


def _cross_tile(beams: int, ls: int) -> int:
    """Keys per tile of #2's plan at the slice's widths (the split form's
    unit of stats, of skipping and of its blocks)."""
    from multimodalanalytical_tpu_torch.ops import beam_attention as ba

    return ba.cross_plan(BATCH, beams, HEADS, D_MODEL // HEADS, ls, 2).tile_keys


def _cross_faults(qx, kx, vx, bias, beams: int, left_out: slice, dropped: slice) -> dict:
    """Plain-math outputs of #2 with a planted fault of the split form: the
    keys of one tile left out (as a value block that skipped a live tile
    would), and one tile's stats dropped from each row's max m and sum l
    (every key's P = exp(S - m) / l then taken over the other tiles' m and
    l, as a fold that missed that tile's stats would)."""
    import torch

    from multimodalanalytical_tpu_torch.ops import beam_attention as ba

    cut = bias.clone()
    cut[:, left_out] = -1e9
    batch, ls, _ = kx.shape
    head_dim = D_MODEL // HEADS
    qh = (qx.float() * head_dim ** -0.5).to(kx.dtype).float().reshape(batch, beams, HEADS,
                                                                      head_dim)
    logits = torch.einsum("bnhd,blhd->bnhl", qh, kx.float().reshape(batch, ls, HEADS, head_dim))
    logits = logits + bias.float()[:, None, None, :]
    others = logits.clone()
    others[..., dropped] = -torch.inf
    m = others.amax(-1, keepdim=True)
    probs = (torch.exp(logits - m) / torch.exp(others - m).sum(-1, keepdim=True)).to(kx.dtype)
    out = torch.einsum("bnhl,blhd->bnhd", probs.float(),
                       vx.float().reshape(batch, ls, HEADS, head_dim))
    return {f"keys {left_out.start}-{left_out.stop - 1} (one tile) left out":
            ba.beam_cross_attention_plain(qx, kx, vx, cut, HEADS, beams),
            f"the stats of keys {dropped.start}-{dropped.stop - 1} (one tile) dropped":
            out.to(qx.dtype).reshape(batch * beams, D_MODEL)}


def _check_cross_at(name: str, kx, vx, bias, keep, g, fault_tiles: tuple) -> dict:
    """#2 at K 1, 10 and 30 on these encoder rows: held to ATTN_TOL and
    ATTN_RMS_TOL against the plain version, two calls bit-equal, the
    planted faults of :func:`_cross_faults` at tiles ``fault_tiles`` (left
    out, stats dropped) of each K's plan rejected, timed eagerly and as
    device time in turns with SDPA (additive mask). The bound counts each
    row's valid keys only: q.k and p.v over them, their K and V rows read
    once, q read and out written, the bias. Returns the record entry."""
    import torch

    from multimodalanalytical_tpu_torch.ops import beam_attention as ba

    ls = kx.shape[1]
    valid = int(keep.sum())
    times, bounds, plans, worst = {}, {}, {}, 0.0
    for beams, _ in DECODE_BEAMS:
        qx = torch.randn(BATCH * beams, D_MODEL, generator=g, device=DEVICE).bfloat16()
        got = ba.beam_cross_attention(qx, kx, vx, bias, HEADS, beams)
        again = ba.beam_cross_attention(qx, kx, vx, bias, HEADS, beams)
        want = ba.beam_cross_attention_plain(qx, kx, vx, bias, HEADS, beams)
        err, tol, rms, ok = _attn_err(got, want)
        equal = torch.equal(got, again)
        plan = ba.cross_plan(BATCH, beams, HEADS, D_MODEL // HEADS, ls, 2)
        plans[f"K={beams}"] = plan.tile_keys
        print(f"kernel beam_cross_attention K={beams} Ls={ls} ({name}; {plan}): max_abs_err="
              f"{err:.3e} tol={tol:.3e} rel_rms_err={rms:.3e} tol={ATTN_RMS_TOL:.0e}; two calls "
              f"bit-equal {equal}", flush=True)
        _require(ok, f"beam_cross_attention disagrees with its plain version at Ls {ls}")
        _require(equal, f"two beam_cross_attention calls differ at Ls {ls}")
        worst = max(worst, err)
        tile = plan.tile_keys
        out_t, drop_t = fault_tiles
        _rejected(f"beam_cross_attention K={beams} Ls={ls}",
                  _cross_faults(qx, kx, vx, bias, beams,
                                slice(out_t * tile, min(ls, out_t * tile + tile)),
                                slice(drop_t * tile, min(ls, drop_t * tile + tile))), want)
        del got, again
        turns = _cross_turns(qx, kx, vx, bias, beams)
        ms, library_ms, device_ms, library_device_ms = (
            sum(turns[x]) / 2 for x in ("kernel", "sdpa", "kernel_device", "sdpa_device"))
        plain_ms = _time_ms(lambda: ba.beam_cross_attention_plain(qx, kx, vx, bias, HEADS,
                                                                  beams), iters=3)
        bound = _bound_ms(4 * beams * valid * D_MODEL,
                          (2 * BATCH * beams + 2 * valid) * D_MODEL * 2 + bias.numel() * 4)
        times[f"K={beams}"] = (ms, plain_ms, library_ms, device_ms, library_device_ms)
        bounds[f"K={beams}"] = bound
        print(f"time beam_cross_attention K={beams} Ls={ls}: a call eagerly, in turns: kernel "
              f"{ms:.4f} ms {[round(x, 4) for x in turns['kernel']]}, SDPA {library_ms:.4f} ms "
              f"{[round(x, 4) for x in turns['sdpa']]}; device, CUDA graphs, in turns: kernel "
              f"{device_ms:.4f} ms {[round(x, 4) for x in turns['kernel_device']]}, SDPA "
              f"{library_device_ms:.4f} ms {[round(x, 4) for x in turns['sdpa_device']]} (no "
              f"slower than SDPA: {device_ms <= library_device_ms}); plain {plain_ms:.4f} ms; "
              f"bound {bound[0]:.5f} ms ({bound[1]}, {valid} valid keys of {BATCH * ls}), "
              f"{100 * bound[0] / device_ms:.1f}% of it in device time", flush=True)
        del qx, want
    return {"ls": ls, "valid_keys": valid, "max_abs_err": worst,
            "tile_keys": plans,
            "times_ms_is": "(ms, plain_ms, library_ms, device_ms, library_device_ms)",
            "times_ms": {k: list(v) for k, v in times.items()},
            "bound_ms": {k: v[0] for k, v in bounds.items()},
            "bound_by": {k: v[1] for k, v in bounds.items()}}


def check_cross_long() -> dict:
    """#2 at the multimodal encoder's Ls 279 (the split form), on the
    padding masks of a multimodal request: row 0 fully masked (batch
    padding), row 1 with every key of the first tile masked, row 2 with
    every key past it; planted faults at the first tile (left out) and
    the second (stats dropped). Returns the record's ``long_encoder``
    entry."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    ls = MM_LS
    tile = _cross_tile(BEAMS, ls)
    _, mask = _multimodal_request(seed=98)
    keep = torch.as_tensor(mask, device=dev).bool()
    keep[0] = False
    keep[1, :tile] = False
    keep[2, tile:] = False
    bias = torch.where(keep, 0.0, -1e9).float()
    kx, vx = ((torch.randn(BATCH, ls, D_MODEL, generator=g, device=dev)).bfloat16()
              for _ in range(2))
    return _check_cross_at("multimodal masks", kx, vx, bias, keep, g, (0, 1))


def check_cross_rle() -> dict:
    """#2 at an RLE encoder's Ls 4090 (the split form), B 128: valid
    lengths drawn from RLE_MIN_LEN..RLE_MAX_LEN and tail-padded, row 0 fully
    masked (batch padding), row 1 at full length, row 2 with valid keys
    ending inside the first tile (every later tile's keys skipped); planted
    faults at the first tile (left out) and the second (stats dropped).
    Returns the record's ``rle_encoder`` entry."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    ls = RLE_MAX_LEN
    lengths = torch.randint(RLE_MIN_LEN, RLE_MAX_LEN + 1, (BATCH, 1), generator=g, device=dev)
    lengths[0], lengths[1] = 0, RLE_MAX_LEN
    lengths[2] = min(_cross_tile(beams, ls) for beams, _ in DECODE_BEAMS) // 2
    keep = torch.arange(ls, device=dev)[None, :] < lengths
    bias = torch.where(keep, 0.0, -1e9).float()
    kx, vx = ((torch.randn(BATCH, ls, D_MODEL, generator=g, device=dev)).bfloat16()
              for _ in range(2))
    entry = _check_cross_at("RLE masks", kx, vx, bias, keep, g, (0, 1))
    del kx, vx
    torch.cuda.empty_cache()
    return entry


def _ffn_err(got, want) -> tuple:
    """(max|got - want| / max|want|, |got - want|_2 / |want|_2, whether both
    are within FFN_REL_TOL / FFN_RMS_TOL and got is finite)."""
    import torch

    diff = got.float() - want.float()
    rel = diff.abs().max().item() / max(want.float().abs().max().item(), 1e-6)
    rms = (diff.norm() / want.float().norm()).item()
    ok = bool(torch.isfinite(got.float()).all()) and rel <= FFN_REL_TOL and rms <= FFN_RMS_TOL
    return rel, rms, ok


def _ffn_library(x, w1, b1, wg, bg, w2, b2):
    """The cuBLAS route of the decode FFN: ``F.linear`` -> fp32 ``F.gelu`` ->
    ``F.linear`` (and the gate's ``F.linear``). A yardstick of time only,
    never called by the port: it adds each bias inside the GEMM before
    rounding, so its roundings differ from flax's."""
    import torch.nn.functional as F

    act = F.gelu(F.linear(x, w1, b1).float()).to(x.dtype)
    if wg is not None:
        act = act * F.linear(x, wg, bg)
    return F.linear(act, w2, b2)


def _ffn_times(decode_ffn, args) -> dict:
    """``geglu_ffn`` and the cuBLAS route on ``args``, in turns (kernel,
    cuBLAS, kernel, cuBLAS), each eagerly and as device time; the plain
    version eagerly. Uses only what every version of ``ops/decode_ffn.py``
    has, so ``--time-ffn`` can time an earlier tree's kernel the same way."""
    turns = {"ms": [], "library_ms": [], "device_ms": [], "library_device_ms": []}
    for _ in range(2):
        for prefix, fn in (("", lambda: decode_ffn.geglu_ffn(*args)),
                           ("library_", lambda: _ffn_library(*args))):
            turns[f"{prefix}ms"].append(_time_ms(fn, iters=50))
            turns[f"{prefix}device_ms"].append(_device_ms(fn, iters=50))
    times = {key: sum(val) / len(val) for key, val in turns.items()}
    times["plain_ms"] = _time_ms(lambda: decode_ffn.geglu_ffn_plain(*args))
    times["turns"] = turns
    return times


def _ffn_inputs(g):
    """Seeded bf16 decode-FFN weights (F, D) / (D, F) and biases, and the
    (M, D) input rows at each M = B x K of DECODE_BEAMS."""
    import torch

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).bfloat16()

    weights = (randn(FFN, D_MODEL, scale=0.05), randn(FFN, scale=0.1),
               randn(FFN, D_MODEL, scale=0.05), randn(FFN, scale=0.1),
               randn(D_MODEL, FFN, scale=0.03), randn(D_MODEL, scale=0.1))
    rows = {BATCH * beams: randn(BATCH * beams, D_MODEL) for beams, _ in DECODE_BEAMS}
    return weights, rows


def _ffn_bound(m: int, gated: bool) -> tuple:
    weights = (3 if gated else 2) * FFN * D_MODEL
    return _bound_ms(2 * m * weights,
                     (weights + (3 if gated else 2) * FFN + D_MODEL) * 2 + 2 * m * D_MODEL * 2)


def check_ffn() -> dict:
    """#3 the decode FFN vs its plain version, ungated (flagship) and gated,
    at M = B x K of every beam count an entry point runs: max error and
    error norm, two calls bit-equal, a planted fault (one 64-deep stage of
    F left out of the down product) that the check must reject; then eager
    and device times in turns with the cuBLAS route. Returns its record."""
    import torch

    from multimodalanalytical_tpu_torch.ops import decode_ffn

    g = torch.Generator(device="cuda").manual_seed(3)
    (w1, b1, wg, bg, w2, b2), rows = _ffn_inputs(g)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w2_fault = w2.clone()
    w2_fault[:, 64 * FFN_FAULT_STAGE: 64 * (FFN_FAULT_STAGE + 1)] = 0
    worst, worst_rms, timing, bounds = 0.0, 0.0, {}, {}
    for m, x in rows.items():
        for gated in (False, True):
            args = (x, w1, b1, wg if gated else None, bg if gated else None, w2, b2)
            got = decode_ffn.geglu_ffn(*args)
            again = decode_ffn.geglu_ffn(*args)
            want = decode_ffn.geglu_ffn_plain(*args)
            fault = decode_ffn.geglu_ffn_plain(*args[:5], w2_fault, b2)
            torch.cuda.synchronize()
            rel, rms, ok = _ffn_err(got, want)
            fault_rel, fault_rms, fault_ok = _ffn_err(fault, want)
            same = torch.equal(got, again)
            key = f"{'gated' if gated else 'ungated'} M={m}"
            print(f"kernel geglu_ffn {key} D={D_MODEL} F={FFN}, "
                  f"{decode_ffn.ffn_plan(m, D_MODEL, FFN, sms)}: max_rel_err="
                  f"{rel:.3e} tol={FFN_REL_TOL} rel_rms_err={rms:.3e} tol={FFN_RMS_TOL:.0e}; two "
                  f"calls bit-equal {same}; planted fault (stage {FFN_FAULT_STAGE} of F left out "
                  f"of the down product): max_rel_err={fault_rel:.3e} rel_rms_err="
                  f"{fault_rms:.3e}, rejected {not fault_ok}", flush=True)
            _require(ok, "geglu_ffn disagrees with its plain version")
            _require(same, "two geglu_ffn calls differ")
            _require(not fault_ok, "the geglu_ffn check passes a down product that skips a stage")
            worst = max(worst, (got.float() - want.float()).abs().max().item())
            worst_rms = max(worst_rms, rms)
            t = _ffn_times(decode_ffn, args)
            bounds[key] = _ffn_bound(m, gated)
            timing[key] = tuple(t[k] for k in ("ms", "plain_ms", "library_ms", "device_ms",
                                               "library_device_ms"))
            bound = bounds[key][0]
            print(f"time geglu_ffn {key}: in turns with the cuBLAS route, eagerly: kernel "
                  f"{t['ms']:.4f} ms {[round(v, 4) for v in t['turns']['ms']]}, cuBLAS "
                  f"{t['library_ms']:.4f} ms {[round(v, 4) for v in t['turns']['library_ms']]}; "
                  f"device, CUDA graphs: kernel {t['device_ms']:.4f} ms "
                  f"{[round(v, 4) for v in t['turns']['device_ms']]}, cuBLAS "
                  f"{t['library_device_ms']:.4f} ms "
                  f"{[round(v, 4) for v in t['turns']['library_device_ms']]} (no slower than "
                  f"cuBLAS: {t['device_ms'] <= t['library_device_ms']}); plain "
                  f"{t['plain_ms']:.4f} ms; bound {bound:.4f} ms ({bounds[key][1]}), "
                  f"{100 * bound / t['ms']:.1f}% of bound eagerly, "
                  f"{100 * bound / t['device_ms']:.1f}% in device time", flush=True)
    key = f"ungated M={BATCH * BEAMS}"
    ms, plain_ms, library_ms, device_ms, library_device_ms = timing[key]
    return {"name": "geglu_ffn", "route": "cuda",
            "source": "multimodalanalytical_tpu_torch/csrc/decode_ffn.cu",
            "replaces": "multimodalanalytical_tpu/ops/decode_ffn.py:68",
            "max_abs_err": worst, "rel_rms_err": worst_rms, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "library_ms": library_ms, "device_ms": device_ms,
            "library_device_ms": library_device_ms, "device_ms_is": DEVICE_MS_IS,
            "library": "cuBLAS route, three PyTorch calls (four gated): F.linear, fp32 F.gelu, "
                       "F.linear",
            "other_bounds_ms": {k: v[0] for k, v in bounds.items()},
            "timed_at": f"{key} D={D_MODEL} F={FFN}",
            "other_times_ms_is": "(ms, plain_ms, library_ms, device_ms, library_device_ms)",
            "other_times_ms": {k: list(v) for k, v in timing.items()}}


def check_ffn_partial() -> dict:
    """#3's partial mode, as a rank of phase 11's (1, 2) layout runs it: the
    first F / 2 = 1024 columns of the flagship FFN at M = B K = 1280, D 512,
    ungated. The fp32 down product without b2 against the plain version's
    partial mode (FFN_REL_TOL of max|plain|, FFN_RMS_TOL in norm), two calls
    bit-equal, a planted fault (stage FFN_PARTIAL_FAULT_STAGE of the shard's
    F left out of the down product) rejected; eager and device times in
    turns with the cuBLAS route (F.linear, fp32 F.gelu, F.linear without
    b2, bf16 out), and the full mode on the same shard beside it. Returns
    the record's ``partial_mode`` entry."""
    import torch
    import torch.nn.functional as F

    from multimodalanalytical_tpu_torch.ops import decode_ffn

    g = torch.Generator(device="cuda").manual_seed(4)
    (w1, b1, _, _, w2, b2), rows = _ffn_inputs(g)
    m, f = BATCH * BEAMS, FFN // 2
    x = rows[m]
    w1, b1, w2 = w1[:f].contiguous(), b1[:f].contiguous(), w2[:, :f].contiguous()
    args = (x, w1, b1, None, None, w2, None)
    got = decode_ffn.geglu_ffn(*args, partial=True)
    again = decode_ffn.geglu_ffn(*args, partial=True)
    want = decode_ffn.geglu_ffn_plain(*args, partial=True)
    w2_fault = w2.clone()
    stage = FFN_PARTIAL_FAULT_STAGE
    w2_fault[:, 64 * stage:64 * (stage + 1)] = 0
    fault = decode_ffn.geglu_ffn_plain(*args[:5], w2_fault, None, partial=True)
    torch.cuda.synchronize()
    rel, rms, ok = _ffn_err(got, want)
    fault_rel, fault_rms, fault_ok = _ffn_err(fault, want)
    same = torch.equal(got, again)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shape = f"ungated M={m} D={D_MODEL} F={f} (a rank's half of F {FFN})"
    print(f"kernel geglu_ffn partial mode {shape}, {decode_ffn.ffn_plan(m, D_MODEL, f, sms)}: "
          f"out {got.dtype} {tuple(got.shape)}, max_rel_err={rel:.3e} tol={FFN_REL_TOL} "
          f"rel_rms_err={rms:.3e} tol={FFN_RMS_TOL:.0e}; two calls bit-equal {same}; planted "
          f"fault (stage {stage} of F left out of the down product): max_rel_err="
          f"{fault_rel:.3e} rel_rms_err={fault_rms:.3e}, rejected {not fault_ok}", flush=True)
    _require(got.dtype == torch.float32 and ok, "geglu_ffn's partial mode disagrees with its "
                                                "plain version")
    _require(same, "two partial-mode geglu_ffn calls differ")
    _require(not fault_ok, "the partial-mode check passes a down product that skips a stage")

    def library():
        return F.linear(F.gelu(F.linear(x, w1, b1).float()).to(x.dtype), w2)

    full_args = (x, w1, b1, None, None, w2, b2)
    turns = {"ms": [], "library_ms": [], "device_ms": [], "library_device_ms": [],
             "full_ms": [], "full_device_ms": []}
    for _ in range(2):
        for prefix, fn in (("", lambda: decode_ffn.geglu_ffn(*args, partial=True)),
                           ("library_", library),
                           ("full_", lambda: decode_ffn.geglu_ffn(*full_args))):
            turns[f"{prefix}ms"].append(_time_ms(fn, iters=50))
            turns[f"{prefix}device_ms"].append(_device_ms(fn, iters=50))
    t = {key: sum(val) / len(val) for key, val in turns.items()}
    t["plain_ms"] = _time_ms(lambda: decode_ffn.geglu_ffn_plain(*args, partial=True))
    # each input read once (x, W1, b1, W2 in bf16), the fp32 output written once
    bound, by = _bound_ms(2 * m * 2 * f * D_MODEL,
                          (2 * f * D_MODEL + f + m * D_MODEL) * 2 + m * D_MODEL * 4)
    print(f"time geglu_ffn partial mode {shape}: in turns, eagerly: kernel {t['ms']:.4f} ms "
          f"{[round(v, 4) for v in turns['ms']]}, cuBLAS {t['library_ms']:.4f} ms, full mode "
          f"on the shard {t['full_ms']:.4f} ms; device, CUDA graphs: kernel "
          f"{t['device_ms']:.4f} ms, cuBLAS {t['library_device_ms']:.4f} ms, full mode "
          f"{t['full_device_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; bound {bound:.4f} ms "
          f"({by}), {100 * bound / t['device_ms']:.1f}% of bound in device time", flush=True)
    return {"timed_at": shape, "max_abs_err": (got - want).abs().max().item(),
            "rel_rms_err": rms, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "device_ms": t["device_ms"], "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"], "full_mode_ms": t["full_ms"],
            "full_mode_device_ms": t["full_device_ms"], "bound_ms": bound, "bound_by": by,
            "library": "cuBLAS route: F.linear, fp32 F.gelu, F.linear without b2 (bf16 out)"}


def time_ffn() -> None:
    """``--time-ffn``: #3's times alone, as ``check_ffn`` takes them, on
    whatever ``multimodalanalytical_tpu_torch`` sits beside this script (so
    a copy of the script in an earlier tree times that tree's kernel); one
    JSON line."""
    import torch

    from multimodalanalytical_tpu_torch.ops import decode_ffn

    g = torch.Generator(device="cuda").manual_seed(3)
    (w1, b1, wg, bg, w2, b2), rows = _ffn_inputs(g)
    times = {}
    for m, x in rows.items():
        for gated in (False, True):
            args = (x, w1, b1, wg if gated else None, bg if gated else None, w2, b2)
            t = _ffn_times(decode_ffn, args)
            key = f"{'gated' if gated else 'ungated'} M={m}"
            times[key] = {k: t[k] for k in ("ms", "device_ms", "library_ms",
                                            "library_device_ms", "plain_ms")}
            times[key]["bound_ms"] = _ffn_bound(m, gated)[0]
    print(json.dumps({"ffn_times": times, "tree": str(REPO)}), flush=True)


def _cross_time_inputs(g, ls: int) -> tuple:
    """B 128 encoder rows at Ls as phase 1 takes them: the multimodal
    request's masks at Ls 279, RLE lengths (RLE_MIN_LEN..RLE_MAX_LEN) at
    4090, rows of 18-26 keys at the flagship's 26; (K, V, bias, valid keys)."""
    import torch

    if ls == MM_LS:
        keep = torch.as_tensor(_multimodal_request(seed=98)[1], device=DEVICE).bool()
    else:
        low = RLE_MIN_LEN if ls == RLE_MAX_LEN else ls - 8
        lengths = torch.randint(low, ls + 1, (BATCH, 1), generator=g, device=DEVICE)
        keep = torch.arange(ls, device=DEVICE)[None, :] < lengths
    kx, vx = (torch.randn(BATCH, ls, D_MODEL, generator=g, device=DEVICE).bfloat16()
              for _ in range(2))
    return kx, vx, torch.where(keep, 0.0, -1e9).float(), int(keep.sum())


def time_cross() -> None:
    """``--time-cross``: #2's device time (CUDA-graph replay) at B 128 and
    Ls 26, 279 and 4090, K 1, 10 and 30, in turns with SDPA, with its bound
    from the valid keys, on whatever ``multimodalanalytical_tpu_torch`` sits
    beside this script (a copy of the script in an earlier tree times that
    tree's kernel). One JSON line."""
    import torch
    import torch.nn.functional as F

    from multimodalanalytical_tpu_torch.ops import beam_attention as ba

    g = torch.Generator(device=DEVICE).manual_seed(13)
    times = {}
    for ls in (FORMULA_LEN + N_PATCHES, MM_LS, RLE_MAX_LEN):
        kx, vx, bias, valid = _cross_time_inputs(g, ls)
        for beams, _ in DECODE_BEAMS:
            qx = torch.randn(BATCH * beams, D_MODEL, generator=g, device=DEVICE).bfloat16()
            qh = qx.reshape(BATCH, beams, HEADS, -1).transpose(1, 2)
            kh, vh = (t.reshape(BATCH, ls, HEADS, -1).transpose(1, 2) for t in (kx, vx))
            mask = bias[:, None, None, :].to(qx.dtype)
            runs = {"kernel": lambda: ba.beam_cross_attention(qx, kx, vx, bias, HEADS, beams),
                    "sdpa": lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)}
            turns = {name: [] for name in runs}
            for _ in range(2):
                for name, fn in runs.items():
                    turns[name].append(round(_device_ms(fn, iters=20), 4))
            bound = _bound_ms(4 * beams * valid * D_MODEL,
                              (2 * BATCH * beams + 2 * valid) * D_MODEL * 2 + bias.numel() * 4)
            times[f"Ls={ls} K={beams}"] = {
                "valid_keys": valid, "bound_ms": bound[0], "bound_by": bound[1],
                "device_ms": turns}
            print(f"time_cross Ls={ls} K={beams}: {json.dumps(times[f'Ls={ls} K={beams}'])}",
                  flush=True)
            del qx, qh, runs
        del kx, vx, bias
    print(json.dumps({"cross_times": times, "tree": str(REPO)}), flush=True)


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
            err, tol, rms, ok = _attn_err(got, want)
            kernel_args = args[:3] + (_device_pos(pos),) + args[4:]
            ms = _time_ms(lambda: ba.beam_select_attention(*kernel_args))
            device_ms = _device_ms(lambda: ba.beam_select_attention(*kernel_args))
            plain_ms = _time_ms(lambda: ba.beam_select_attention_plain(*args), iters=5)
            timing[(kind, beams)] = (ms, plain_ms, device_ms)
            bounds[(kind, beams)] = _bound_ms(4 * BATCH * beams * (pos + 1) * D_MODEL,
                                              _select_bytes(anc, pos, kind == "int8", False))
            print(f"kernel beam_select_attention {kind} K={beams} L={MAX_LENGTH} pos={pos}: "
                  f"max_abs_err={err:.3e} tol={tol:.3e} rel_rms_err={rms:.3e} tol="
                  f"{ATTN_RMS_TOL:.0e}; kernel {ms:.4f} ms a call eagerly ({device_ms:.4f} ms "
                  f"device, CUDA graph), plain {plain_ms:.4f} ms, bound "
                  f"{bounds[(kind, beams)][0]:.4f} ms ({bounds[(kind, beams)][1]}), "
                  f"{100 * bounds[(kind, beams)][0] / ms:.1f}% of bound eagerly, "
                  f"{100 * bounds[(kind, beams)][0] / device_ms:.1f}% in device time", flush=True)
            _require(ok, "beam_select_attention disagrees with its plain version")
            worst = max(worst, err)
            del cache, scales
    ms, plain_ms, device_ms = timing[("int8", EVAL_BEAMS)]
    bound, bound_by = bounds[("int8", EVAL_BEAMS)]
    return {"name": "beam_select_attention", "route": "cuda",
            "source": "multimodalanalytical_tpu_torch/csrc/beam_attention.cu",
            "replaces": "multimodalanalytical_tpu/ops/beam_attention.py:703",
            "launches": launches, "launches_by_phase": {"1": launches},
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "device_ms": device_ms, "device_ms_is": DEVICE_MS_IS,
            "other_bounds_ms": {f"{k} K={b}": v[0] for (k, b), v in bounds.items()},
            "timed_at": f"int8 cache, B={BATCH}, K={EVAL_BEAMS}, L={MAX_LENGTH}, pos={pos}",
            "other_times_ms_is": "(ms, plain_ms, device_ms)",
            "other_times_ms": {f"{k} K={b}": list(v) for (k, b), v in timing.items()}}


def check_fused_dropout() -> tuple:
    """#7 fused dropout vs its plain version at the train-site shapes, bf16,
    rate 0.1: forward and backward bit-equal, the backward's mask the
    forward's, the keep fraction within 5 sigma of 1 - rate. Returns (its
    record, the phase-1 launches)."""
    import math

    import torch
    import torch.nn.functional as F

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
        library_ms = _time_ms(lambda: F.dropout(x, rate, training=True))
        times[shape] = (ms, plain_ms, default_ms, library_ms)
        print(f"kernel fused_dropout {tuple(shape)} bf16 rate {rate}: forward bit-equal "
              f"{fwd_equal}, backward bit-equal {bwd_equal}, backward mask = forward mask "
              f"{same_mask}, keep fraction {kept:.6f} (want {1 - rate} +- {5 * sigma:.2e}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, ops/dropout.py {default_ms:.4f} ms, "
              f"F.dropout {library_ms:.4f} ms",
              flush=True)
        _require(fwd_equal and bwd_equal and same_mask,
                 "fused_dropout differs from its plain version")
        _require(abs(kept - (1 - rate)) <= 5 * sigma, "fused_dropout keep fraction off")
    _require(launches == 2 * len(DROPOUT_SHAPES), "fused_dropout did not launch")
    ms, plain_ms, default_ms, library_ms = times[DROPOUT_SHAPES[1]]
    numel = math.prod(DROPOUT_SHAPES[1])
    bound, bound_by = _bound_ms(numel, 2 * numel * 2)   # bf16 in and out
    return {"name": "fused_dropout", "route": "cuda",
            "source": "multimodalanalytical_tpu_torch/csrc/fused_dropout.cu",
            "replaces": "multimodalanalytical_tpu/ops/fused_dropout.py:59",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
            "library": f"torch.nn.functional.dropout(x, {rate}, training=True)",
            "ops_dropout_ms": default_ms,
            "ops_dropout_is": "ops/dropout.py, the port's default route (torch.rand mask, "
                              "then a multiply)",
            "timed_at": f"{DROPOUT_SHAPES[1]} bf16, rate {rate}",
            "other_times_ms_is": "(ms, plain_ms, ops_dropout_ms, library_ms)",
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
    the long RLE encoder's shapes, head_dim 64 (B 8, H 8: the records), 128
    (B 8, H 4: the same d_model 512), 192 (B 8, H 4: d_model 768) and 256
    (B 8, H 2: d_model 512); returns records."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(5)
    main = _check_flash_shape(g, TRAIN_BATCH, HEADS, D_MODEL // HEADS)
    wider = {d: _check_flash_shape(g, TRAIN_BATCH, h, d)
             for d, h in ((128, HEADS // 2), (192, 4), (256, 2))}
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
            **{f"head_dim_{d}": {"timed_at": wide["shape"], "ms": wide["ms"][part],
                                 "plain_ms": wide["plain_ms"][part],
                                 "library_ms": wide["library_ms"][part],
                                 "bound_ms": wide["bound_ms"][part],
                                 "bound_by": wide["bound_by"][part],
                                 "max_abs_err": (wide["errs"]["out"] if part == "fwd" else
                                                 max(wide["errs"][x] for x in ("dq", "dk", "dv"))),
                                 "valid_keys": wide["valid_keys"],
                                 "tflops": wide["flops"][part] / wide["ms"][part] / 1e9}
               for d, wide in wider.items()}})
    return records


# ---------------------------------------------------------------- phase 2
def _flagship(use_beam_kernel: bool = True, kv_cache_dtype: str = "int8",
              dtype: str = "bfloat16", mesh=None):
    import torch

    from multimodalanalytical_tpu_torch.models.config import ModelConfig
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel

    cfg = ModelConfig(
        d_model=D_MODEL, encoder_layers=LAYERS, decoder_layers=LAYERS,
        encoder_attention_heads=HEADS, decoder_attention_heads=HEADS,
        encoder_ffn_dim=FFN, decoder_ffn_dim=FFN, vocab_size=VOCAB,
        dtype=dtype, max_target_length=MAX_LENGTH,
        use_beam_kernel=use_beam_kernel, kv_cache_dtype=kv_cache_dtype,
    )
    dev = torch.device(DEVICE)
    return Seq2SeqModel(cfg, DATA_CONFIG, "Smiles", device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0), mesh=mesh)


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


def _multimodal_model(dtype: str = "bfloat16", dropout: float = 0.1):
    """The flagship-width CustomModel on the multimodal recipe; seeded, so
    every call builds the same weights."""
    import torch

    from multimodalanalytical_tpu_torch.models.config import ModelConfig
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel

    cfg = ModelConfig(
        d_model=D_MODEL, encoder_layers=LAYERS, decoder_layers=LAYERS,
        encoder_attention_heads=HEADS, decoder_attention_heads=HEADS,
        encoder_ffn_dim=FFN, decoder_ffn_dim=FFN, vocab_size=VOCAB, dtype=dtype,
        dropout=dropout, max_target_length=MAX_LENGTH)
    dev = torch.device(DEVICE)
    return Seq2SeqModel(cfg, MM_DATA_CONFIG, "Smiles", device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))


def _multimodal_request(seed: int, batch: int = BATCH, xval: bool = False):
    """A seeded multimodal request (MM_DATA_CONFIG): Formula ids as in
    :func:`_request`, rows of 4-32 multiplets (5 tokens each) and of 5-40
    carbon peaks, each tail-padded to the recipe's width, 24 IR patches of
    75, and the encoder mask over each modality's padding. ``xval``: the
    same request with the multiplets as a numerical_encoding dict (XVal
    values around 1 on the valid tokens, 1.0 on the padding)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    counts = {"Formula": rng.integers(6, MM_FORMULA + 1, batch),
              "Multiplets": 5 * rng.integers(MM_MULTIPLETS_PER_ROW[0],
                                             MM_MULTIPLETS_PER_ROW[1] + 1, batch),
              "Carbon": rng.integers(MM_PEAKS_PER_ROW[0], MM_PEAKS_PER_ROW[1] + 1, batch)}
    widths = {"Formula": MM_FORMULA, "Multiplets": MM_MULTIPLETS, "Carbon": MM_CARBON}
    inputs, masks = {}, []
    for name, width in widths.items():
        keep = np.arange(width)[None, :] < counts[name][:, None]
        vocab = MM_DATA_CONFIG[name]["vocab_size"]
        inputs[name] = np.where(keep, rng.integers(4, vocab, (batch, width)), 0).astype(np.int64)
        masks.append(keep)
    inputs["IR"] = rng.random((batch, MM_PATCHES, MM_PATCH)).astype(np.float32)
    masks.append(np.ones((batch, MM_PATCHES), bool))
    values = np.where(masks[1], rng.normal(1.0, 0.3, (batch, MM_MULTIPLETS)), 1.0)
    if xval:
        inputs["Multiplets"] = {"tokenized_input": inputs["Multiplets"],
                                "numerical_values": values.astype(np.float32)}
    return inputs, np.concatenate(masks, axis=1).astype(np.int32)


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
                    cache = dm.init_beam_cache(batch, beams, steps, hidden, mask,
                                               kind == "int8")
                    out = []
                    for t in range(steps):
                        a = anc.clone()
                        a[:, :, t] = torch.arange(beams, device=dev, dtype=torch.int32)
                        out.append(dm.beam_decode_step(tokens[:, :, t], t, cache, a))
                    logits.append(torch.stack(out).float())
                err = (logits[0] - logits[1]).abs().max().item()
                tol = LOGIT_TOL * max(1.0, logits[1].abs().max().item())
                print(f"teacher-forced logits K={beams} {kind} cache, kernel vs plain path: "
                      f"max_abs_err={err:.3e} tol={tol:.3e}", flush=True)
                _require(bool(torch.isfinite(logits[0]).all()) and err <= tol,
                         "kernel path disagrees with the plain path")


def _eager_decode(decoder, inputs, mask, beams: int, **kwargs) -> tuple:
    """One decode through ``decoder`` with ``cuda_graph=False``: the same
    step as the graphs, launched eagerly. Returns (seqs, scores, stats, s)."""
    import torch

    from multimodalanalytical_tpu_torch.training.trainer import to_device

    inputs = to_device(inputs, DEVICE)
    mask = torch.as_tensor(mask, device=DEVICE)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs, scores = decoder.search(inputs, mask, beams, max_length=MAX_LENGTH, cuda_graph=False,
                                  stats=stats, **kwargs)
    seqs, scores = seqs.cpu().numpy(), scores.cpu().numpy()
    return seqs, scores, stats, time.perf_counter() - t0


def _graph_decode(decoder, inputs, mask, beams: int, **kwargs) -> tuple:
    """As :func:`_eager_decode`, through the decoder's CUDA graphs."""
    import torch

    from multimodalanalytical_tpu_torch.training.trainer import to_device

    inputs = to_device(inputs, DEVICE)
    mask = torch.as_tensor(mask, device=DEVICE)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs, scores = decoder.search(inputs, mask, beams, max_length=MAX_LENGTH, stats=stats,
                                  **kwargs)
    seqs, scores = seqs.cpu().numpy(), scores.cpu().numpy()
    _require(stats["graph"], "the decode did not run through its CUDA graphs")
    return seqs, scores, stats, time.perf_counter() - t0


def _require_bit_equal(what: str, graph: tuple, eager: tuple) -> None:
    import numpy as np

    equal = (np.array_equal(graph[0], eager[0]) and np.array_equal(graph[1], eager[1])
             and graph[2]["steps"] == eager[2]["steps"])
    print(f"{what}: graphs vs eager loop: sequences and scores bit-equal {equal}; steps "
          f"{graph[2]['steps']} / {eager[2]['steps']}, replays {graph[2]['replays']} / "
          f"{eager[2]['replays']}; {graph[3]:.4f} s / {eager[3]:.4f} s", flush=True)
    _require(equal, f"{what}: the graph decode differs from the eager decode")


# A planted early exit: random weights decode all 127 steps, so an lm_head
# bias that favours EOS this much makes the decode exit early (finished
# hypotheses ~ -EXIT_EOS_BIAS / 2, live sums falling ~EXIT_EOS_BIAS a step:
# the exit near step 64), which is what the device loop's freeze serves.
EXIT_EOS_BIAS = 20.0


def check_early_exit(model) -> None:
    """One K 10 batch through graphs and through the eager loop on the
    serving model with EOS favoured: bit-equal, and an exit before the last
    step, seen within ``check_every`` replays."""
    import torch

    from multimodalanalytical_tpu_torch.generation.beam_search import BeamDecoder

    exit_model = _flagship()
    exit_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        exit_model.lm_head.bias[exit_model.config.eos_token_id] += EXIT_EOS_BIAS
    decoder = BeamDecoder(exit_model)
    inputs, mask = _request(seed=4)
    _graph_decode(decoder, inputs, mask, BEAMS)            # captures
    graph = _graph_decode(decoder, inputs, mask, BEAMS)
    eager = _eager_decode(decoder, inputs, mask, BEAMS)
    _require_bit_equal(f"planted early exit (EOS bias {EXIT_EOS_BIAS}), K {BEAMS}", graph, eager)
    steps, replays = graph[2]["steps"], graph[2]["replays"]
    _require(steps < MAX_LENGTH - 1 and replays <= steps + 8,
             f"no early exit ({steps} steps, {replays} replays)")


def _serve_requests(engine, requests, what: str, model, kernels: bool = True,
                    encoder_counters: tuple = ()) -> tuple:
    """The requests through ``engine.decode_batch`` (its graphs, captured
    by an earlier request), the decode kernels' counts set to 0 just before
    and read just after: every kernel launched 6 x the replays (none at all
    with ``kernels=False``), and each of ``encoder_counters`` (the encoder's
    kernels) 6 x the requests; outputs of the expected shapes, finite,
    sorted and BOS-started; then the same requests through the eager loop,
    bit-equal. Returns (launches, graph s/batch, results as (seqs, scores,
    stats, s))."""
    import numpy as np

    counters = _decode_counters()
    for fn in counters + tuple(encoder_counters):
        fn.launches = 0
    results, seconds, steps, replays = [], [], 0, 0
    for inputs, mask in requests:
        t0 = time.perf_counter()
        seqs, scores = engine.decode_batch(inputs, mask)
        seconds.append(time.perf_counter() - t0)
        stats = engine.last_stats
        _require(stats["graph"] and stats["warmup_steps"] == 0,
                 f"a {what} request did not replay the engine's graphs")
        steps += stats["steps"]
        replays += stats["replays"]
        results.append((seqs, scores, dict(stats), seconds[-1]))
    launches = {fn.__name__: fn.launches for fn in counters}
    encoder = {fn.__name__: fn.launches for fn in encoder_counters}
    print(f"{what}: {len(requests)} requests x {BATCH} spectra, beam {BEAMS}, {steps} decode "
          f"steps in {replays} graph replays, launches {launches}"
          + (f", encoder {encoder}" if encoder else ""), flush=True)
    for name, count in launches.items():
        want = LAYERS * replays if kernels else 0
        _require(count == want, f"{name} launched {count} times, want {want}"
                                + (f" ({LAYERS} x the replays)" if kernels else ""))
    for name, count in encoder.items():
        _require(count == LAYERS * len(requests),
                 f"{name} launched {count} times, want {LAYERS} x the requests")
    launches.update(encoder)
    for seqs, scores, _, _ in results:
        _require(seqs.shape == (BATCH, BEAMS, MAX_LENGTH) and scores.shape == (BATCH, BEAMS),
                 "unexpected output shapes")
        _require(bool(np.isfinite(scores).all()), "non-finite scores")
        _require(bool((np.diff(scores, axis=1) <= 0).all()), "beams not sorted by score")
        _require(bool((seqs[:, :, 0] == model.config.bos_token_id).all()),
                 "a sequence does not start with BOS")
    per_batch = sum(seconds) / len(seconds)
    host_ms = 1e3 * sum(r[2]["dispatch_s"] for r in results) / replays
    print(f"{what} kernel path, CUDA graphs: {per_batch:.4f} s/batch ({BATCH / per_batch:.2f} "
          f"spectra/s), per request {[round(x, 4) for x in seconds]}; host {host_ms:.4f} ms "
          f"per step launching replays", flush=True)
    # The same requests through the eager loop (the same step, launched
    # eagerly): bit-equal, timed.
    eager_seconds = []
    for (inputs, mask), graph in zip(requests, results):
        eager = _eager_decode(engine.decoder, inputs, mask, BEAMS)
        eager_seconds.append(eager[3])
        _require_bit_equal(f"{what} request", graph, eager)
    eager_per_batch = sum(eager_seconds) / len(eager_seconds)
    print(f"{what} kernel path, eager loop (cuda_graph=False): {eager_per_batch:.4f} s/batch "
          f"({BATCH / eager_per_batch:.2f} spectra/s), per request "
          f"{[round(x, 4) for x in eager_seconds]}; graphs / eager "
          f"{per_batch / eager_per_batch:.3f}", flush=True)
    return launches, per_batch, results


def _serving_collator():
    """(collator, tokenizer) of the slice's requests, as the serve CLI's
    artifact gives them: the fixed-vocabulary stand-ins for Formula and
    SMILES (the card's machine has no ``tokenizers``), a patch preprocessor
    fitted on seeded 1750-point spectra, and the fitted lengths of
    ``_request`` (Formula 12, IR 14 patches), padded to B 128."""
    import numpy as np

    from multimodalanalytical_tpu_torch.chem import mol_formula
    from multimodalanalytical_tpu_torch.data.collator import MultiModalCollator
    from multimodalanalytical_tpu_torch.data.preprocessing import PatchPreprocessor

    formulas = [mol_formula(s) for s in SMILES_CORPUS]
    preps = {"Formula": FixedVocabTokenizer(FORMULA_REGEX, formulas, (), FORMULA_VOCAB),
             "Smiles": FixedVocabTokenizer(), "IR": PatchPreprocessor(patch_size=PATCH)}
    preps["IR"].fit(list(np.random.default_rng(101).random((64, N_PATCHES * PATCH))))
    collator = MultiModalCollator(preps, DATA_CONFIG,
                                  max_source_length={"Formula": FORMULA_LEN, "IR": N_PATCHES},
                                  max_target_length=MAX_LENGTH, pad_to_batch_size=BATCH)
    return collator, preps["Smiles"]


def run_slice() -> dict:
    import numpy as np
    import torch

    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine

    model = _flagship()
    plain_model = _flagship(use_beam_kernel=False)
    plain_model.load_state_dict(model.state_dict())
    check_teacher_forced(model, plain_model)

    # The engine as the serve CLI builds it (with a collator): its
    # constructor decodes a warm batch, so the first request finds its
    # graphs captured and captures nothing.
    collator, tokenizer = _serving_collator()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = InferenceEngine(model, n_beams=BEAMS, batch_size=BATCH, collator=collator,
                             tokenizer=tokenizer)
    build_s = time.perf_counter() - t0
    warm = engine.warm_stats
    t0 = time.perf_counter()
    engine.decode_batch(*_request(seed=100))
    first_s = time.perf_counter() - t0
    first = engine.last_stats
    print(f"slice warm-up in the engine's constructor: graph capture {warm['capture_s']:.4f} s "
          f"for {warm['warmup_steps']} stages, {build_s:.4f} s in all; first request "
          f"{first_s:.4f} s (capture_s {first['capture_s']}, warmup_steps "
          f"{first['warmup_steps']}, graph {first['graph']})", flush=True)
    _require(warm["graph"] and warm["warmup_steps"] > 0,
             "the engine's warm-up captured no decode graphs")
    _require(first["capture_s"] == 0 and first["warmup_steps"] == 0 and first["graph"],
             "the first request captured its decode graphs: the warm-up missed its shape")
    requests = [_request(seed) for seed in (1, 2, 3)]
    launches, per_batch, results = _serve_requests(engine, requests, "slice", model)
    print(f"slice first request {first_s:.4f} s against a steady {per_batch:.4f} s/batch",
          flush=True)
    check_early_exit(model)

    plain_engine = InferenceEngine(plain_model, n_beams=BEAMS, batch_size=BATCH)
    plain_engine.decode_batch(*_request(seed=100))
    plain_seconds, agree = [], []
    for (inputs, mask), (seqs, *_) in zip(requests, results):
        t0 = time.perf_counter()
        plain_seqs, _ = plain_engine.decode_batch(inputs, mask)
        plain_seconds.append(time.perf_counter() - t0)
        agree.append(float((plain_seqs[:, 0] == seqs[:, 0]).all(axis=1).mean()))
    plain_per_batch = sum(plain_seconds) / len(plain_seconds)
    print(f"slice use_beam_kernel=False (graphs too): {plain_per_batch:.4f} s/batch "
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
    second step (its time only), with the peak device memory; both steps on
    the eager body (a graph's second step would capture)."""
    import torch

    from multimodalanalytical_tpu_torch.training import Trainer

    trainer = Trainer(model, optimiser="adamw", lr=TRAIN_LR, num_steps=TRAIN_STEPS,
                      cuda_graph=False)
    torch.cuda.reset_peak_memory_stats()
    metrics = trainer.train_step(batch)
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    return loss, grad_norm, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def _timed_fit(trainer, loader, **fit_kwargs) -> dict:
    """``trainer.fit(loader, **fit_kwargs)`` with a CUDA event recorded after
    each train step. Returns the losses, each step's metrics, the seconds
    per step of steps 2-n and of steps 3-n between the events (the graph
    route's second step captures, its later ones replay), device copies of
    the parameters and Adam moments after the fit, the route's stats and
    its graph pool's GiB."""
    import torch

    steps, ends = [], []
    train_step = trainer.train_step

    def timed_step(batch):
        steps.append(train_step(batch))
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return steps[-1]

    trainer.train_step = timed_step
    try:
        losses = trainer.fit(loader, **fit_kwargs)
    finally:
        del trainer.train_step
    torch.cuda.synchronize()
    n, opt = len(ends), trainer.optimizer
    return {"losses": losses, "steps": [{k: float(v) for k, v in m.items()} for m in steps],
            "step_s": ends[0].elapsed_time(ends[-1]) / 1e3 / (n - 1),
            "replay_s": ends[1].elapsed_time(ends[-1]) / 1e3 / (n - 2),
            "state": [t.detach().clone() for t in trainer.params + opt.mu + opt.nu],
            "stats": dict(trainer.step_stats), "pool_gib": trainer.graph_pool_bytes() / 2**30}


def _route_name(graph: bool) -> str:
    return "graph" if graph else "eager"


def _require_same_route(what: str, got: dict, want: dict) -> None:
    """Every step's metrics and the state after bit-equal across routes."""
    import torch

    same = (got["steps"] == want["steps"] and len(got["state"]) == len(want["state"])
            and all(torch.equal(a, b) for a, b in zip(got["state"], want["state"])))
    _require(same, f"{what}: the graph route's steps or state differ from the eager route's")


def _route_line(run: dict) -> str:
    stats = run["stats"]
    return (f"{run['step_s']:.5f} s/step (steps 2-{len(run['steps'])}; steps "
            f"3-{len(run['steps'])} {run['replay_s']:.5f}), {stats['captures']} captures in "
            f"{stats['capture_s']:.3f} s, {stats['replays']} replays, {stats['eager_steps']} "
            f"eager steps, graph pool {run['pool_gib']:.3f} GiB")


def _fit_rle(batch, real_tokens: int, route: str, graph: bool) -> dict:
    """Ten dropout-0.1 AdamW steps of the RLE model on the repeated batch on
    one train-step route; returns ``_timed_fit``'s record with the peak GiB
    after checking the losses."""
    import math

    import torch

    from multimodalanalytical_tpu_torch.training import Trainer

    model = _rle_model(dropout=DROPOUT, use_flash=True)
    trainer = Trainer(model, optimiser="adamw", lr=TRAIN_LR, num_steps=TRAIN_STEPS,
                      clip_grad=1.0, cuda_graph=graph)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = _timed_fit(trainer, [batch], epochs=TRAIN_STEPS, max_steps=TRAIN_STEPS)
    run["peak"] = torch.cuda.max_memory_allocated() / 2**30
    losses, seconds = run["losses"], run["step_s"]
    print(f"train fit ({route}, {_route_name(graph)} route): {TRAIN_STEPS} AdamW steps, B "
          f"{TRAIN_BATCH}, dropout {DROPOUT}: {_route_line(run)} ({real_tokens / seconds:.1f} "
          f"encoder tokens/s real, {TRAIN_BATCH * RLE_MAX_LEN / seconds:.1f} padded); peak "
          f"{run['peak']:.2f} GiB; losses {[round(x, 4) for x in losses]}", flush=True)
    _require(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
             "non-finite training loss")
    _require(losses[-1] < losses[0], "the training loss did not fall")
    _require(run["stats"]["graph"] == graph and run["stats"]["captures"] == int(graph),
             f"the fit did not take the {_route_name(graph)} route: {run['stats']}")
    del model, trainer
    torch.cuda.empty_cache()
    return run


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

    # The fits on each train-step route, in turns, from the same seeded
    # weights: bit-equal, each flash kernel launched 6 x the steps (a replay
    # adds what its capture recorded), every fused-dropout site launched
    # forward and backward at every step.
    from contextlib import nullcontext

    counters = _flash_counters()
    fits = {}
    for route, fused, turns in (("ops/dropout.py", False, ROUTE_TURNS),
                                ("fused_dropout", True, (False, True))):
        runs = []
        for graph in turns:
            sites = [0]
            for fn in counters + (fd.fused_dropout,):
                fn.launches = 0
            with _fused_dropout_sites(sites) if fused else nullcontext():
                run = _fit_rle(batch, real_tokens, route, graph)
            run["launches"] = {fn.__name__: fn.launches for fn in counters}
            run["fused"], run["sites"] = fd.fused_dropout.launches, sites[0]
            for name, count in run["launches"].items():
                _require(count == LAYERS * TRAIN_STEPS,
                         f"{name} launched {count} times, want {LAYERS * TRAIN_STEPS}")
            if runs:
                _require_same_route(f"train fit {route}", run, runs[0])
                run["state"] = None
            runs.append(run)
        fits[route] = runs
        eager = [r for r, g in zip(runs, turns) if not g]
        graphs = [r for r, g in zip(runs, turns) if g]
        print(f"train fit {route}: graph route {[round(r['step_s'], 5) for r in graphs]} s/step "
              f"(steps 2-{TRAIN_STEPS}; steps 3-{TRAIN_STEPS} "
              f"{[round(r['replay_s'], 5) for r in graphs]}) against eager "
              f"{[round(r['step_s'], 5) for r in eager]} ({[round(r['replay_s'], 5) for r in eager]}), "
              f"in turns {[_route_name(g) for g in turns]}; every step and the final state "
              f"bit-equal; launches per fit {runs[0]['launches']} (6 x the steps)", flush=True)

    # Fused dropout: Python calls each dropout site at every eager step, and
    # at the graph route's first (eager) step and its capture only.
    eager_fused, graph_fused = fits["fused_dropout"]
    per_step = eager_fused["sites"] // TRAIN_STEPS
    want = 2 * per_step * TRAIN_STEPS
    default_graph = fits["ops/dropout.py"][1]
    print(f"train fit fused_dropout vs ops/dropout.py (graph route): {graph_fused['step_s']:.5f} "
          f"vs {default_graph['step_s']:.5f} s/step, peak {graph_fused['peak']:.2f} vs "
          f"{default_graph['peak']:.2f} GiB; {per_step} dropout sites a step; fused_dropout "
          f"launches (forward and backward) eager {eager_fused['fused']}, graph "
          f"{graph_fused['fused']} (want {want})", flush=True)
    _require(per_step > 0 and eager_fused["sites"] == per_step * TRAIN_STEPS
             and graph_fused["sites"] == 2 * per_step
             and eager_fused["fused"] == graph_fused["fused"] == want,
             "fused_dropout did not launch at every dropout site, forward and backward")
    return default_graph["launches"], graph_fused["fused"]


def run_ir_recipe() -> None:
    """Phase 4: the flagship IR recipe's train step at B 128, IR_RECIPE_STEPS
    AdamW steps (dropout 0.1) on each train-step route in ROUTE_TURNS from
    the same seeded weights: every step's metrics and the final parameters
    and moments bit-equal; s/step of steps 2-n and 3-n, the capture's
    seconds and the graph pool's bytes; then PROFILED_STEPS more steps of
    the last fit of each route under ``torch.profiler``: the busy share
    (device time per step over the fit's s/step of steps 3-n) and the
    kernels and host launches per step. No kernel of the package runs."""
    import math

    import torch

    from multimodalanalytical_tpu_torch.training import Trainer

    batch = _ir_recipe_batch()
    counters = _flash_counters() + _decode_counters()
    for fn in counters:
        fn.launches = 0
    runs = {False: [], True: []}
    for turn, graph in enumerate(ROUTE_TURNS):
        trainer = Trainer(_flagship(), optimiser="adamw", lr=TRAIN_LR,
                          num_steps=IR_RECIPE_STEPS, clip_grad=1.0, cuda_graph=graph)
        run = _timed_fit(trainer, [batch], epochs=IR_RECIPE_STEPS, max_steps=IR_RECIPE_STEPS)
        _require(len(run["losses"]) == IR_RECIPE_STEPS
                 and all(math.isfinite(x) for x in run["losses"]), "non-finite training loss")
        if turn:
            _require_same_route("IR recipe", run, runs[False][0])
            run["state"] = None
        if turn >= len(ROUTE_TURNS) - 2:     # the last fit of each route
            run["profile"] = _profile_steps(trainer, batch, PROFILED_STEPS)
        runs[graph].append(run)
        print(f"IR recipe fit ({_route_name(graph)} route): {IR_RECIPE_STEPS} AdamW steps, B "
              f"{IR_RECIPE_BATCH}: {_route_line(run)}; losses "
              f"{[round(x, 4) for x in run['losses']]}", flush=True)
        del trainer
        torch.cuda.empty_cache()
    launched = {fn.__name__: fn.launches for fn in counters if fn.launches}
    for graph, route_runs in runs.items():
        prof, run = route_runs[-1]["profile"], route_runs[-1]
        print(f"IR recipe {_route_name(graph)} route: s/step (steps 2-{IR_RECIPE_STEPS}) "
              f"{[round(r['step_s'], 5) for r in route_runs]}, (steps 3-{IR_RECIPE_STEPS}) "
              f"{[round(r['replay_s'], 5) for r in route_runs]}; profiled {PROFILED_STEPS} "
              f"steps: device {prof['device_s']:.5f} s/step, busy share "
              f"{prof['device_s'] / run['replay_s']:.3f} (of steps 3-{IR_RECIPE_STEPS}), "
              f"{prof['kernels']:.0f} device kernels "
              f"and copies a step; host launches a step: {prof['graph_launches']:.0f} graph + "
              f"{prof['launches']:.0f} kernel", flush=True)
    print(f"IR recipe: both routes bit-equal at every step, in turns "
          f"{[_route_name(g) for g in ROUTE_TURNS]}; kernel launches {launched or 'none'}",
          flush=True)
    _require(runs[True][-1]["profile"]["graph_launches"] >= 1,
             "the graph route launched no graph")
    _require(not launched, "a kernel ran in the IR recipe's train step")


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
# Phase 5 (a): the planted fault's side stream sleeps this long before its
# host copies of the live tensors, which the next train step (~0.1 s) has
# updated by then; the fits' save routes.
PLANTED_SLEEP_CYCLES = 2_000_000_000   # ~1 s at the H100's ~1.98 GHz boost clock
# The planted fit runs first and carries the process's warm-up (cuBLAS, the
# first graph captures, the pinned host memory of two saves in flight).
EVAL_FIT_ROUTES = ("planted", "async", "sync", "eager")
# Requests made to the asynchronous fit's manager after the fit, each drained.
WARM_SAVES = 2
# Phase 5 (b), (c): predict and validation over PIPELINE_BATCHES batches of
# spectra 640.. at each of the trainer's PIPELINE_DEPTHS (the module constant
# patched), unprofiled in PIPELINE_ORDER, then once each under torch.profiler.
PIPELINE_BATCHES = 4
PIPELINE_DEPTHS = (0, 8)
PIPELINE_ORDER = (0, 8, 8, 0)


SMILES_EXTRA_TOKENS = ("S", "P", "F", "I", "n", "o", "s", "[nH]", "=", "#", "(", ")")
FORMULA_REGEX = r"([A-Z]{1}[a-z]?[0-9]*)"
FORMULA_VOCAB = 32


class FixedVocabTokenizer:
    """Stand-in for a fitted ``RegexTokenizer`` (``data/tokenizer.py`` needs
    the ``tokenizers`` package, which the card's machine lacks): the regex's
    tokens of ``corpus`` and ``extra``, then fillers up to ``vocab_size``
    (by default the SMILES target's: the flagship vocabulary of 320), with
    the same special tokens and ids (pad 0, bos 2, eos 3), the same
    ``vocab``, the same padded and truncated ``__call__`` rows (BOS, tokens,
    EOS) and the same ``batch_decode`` output (tokens joined by spaces,
    specials skipped), whose strings the chemistry engine parses as it
    parses the fitted tokenizer's (guided decoding's exact mode)."""

    def __init__(self, regex: str = SMILES_REGEX, corpus=SMILES_CORPUS,
                 extra=SMILES_EXTRA_TOKENS, vocab_size: int = VOCAB):
        import re

        self.regex = re.compile(regex)
        atoms = sorted({t for s in corpus for t in self.regex.findall(s)})
        atoms += [t for t in extra if t not in atoms]
        self.pad_token, self.unk_token, self.bos_token, self.eos_token = (
            "<pad>", "<unk>", "<bos>", "<eos>")
        tokens = [self.pad_token, self.unk_token, self.bos_token, self.eos_token] + atoms
        self.tokens = tokens + [f"<x{i}>" for i in range(vocab_size - len(tokens))]
        self.ids = {t: i for i, t in enumerate(self.tokens)}
        self.pad_token_id, self.bos_token_id, self.eos_token_id = 0, 2, 3
        self.vocab_size = vocab_size

    def __call__(self, texts, padding: str = "max_length", max_length: int = 0,
                 truncation: bool = True) -> dict:
        """Rows of BOS, tokens, EOS padded to ``max_length``; a longer row
        keeps its EOS, as ``RegexTokenizer`` truncates."""
        import numpy as np

        rows = [[self.bos_token_id] + self.encode(t) + [self.eos_token_id] for t in texts]
        rows = [r if len(r) <= max_length else r[:max_length - 1] + [self.eos_token_id]
                for r in rows]
        ids = np.zeros((len(rows), max_length), np.int32)
        mask = np.zeros((len(rows), max_length), np.int32)
        for i, row in enumerate(rows):
            ids[i, :len(row)], mask[i, :len(row)] = row, 1
        return {"input_ids": ids, "attention_mask": mask}

    def encode_lengths(self, texts) -> list:
        return [len(self.encode(t)) + 2 for t in texts]

    @property
    def vocab(self) -> dict:
        """token -> id, as the fitted tokenizer's (``GuidedDecoder`` reads it)."""
        return self.ids

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


def _synchronous(manager):
    """``manager`` with ``save_async`` as the synchronous route: drain the
    queue, then ``save`` (the trainer calls ``save_async`` only)."""
    def save_async(step, tree, metrics, fresh=()):
        manager.wait()
        manager.save(step, tree, metrics)

    manager.save_async = save_async
    return manager


def _planted_live_snapshot(manager):
    """The planted fault of phase 5 (a): ``manager.snapshot`` hands over the
    live tensors uncopied (with its event, as a real snapshot has), and the
    manager's side stream sleeps PLANTED_SLEEP_CYCLES before the host
    copies, so that they read the tensors after the next train step has
    updated them: a save publishes a later step's weights under its own."""
    import torch

    from multimodalanalytical_tpu_torch.training.checkpoint import Snapshot

    start = manager._start_host_copy

    def live(tree, fresh=()):
        device = torch.device(DEVICE, torch.cuda.current_device())
        event = torch.cuda.Event()
        event.record()
        return Snapshot(tree, event, device)

    def delayed(snap):
        if manager._stream is None:
            manager._stream = torch.cuda.Stream()
        with torch.cuda.stream(manager._stream):
            torch.cuda._sleep(PLANTED_SLEEP_CYCLES)
        return start(snap)

    manager.snapshot, manager._start_host_copy = live, delayed
    return manager


def _checkpoint_files(directory) -> tuple:
    """{checkpoint name: its state on the host} and the index."""
    import torch

    states = {p.name: torch.load(p / "state.pt", map_location="cpu", weights_only=True)
              for p in sorted(directory.iterdir()) if (p / "state.pt").is_file()}
    return states, json.loads((directory / "index.json").read_text())


def _trees_equal(got, want) -> bool:
    """Bit-equal tensors and equal other leaves, at the same places."""
    import torch

    if isinstance(want, torch.Tensor):
        return isinstance(got, torch.Tensor) and torch.equal(got, want)
    if isinstance(want, dict):
        return (isinstance(got, dict) and got.keys() == want.keys()
                and all(_trees_equal(got[k], want[k]) for k in want))
    if isinstance(want, (list, tuple)):
        return (isinstance(got, (list, tuple)) and len(got) == len(want)
                and all(_trees_equal(g, w) for g, w in zip(got, want)))
    return got == want


def _same_checkpoints(a, b) -> bool:
    """The two directories hold the same checkpoints, tensor for tensor,
    and the same index."""
    (states_a, index_a), (states_b, index_b) = _checkpoint_files(a), _checkpoint_files(b)
    return (index_a == index_b and states_a.keys() == states_b.keys()
            and all(_trees_equal(states_a[k], states_b[k]) for k in states_b))


def _eval_fit(tokenizer, train, val, directory, route: str) -> dict:
    """Phase 5's fit (2 epochs at B 128, validation each) into a fresh
    ``CheckpointManager`` at ``directory``, its saves on ``route``: "async"
    (the trainer's), "sync" (``_synchronous``) or "planted"
    (``_planted_live_snapshot``), or "eager" (the trainer's saves, the train
    step on its eager body: ``cuda_graph=False``; the others replay its
    graph). Returns the trainer, the manager, the
    losses, the fit's wall seconds and the host seconds inside each
    ``validate``, each ``save_async`` call, the end-of-fit drain and each
    ``train_step`` call (no synchronisation: the host's own time), in each
    enqueue of the host copies and in getting their pinned buffers within
    it, and the saving thread's seconds in each write. The manager's
    timers stay on it after the fit."""
    import torch

    from multimodalanalytical_tpu_torch.training import Trainer
    from multimodalanalytical_tpu_torch.training.checkpoint import CheckpointManager

    steps = EVAL_EPOCHS * len(train)
    trainer = Trainer(_flagship(), tokenizer, optimiser="adamw", lr=TRAIN_LR, num_steps=steps,
                      clip_grad=1.0, n_beams=EVAL_BEAMS, cuda_graph=route != "eager")
    checkpoints = CheckpointManager(directory)
    if route == "sync":
        _synchronous(checkpoints)
    elif route == "planted":
        _planted_live_snapshot(checkpoints)
    spent = {"validate": [], "save_async": [], "drain": [], "train_step": [], "host_copy": [],
             "pinned_alloc": [], "write": []}

    def timed(name, fn, synchronize):
        def wrapper(*args, **kwargs):
            if synchronize:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if synchronize:
                torch.cuda.synchronize()
            spent[name].append(time.perf_counter() - t0)
            return out
        return wrapper

    trainer.validate = timed("validate", trainer.validate, True)
    # The main thread's own seconds: no synchronisation around a request.
    checkpoints.save_async = timed("save_async", checkpoints.save_async, False)
    trainer._flush_pending_best = timed("drain", trainer._flush_pending_best, False)
    trainer.train_step = timed("train_step", trainer.train_step, False)
    checkpoints._write = timed("write", checkpoints._write, False)
    checkpoints._start_host_copy = timed("host_copy", checkpoints._start_host_copy, False)
    checkpoints._host_buffers = timed("pinned_alloc", checkpoints._host_buffers, False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = trainer.fit(train, val, epochs=EVAL_EPOCHS, checkpoints=checkpoints)
    torch.cuda.synchronize()
    return {"trainer": trainer, "checkpoints": checkpoints, "losses": losses,
            "fit_s": time.perf_counter() - t0, **spent}


def _pipeline_runs(what: str, owner, run, batches: int) -> dict:
    """``run()`` (a validate or predict over ``batches`` batches of
    ``owner``) at each of PIPELINE_DEPTHS (the trainer module's
    ``PIPELINE_DEPTH`` patched): unprofiled in PIPELINE_ORDER for the wall
    time, then once each under ``torch.profiler`` for the device time
    (kernels and copies). Prints s/batch, device s/batch, the busy share
    and the replays of each, and where the calling thread's seconds went in
    its first run (``eval_step``, the search and its replay dispatch, the
    detokenising inside the search or in ``submit`` / ``finish``); requires
    every run's result equal to depth 0's. Returns {depth: result}."""
    import torch

    from multimodalanalytical_tpu_torch.training import trainer as trainer_module

    pipeline, tokenizer = trainer_module._Pipeline, owner.tokenizer
    hooks = {"eval_step": (owner, owner.eval_step), "search": (owner, owner._decode),
             "detokenise": (tokenizer, tokenizer.batch_decode),
             "submit": (pipeline, pipeline.submit), "finish": (pipeline, pipeline.finish)}

    def at(depth):
        saved, trainer_module.PIPELINE_DEPTH = trainer_module.PIPELINE_DEPTH, depth
        host = {name: 0.0 for name in hooks}
        host["dispatch"] = 0.0

        def timed(name, fn):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    host[name] += time.perf_counter() - t0
                    if name == "search":
                        host["dispatch"] += owner.last_decode_stats["dispatch_s"]
            return wrapper

        for name, (obj, fn) in hooks.items():
            setattr(obj, fn.__name__, timed(name, fn))
        try:
            before = owner.decode_replays
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, owner.decode_replays - before, host
        finally:
            trainer_module.PIPELINE_DEPTH = saved
            for obj, fn in hooks.values():
                if obj is pipeline:
                    setattr(obj, fn.__name__, fn)
                else:
                    delattr(obj, fn.__name__)

    results, walls, replays, device, hosts = {}, {}, {}, {}, {}
    for depth in PIPELINE_ORDER:
        out, wall, count, host = at(depth)
        results.setdefault(depth, out)
        hosts.setdefault(depth, host)
        _require(out == results[0], f"{what} at depth {depth} returned other results than at 0")
        walls.setdefault(depth, []).append(wall / batches)
        replays.setdefault(depth, []).append(count)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for depth in PIPELINE_DEPTHS:
        with torch.profiler.profile(activities=activities) as prof:
            at(depth)
        device[depth] = _device_time(prof)[0] / batches
    for depth in PIPELINE_DEPTHS:
        wall = sum(walls[depth]) / len(walls[depth])
        host = {k: round(v / batches, 4) for k, v in hosts[depth].items()}
        print(f"eval path pipeline, {what}, depth {depth}: {[round(x, 4) for x in walls[depth]]} "
              f"s/batch over {batches} batches of {BATCH}; device time {device[depth]:.4f} "
              f"s/batch (kernels and copies, profiled run); busy share "
              f"{device[depth] / wall:.3f}; replays {replays[depth]} per run; host s/batch of "
              f"its first run {host}", flush=True)
    return results


def run_eval_path() -> dict:
    """Phase 5: (a) fit (2 epochs, validation each) on each of
    EVAL_FIT_ROUTES from the same seeded weights: the asynchronous route's
    checkpoints bit-equal to the synchronous one's, the planted fault's
    not; restore of ``best`` into a fresh model; WARM_SAVES more requests
    to the asynchronous manager; predict at K 30 and Table 4's scoring with
    rejection sampling off and on; (b) predict at K 30 and (c) validation
    over PIPELINE_BATCHES batches at each of PIPELINE_DEPTHS. Returns
    (the decode kernels' launches, the predicting trainer, the test
    batches) for the guided phase."""
    import math
    import tempfile

    import torch

    from multimodalanalytical_tpu_torch.cli.common import score_predictions
    from multimodalanalytical_tpu_torch.training import Trainer
    from multimodalanalytical_tpu_torch.training.checkpoint import restore_params

    start = time.perf_counter()
    tokenizer = FixedVocabTokenizer()
    train = _eval_loader(tokenizer, 0, EVAL_TRAIN)
    val = _eval_loader(tokenizer, EVAL_TRAIN, EVAL_VAL)
    test = _eval_loader(tokenizer, EVAL_TRAIN + EVAL_VAL, EVAL_TEST)
    extra = _eval_loader(tokenizer, EVAL_TRAIN + EVAL_VAL + EVAL_TEST, PIPELINE_BATCHES * BATCH)
    steps = EVAL_EPOCHS * len(train)
    counters = _decode_counters()
    for fn in counters:
        fn.launches = 0

    with tempfile.TemporaryDirectory() as tmp:
        fits = {route: _eval_fit(tokenizer, train, val, Path(tmp) / route.replace(" ", "_"),
                                 route)
                for route in EVAL_FIT_ROUTES}
        for route, fit in fits.items():
            busy = sum(fit["validate"]) + sum(fit["save_async"]) + sum(fit["drain"])
            print(f"eval path fit, {route} saves: {steps} AdamW steps at B {BATCH} in "
                  f"{fit['fit_s']:.4f} s ({(fit['fit_s'] - busy) / steps:.4f} s/step outside "
                  f"validation and saving); main thread in each save_async "
                  f"{[round(x, 4) for x in fit['save_async']]} s; end-of-fit drain "
                  f"{[round(x, 4) for x in fit['drain']]} s; validation "
                  f"{[round(x, 4) for x in fit['validate']]} s/pass (K 1); host s in each "
                  f"train_step call {[round(x, 4) for x in fit['train_step']]}; host copies "
                  f"enqueued in {[round(x, 4) for x in fit['host_copy']]} s (pinned "
                  f"buffers {[round(x, 4) for x in fit['pinned_alloc']]} s); saving thread's "
                  f"writes {[round(x, 4) for x in fit['write']]} s; losses "
                  f"{[round(x, 4) for x in fit['losses']]}; best step "
                  f"{fit['checkpoints'].best_step}; train step route "
                  f"{fit['trainer'].step_stats}", flush=True)
            _require(len(fit["losses"]) == steps
                     and all(math.isfinite(x) for x in fit["losses"]), "non-finite training loss")
            _require(len(fit["validate"]) == EVAL_EPOCHS, "validation did not run every epoch")
            for name in ("last", "best"):
                _require((fit["checkpoints"].directory / name).is_dir(), f"no {name} checkpoint")
        same = _same_checkpoints(Path(tmp) / "async", Path(tmp) / "sync")
        planted = _same_checkpoints(Path(tmp) / "planted", Path(tmp) / "sync")
        eager = _same_checkpoints(Path(tmp) / "eager", Path(tmp) / "async")
        names = sorted(_checkpoint_files(Path(tmp) / "sync")[0])
        print(f"eval path checkpoints {names}: asynchronous against synchronous saves "
              f"bit-equal {same}; the planted uncopied snapshot bit-equal {planted} (must be "
              f"rejected); the eager train step's fit (its last and every other checkpoint) "
              f"against the graph route's bit-equal {eager}", flush=True)
        _require(eager, "the eager train step's fit wrote other checkpoints than the graph's")
        _require(all(fits[r]["trainer"].step_stats["captures"] == 1
                     for r in EVAL_FIT_ROUTES if r != "eager")
                 and not fits["eager"]["trainer"].step_stats["graph"],
                 "a fit did not take its train-step route")
        _require(all(fit["losses"] == fits["sync"]["losses"] for fit in fits.values()),
                 "the fits took other steps")
        _require(same, "asynchronous saves wrote other checkpoints than synchronous ones")
        _require(not planted, "the checkpoint check did not reject the planted uncopied snapshot")
        trainer, checkpoints = fits["async"]["trainer"], fits["async"]["checkpoints"]
        val_steps = trainer.decode_steps

        # The best checkpoint into a fresh model: its params, bit for bit.
        best = checkpoints.restore("best")["params"]
        fresh = _flagship()
        fresh.load_state_dict(restore_params(checkpoints.directory / "best"))
        restored = fresh.state_dict()
        identical = all(torch.equal(restored[k].cpu(), best[k]) for k in best)
        print(f"restore best (step {checkpoints.best_step}) into a fresh model: "
              f"{len(best)} tensors bit-identical {identical}", flush=True)
        _require(identical and set(restored) == set(best), "restored params differ")

        # Requests once the manager holds its pinned buffers (the fit's two
        # requests allocated them), each drained before the next.
        fit = fits["async"]
        requested = len(fit["save_async"])
        for _ in range(WARM_SAVES):
            trainer._save_state(checkpoints, {})
            _require(checkpoints.wait(), "a save after the fit did not drain")
        state = checkpoints.restore("last")
        _require(state["step"] == trainer.global_step
                 and all(torch.equal(state["params"][k], v.cpu())
                         for k, v in trainer.model.state_dict().items()),
                 "a save after the fit wrote other weights than the trainer's")
        print(f"eval path saves after the fit: main thread in each save_async "
              f"{[round(x, 4) for x in fit['save_async'][requested:]]} s (pinned buffers "
              f"{[round(x, 4) for x in fit['pinned_alloc'][requested:]]} s); saving thread's "
              f"writes {[round(x, 4) for x in fit['write'][-WARM_SAVES:]]} s", flush=True)

    predictor = Trainer(fresh, tokenizer, n_beams=EVAL_BEAMS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predictions = predictor.predict(test, n_beams=EVAL_BEAMS)
    torch.cuda.synchronize()
    predict_s = (time.perf_counter() - t0) / len(test)
    _require(len(predictions["predictions"]) == EVAL_TEST
             and all(len(p) == EVAL_BEAMS for p in predictions["predictions"])
             and predictions["targets"] == [s for b in test for s in b["target_strings"]],
             "predict returned other rows or beams")
    _require(math.isfinite(predictions["avg_loss"]), "non-finite predict loss")
    print(f"eval path predict: K {EVAL_BEAMS}, {len(test)} batch(es) of {BATCH}: "
          f"{predict_s:.4f} s/batch ({BATCH / predict_s:.2f} spectra/s, graph capture "
          f"included: {predictor.last_decode_stats['capture_s']:.4f} s), "
          f"{predictor.decode_steps} decode steps, avg_loss {predictions['avg_loss']:.4f}",
          flush=True)

    # (b) and (c): the pipeline at depth 0 and 8 (the graphs are captured).
    _pipeline_runs(f"predict K {EVAL_BEAMS}", predictor,
                   lambda: predictor.predict(extra, n_beams=EVAL_BEAMS), PIPELINE_BATCHES)
    _pipeline_runs("validation K 1", trainer, lambda: trainer.validate(extra), PIPELINE_BATCHES)

    owners = [fit["trainer"] for fit in fits.values()] + [predictor]
    launches = {fn.__name__: fn.launches for fn in counters}
    decode_steps = sum(t.decode_steps for t in owners)
    replays = sum(t.decode_replays for t in owners)
    warmups = sum(t.decode_warmups for t in owners)
    cache_bytes = 2 * BATCH * MAX_LENGTH * EVAL_BEAMS * D_MODEL
    print(f"eval path decodes: validation {val_steps} decode steps in the fit; int8 KV cache "
          f"{cache_bytes} B per layer ({cache_bytes / 2**30:.3f} GiB, {LAYERS} layers) at K "
          f"{EVAL_BEAMS}; launches {launches} over {decode_steps} decode steps in {replays} "
          f"graph replays and {warmups} eager steps of graph captures (the fits' "
          f"validations, predict and the pipeline runs)", flush=True)
    for name, count in launches.items():
        _require(count == LAYERS * (replays + warmups),
                 f"{name} launched {count} times, want {LAYERS * (replays + warmups)}")
    # One batch of each decode through its graphs and through the eager loop.
    for what, owner, loader, beams in (("validation K 1", trainer, val, 1),
                                       (f"predict K {EVAL_BEAMS}", predictor, test,
                                        EVAL_BEAMS)):
        batch = loader[0]
        decoder = owner.beam_decoder()
        args = (decoder, batch["encoder_inputs"], batch["encoder_mask"], beams)
        _require_bit_equal(f"eval path {what}", _graph_decode(*args), _eager_decode(*args))
    for rejection in (False, True):
        metrics = score_predictions(predictions, molecules=True, rejection_sampling=rejection)
        tops = {k: round(v, 4) for k, v in metrics.items()
                if k in ("Top-1", "Top-5", "Top-10", f"Top-{EVAL_BEAMS}")}
        print(f"eval path scoring, rejection sampling {rejection}: {tops} (random weights: "
              f"reported, not asserted)", flush=True)
    del fits
    print(f"phase 5 done in {time.perf_counter() - start:.1f} s", flush=True)
    return launches, predictor, test


# ---------------------------------------------------------------- phase 6
def run_guided_path(predictor, tokenizer, test) -> dict:
    """Formula-guided predict at K 10 on phase 5's restored model with the
    corpus targets: the surrogate hook inside the captured step, the decode
    graph against the eager loop bit for bit, every finished beam within
    rule 3's heavy-atom bound of its target; then the exact hook (one host
    call per step, so its steps run eagerly) on one batch. Returns the
    decode kernels' launches in the surrogate predict."""
    import numpy as np
    import torch

    from multimodalanalytical_tpu_torch.generation import guided_hook_builder
    from multimodalanalytical_tpu_torch.generation.guided import (
        N_LOOKAHEAD,
        build_token_atom_table,
    )

    counters = _decode_counters()
    surrogate = guided_hook_builder(tokenizer, "surrogate")
    for fn in counters:
        fn.launches = 0
    before = (predictor.decode_replays, predictor.decode_warmups)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predictions = predictor.predict(test, n_beams=BEAMS, guided=surrogate)
    torch.cuda.synchronize()
    guided_s = (time.perf_counter() - t0) / len(test)
    launches = {fn.__name__: fn.launches for fn in counters}
    replays = predictor.decode_replays - before[0]
    warmups = predictor.decode_warmups - before[1]
    stats = predictor.last_decode_stats
    print(f"guided predict (surrogate): K {BEAMS}, {len(test)} batch(es): {guided_s:.4f} "
          f"s/batch (graph capture included: {stats['capture_s']:.4f} s), {stats['steps']} "
          f"decode steps, {replays} replays, {warmups} eager steps of captures; launches "
          f"{launches}", flush=True)
    _require(stats["graph"], "the surrogate-guided decode did not run through its graphs")
    _require(len(predictions["predictions"]) == EVAL_TEST
             and all(len(p) == BEAMS for p in predictions["predictions"]),
             "guided predict returned other rows or beams")
    for name, count in launches.items():
        _require(count == LAYERS * (replays + warmups),
                 f"{name} launched {count} times, want {LAYERS * (replays + warmups)}")

    batch = test[0]
    hook = {"logits_hook": surrogate.hook,
            "hook_init": surrogate.state_for(batch, BEAMS, device=DEVICE)}
    args = (predictor.beam_decoder(), batch["encoder_inputs"], batch["encoder_mask"], BEAMS)
    graph = _graph_decode(*args, **hook)
    _require_bit_equal(f"guided predict (surrogate) K {BEAMS}", graph, _eager_decode(*args, **hook))
    # Rule 3 on every finished beam (an EOS and a finite score): its heavy
    # atoms, by the guide's own token table, within its target's.
    table = build_token_atom_table(tokenizer.vocab, [tokenizer.pad_token, tokenizer.unk_token,
                                                     tokenizer.bos_token, tokenizer.eos_token])
    seqs, scores = graph[0], graph[1]
    counts = table[seqs].sum(axis=2)[..., :N_LOOKAHEAD]
    target = hook["hook_init"]["target"].cpu().numpy()[..., :N_LOOKAHEAD]
    finished = (seqs == tokenizer.eos_token_id).any(axis=2) & np.isfinite(scores)
    within = (counts <= target).all(axis=2)
    print(f"guided predict (surrogate): {int(finished.sum())} finished beams of "
          f"{finished.size}, all within rule 3's heavy-atom bound "
          f"{bool(within[finished].all())}", flush=True)
    _require(finished.any() and bool(within[finished].all()),
             "a finished guided beam exceeds its target's heavy atoms")

    exact = guided_hook_builder(tokenizer, "exact")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact_predictions = predictor.predict(test[:1], n_beams=BEAMS, guided=exact)
    exact_s = time.perf_counter() - t0
    stats = predictor.last_decode_stats
    print(f"guided predict (exact, one host call per step, eager by design): 1 batch of "
          f"{BATCH}: {exact_s:.4f} s, {stats['steps']} decode steps, graph {stats['graph']}",
          flush=True)
    _require(not stats["graph"] and len(exact_predictions["predictions"]) == BATCH,
             "the exact-guided predict did not run as designed")
    return launches


# ---------------------------------------------------------------- phase 7
def _kernel_split(rows) -> dict:
    """Device ms of the decode kernels #1-#3 and of everything else, from
    :func:`_device_time`'s rows."""
    split = {"#1 select attention": 0.0, "#2 cross attention": 0.0, "#3 decode FFN": 0.0,
             "other": 0.0}
    for ms, _, name in rows:
        key = ("#1 select attention" if "select_attention_kernel" in name
               else "#2 cross attention" if any(
                   k in name for k in ("cross_attention_kernel", "cross_stats_kernel",
                                       "cross_value_kernel"))
               else "#3 decode FFN" if "ffn_" in name else "other")
        split[key] += ms
    return split


def run_multimodal_path() -> dict:
    """Phase 7, serving: three seeded 128-spectrum requests of the
    multimodal recipe (Ls 279) through ``InferenceEngine.decode_batch`` at
    beam 10 and max length 128, each decode stage a replayed CUDA graph
    (captured by an earlier request, timed apart); every decode kernel
    launched 6 x the replays; the same requests through the eager loop, bit
    for bit; the encoder and the cross K/V projection timed per request; one
    request profiled for its device time, busy share and kernel split.
    Returns the decode kernels' launches over the three requests."""
    import torch

    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine
    from multimodalanalytical_tpu_torch.training.trainer import to_device

    model = _multimodal_model()
    engine = InferenceEngine(model, n_beams=BEAMS, batch_size=BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.decode_batch(*_multimodal_request(seed=700))      # captures the graphs; not counted
    first_s = time.perf_counter() - t0
    capture = engine.last_stats
    requests = [_multimodal_request(seed) for seed in (701, 702, 703)]
    real = [round(int(mask.sum()) / BATCH, 1) for _, mask in requests]
    print(f"multimodal serving: Formula {MM_FORMULA} + Multiplets {MM_MULTIPLETS} + Carbon "
          f"{MM_CARBON} + IR {MM_PATCHES} x {MM_PATCH} = Ls {MM_LS}, {real} valid keys per "
          f"row; graph capture (first request): {capture['capture_s']:.4f} s for "
          f"{capture['warmup_steps']} stages, first request {first_s:.4f} s in all", flush=True)
    launches, per_batch, results = _serve_requests(engine, requests, "multimodal", model)

    dmodel = engine.model
    inputs, mask = requests[0]
    inputs, mask = to_device(inputs, DEVICE), torch.as_tensor(mask, device=DEVICE)
    with torch.no_grad():
        encode_ms = _time_ms(lambda: dmodel.encode(inputs, mask), iters=5)
        hidden = dmodel.encode(inputs, mask)
        project_ms = _time_ms(lambda: dmodel.decoder.project_cross_kv(hidden), iters=5)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        engine.decode_batch(*requests[0])
        torch.cuda.synchronize()
    device_s, rows, _, graphs = _device_time(prof)
    split = _kernel_split(rows)
    print(f"multimodal serving, one request profiled: device time {device_s:.4f} s (kernels "
          f"and copies only), busy share {device_s / per_batch:.3f} (device / unprofiled "
          f"s/batch), {graphs} graph launches; encoder {encode_ms:.4f} ms and cross K/V "
          f"projection {project_ms:.4f} ms per request (CUDA events); device ms by kernel "
          f"{ {k: round(v, 2) for k, v in split.items()} }", flush=True)
    for ms, calls, kernel in rows[:PROFILE_TOP]:
        print(f"  {100 * ms / (device_s * 1e3):5.1f}% {ms:10.2f} ms x {calls:6d}  "
              f"{kernel[:100]}", flush=True)
    _require(graphs >= results[0][2]["replays"], "the profiled request did not replay graphs")
    del engine, model, dmodel, hidden
    torch.cuda.empty_cache()
    return launches


# Phase 12: beam-decoding the RLE model (phase 3's) on the card.
RLE_REQUEST_SEEDS = (1201, 1202, 1203)


def _rle_request(seed: int) -> tuple:
    """A seeded 128-spectrum RLE request: row lengths drawn from
    RLE_MIN_LEN..RLE_MAX_LEN and tail-padded to RLE_MAX_LEN, row 0 at full
    length, the last row fully padded (batch padding)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(RLE_MIN_LEN, RLE_MAX_LEN + 1, BATCH)
    lengths[0], lengths[-1] = RLE_MAX_LEN, 0
    keep = np.arange(RLE_MAX_LEN)[None, :] < lengths[:, None]
    ids = np.where(keep, rng.integers(4, RLE_VOCAB, (BATCH, RLE_MAX_LEN)), 0)
    return {"RLE": ids.astype(np.int64)}, keep.astype(np.int32)


def _rle_collator():
    """(collator, tokenizer) as the serve CLI's artifact gives them for the
    RLE recipe: a run-length preprocessor at its 4090-token cap (a stand-in
    tokenizer carries its pad id: the card's machine has no ``tokenizers``,
    and the engine's warm batch, a record without a spectrum, needs nothing
    else of it) and the fixed-vocabulary SMILES stand-in, padded to B 128."""
    from multimodalanalytical_tpu_torch.data.collator import MultiModalCollator
    from multimodalanalytical_tpu_torch.data.preprocessing import RunLengthEncodingPreprocessor

    rle = RunLengthEncodingPreprocessor()
    rle.max_sequence_length = RLE_MAX_LEN
    rle.tokenizer = FixedVocabTokenizer(r"\S+", (), (), RLE_VOCAB)
    smiles = FixedVocabTokenizer()
    collator = MultiModalCollator({"RLE": rle, "Smiles": smiles}, RLE_DATA_CONFIG,
                                  max_target_length=MAX_LENGTH, pad_to_batch_size=BATCH)
    return collator, smiles


def run_rle_serving() -> dict:
    """Phase 12, serving an RLE model: phase 3's flagship-width RLE model
    (bf16, int8 KV cache, seeded weights) behind ``InferenceEngine`` built
    as the serve CLI builds it (a collator over RLE_DATA_CONFIG: its
    constructor decodes a warm batch, so the first request captures
    nothing), three seeded requests at B 128, K 10, max length 128 through
    the decode graphs (rows of 2173-4090 tokens padded to 4090), every
    decode kernel launched 6 x the replays and flash #5 6 x the requests
    (the encoder at L >= 2048), bit-equal to the eager loop; s/batch with
    the first request beside the steady ones, the device time, busy share
    and kernel split of one profiled request, the encoder's ms and the peak
    device memory beside what is held between requests, a standalone
    encode's peak and #2's workspace. Returns the launches of #1-#3 and of
    #5's forward."""
    import torch

    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine
    from multimodalanalytical_tpu_torch.ops import beam_attention as ba
    from multimodalanalytical_tpu_torch.training.trainer import to_device

    phase_t0 = time.perf_counter()
    flash_fwd = _flash_counters()[0]
    torch.cuda.reset_peak_memory_stats()
    model = _rle_model(dropout=0.0, use_flash=True)
    collator, tokenizer = _rle_collator()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = InferenceEngine(model, n_beams=BEAMS, batch_size=BATCH, collator=collator,
                             tokenizer=tokenizer)
    build_s = time.perf_counter() - t0
    warm = engine.warm_stats
    _require(warm["graph"] and warm["warmup_steps"] > 0,
             "the RLE engine's warm-up captured no decode graphs")
    requests = [_rle_request(seed) for seed in RLE_REQUEST_SEEDS]
    t0 = time.perf_counter()
    engine.decode_batch(*requests[0])
    first_s = time.perf_counter() - t0
    first = engine.last_stats
    _require(first["capture_s"] == 0 and first["warmup_steps"] == 0 and first["graph"],
             "the first RLE request captured its decode graphs: the warm-up missed its shape")
    valid = [round(int(mask.sum()) / BATCH, 1) for _, mask in requests]
    print(f"RLE serving: Ls {RLE_MAX_LEN}, {valid} valid keys per row; engine built in "
          f"{build_s:.4f} s (warm batch: capture {warm['capture_s']:.4f} s for "
          f"{warm['warmup_steps']} stages); first request {first_s:.4f} s", flush=True)
    launches, per_batch, results = _serve_requests(engine, requests, "RLE", model,
                                                   encoder_counters=(flash_fwd,))
    print(f"RLE serving: first request {first_s:.4f} s against a steady {per_batch:.4f} "
          f"s/batch", flush=True)

    dmodel = engine.model
    inputs, mask = requests[1]
    inputs, mask = to_device(inputs, DEVICE), torch.as_tensor(mask, device=DEVICE)
    serve_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    held_gb = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        encode_ms = _time_ms(lambda: dmodel.encode(inputs, mask), iters=3)
    encode_gb = torch.cuda.max_memory_allocated() / 2 ** 30 - held_gb
    cross_ws = ba.cross_plan(BATCH, BEAMS, HEADS, D_MODEL // HEADS, RLE_MAX_LEN, 2)
    print(f"RLE serving memory: peak {serve_peak_gb:.2f} GiB over the engine's build and the "
          f"graph and eager requests; held between requests {held_gb:.2f} GiB (weights, "
          f"request tensors, graph pools); a standalone encode adds {encode_gb:.2f} GiB at its "
          f"peak; #2's split-form workspace {cross_ws.workspace_bytes} bytes a call (K "
          f"{BEAMS}, Ls {RLE_MAX_LEN}, {cross_ws.tile_keys}-key tiles)", flush=True)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        engine.decode_batch(*requests[1])
        torch.cuda.synchronize()
    device_s, rows, _, graphs = _device_time(prof)
    split = _kernel_split(rows)
    peak_gb = max(serve_peak_gb, torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"RLE serving, one request profiled: device time {device_s:.4f} s (kernels and "
          f"copies only), busy share {device_s / per_batch:.3f} (device / unprofiled s/batch), "
          f"{graphs} graph launches; #2 cross attention {split['#2 cross attention']:.2f} ms, "
          f"{100 * split['#2 cross attention'] / (device_s * 1e3):.1f}% of device time; encoder "
          f"{encode_ms:.4f} ms per request (CUDA events); device ms by kernel "
          f"{ {k: round(v, 2) for k, v in split.items()} }; peak device memory {peak_gb:.2f} GiB",
          flush=True)
    for ms, calls, kernel in rows[:PROFILE_TOP]:
        print(f"  {100 * ms / (device_s * 1e3):5.1f}% {ms:10.2f} ms x {calls:6d}  "
              f"{kernel[:100]}", flush=True)
    _require(graphs >= results[1][2]["replays"], "the profiled request did not replay graphs")
    del engine, model, dmodel, inputs, mask
    torch.cuda.empty_cache()
    print(f"phase 12 done in {time.perf_counter() - phase_t0:.1f} s", flush=True)
    return launches


def run_multimodal_training() -> None:
    """Phase 7, training: one dropout-0 step of the bf16 multimodal model
    against the same weights in fp32 (loss and gradient norm); three AdamW
    steps at B 128 with modality dropout over Multiplets, Carbon and IR,
    whose dropped spans must be the modality segments of the batch; then a
    batch with the multiplets as XVal dicts: unit values give the token-id
    forward bit for bit, seeded values a finite other one, and a train step
    on it drops the same dict-aware segments."""
    import math

    import numpy as np
    import torch

    from multimodalanalytical_tpu_torch.training import Trainer
    from multimodalanalytical_tpu_torch.training import trainer as trainer_module
    from multimodalanalytical_tpu_torch.training.trainer import to_device

    inputs, mask = _multimodal_request(seed=710)
    batch = {"encoder_inputs": inputs, "encoder_mask": mask,
             **_targets(np.random.default_rng(711), BATCH)}
    real_tokens = int(mask.sum())
    routes = {}
    for dtype in ("bfloat16", "float32"):
        routes[dtype] = _step_twice(_multimodal_model(dtype=dtype, dropout=0.0), batch)
        torch.cuda.empty_cache()
        loss, grad_norm, seconds, peak = routes[dtype]
        print(f"multimodal train step {dtype}, dropout 0: loss {loss:.6f} grad_norm "
              f"{grad_norm:.6f}; {seconds:.4f} s/step ({real_tokens / seconds:.1f} encoder "
              f"tokens/s real); peak {peak:.2f} GiB", flush=True)
    (b_loss, b_norm, *_), (f_loss, f_norm, *_) = routes["bfloat16"], routes["float32"]
    loss_rel, norm_rel = abs(b_loss - f_loss) / abs(f_loss), abs(b_norm - f_norm) / abs(f_norm)
    print(f"multimodal train step bf16 vs fp32: loss rel diff {loss_rel:.3e} (tol "
          f"{MM_LOSS_RTOL}), grad_norm rel diff {norm_rel:.3e} (tol {MM_GRAD_NORM_RTOL})",
          flush=True)
    _require(loss_rel <= MM_LOSS_RTOL and norm_rel <= MM_GRAD_NORM_RTOL,
             "the bf16 multimodal train step disagrees with the fp32 one")

    want = [(MM_FORMULA, MM_FORMULA + MM_MULTIPLETS),
            (MM_FORMULA + MM_MULTIPLETS, MM_LS - MM_PATCHES), (MM_LS - MM_PATCHES, MM_LS)]
    dropped_spans = []
    original = trainer_module.apply_modality_dropout

    def recording(encoder_mask, droppable, keep):
        dropped_spans.append(list(droppable))
        return original(encoder_mask, droppable, keep)

    model = _multimodal_model()
    trainer = Trainer(model, optimiser="adamw", lr=TRAIN_LR, num_steps=MM_TRAIN_STEPS + 1,
                      clip_grad=1.0, modality_dropout=MM_MODALITY_DROPOUT)
    trainer_module.apply_modality_dropout = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = trainer.fit([batch], epochs=MM_TRAIN_STEPS, max_steps=MM_TRAIN_STEPS)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / MM_TRAIN_STEPS
        xval, _ = _multimodal_request(seed=710, xval=True)
        xval_loss = float(trainer.train_step(dict(batch, encoder_inputs=xval))["loss"])
    finally:
        trainer_module.apply_modality_dropout = original
    print(f"multimodal train fit: {MM_TRAIN_STEPS} AdamW steps, B {BATCH}, modality dropout "
          f"over {MM_MODALITY_DROPOUT}: {step_s:.4f} s/step (first step included; "
          f"{real_tokens / step_s:.1f} encoder tokens/s real); losses "
          f"{[round(x, 4) for x in losses]}; segments dropped from {dropped_spans[0]}; a step "
          f"on the XVal batch: loss {xval_loss:.4f}", flush=True)
    _require(len(losses) == MM_TRAIN_STEPS and all(math.isfinite(x) for x in losses)
             and math.isfinite(xval_loss), "non-finite multimodal training loss")
    # The body runs in Python at each key's first (eager) step and at its
    # capture; a replay draws on the host and runs the captured mask.
    stats = trainer.step_stats
    _require(len(dropped_spans) == stats["eager_steps"] + stats["captures"]
             and stats["eager_steps"] + stats["replays"] == MM_TRAIN_STEPS + 1
             and all(spans == want for spans in dropped_spans),
             f"modality dropout spans {dropped_spans} are not the segments {want} ({stats})")

    model.eval()
    unit = dict(xval, Multiplets=dict(xval["Multiplets"], numerical_values=np.ones_like(
        xval["Multiplets"]["numerical_values"])))
    args = [torch.as_tensor(batch[k], device=DEVICE)
            for k in ("encoder_mask", "decoder_ids", "decoder_mask", "labels")]
    with torch.no_grad():
        logits = {name: model(to_device(x, DEVICE), *args)["logits"]
                  for name, x in (("ids", inputs), ("unit", unit), ("xval", xval))}
    same = torch.equal(logits["ids"], logits["unit"])
    finite = bool(torch.isfinite(logits["xval"]).all())
    moved = (logits["xval"] - logits["ids"]).abs().max().item()
    print(f"multimodal XVal forward (Multiplets as numerical_encoding dicts): logits "
          f"{tuple(logits['xval'].shape)}, finite {finite}; unit values bit-equal to the "
          f"token-id forward {same}; seeded values move the logits by up to {moved:.4f}",
          flush=True)
    _require(same and finite and moved > 0, "the XVal forward is wrong")
    del model, trainer, logits
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 8
def _align_model():
    import torch

    from multimodalanalytical_tpu_torch.models.config import AlignConfig, ModelConfig
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel

    cfg = ModelConfig(
        d_model=D_MODEL, encoder_layers=LAYERS, decoder_layers=LAYERS,
        encoder_attention_heads=HEADS, decoder_attention_heads=HEADS,
        encoder_ffn_dim=FFN, decoder_ffn_dim=FFN, vocab_size=VOCAB, dtype="bfloat16",
        max_target_length=MAX_LENGTH, align_config=AlignConfig(**ALIGN_CONFIG))
    dev = torch.device(DEVICE)
    return Seq2SeqModel(cfg, ALIGN_DATA_CONFIG, "Smiles", device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))


def _align_batch(tokenizer, seed: int, dummies: int = 0, dummy_seed=None) -> dict:
    """A seeded B 128 batch of the align recipe: Formula ids, 24 IR patches
    of 75, corpus SMILES targets and 1800-point align targets (a spectrum
    shared by the batch, three Gaussian bands, plus per-row noise, in
    [0, 1]). The last ``dummies`` rows are batch padding as the collator
    pads: fully masked, labels -100, zero align targets; ``dummy_seed``
    fills their inputs with other values (which must not matter)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(6, MM_FORMULA + 1, BATCH)
    keep = np.arange(MM_FORMULA)[None, :] < lengths[:, None]
    formula = np.where(keep, rng.integers(4, 32, (BATCH, MM_FORMULA)), 0).astype(np.int64)
    ir = rng.random((BATCH, MM_PATCHES, MM_PATCH)).astype(np.float32)
    mask = np.concatenate([keep, np.ones((BATCH, MM_PATCHES), bool)], axis=1).astype(np.int32)
    smiles = [SMILES_CORPUS[i] for i in rng.integers(0, len(SMILES_CORPUS), BATCH)]
    dec = np.zeros((BATCH, EVAL_TARGET_LEN), np.int64)
    labels = np.full((BATCH, EVAL_TARGET_LEN), -100, np.int64)
    for row, s in enumerate(smiles):
        ids = tokenizer.encode(s)
        dec[row, : len(ids) + 1] = [tokenizer.bos_token_id] + ids
        labels[row, : len(ids) + 1] = ids + [tokenizer.eos_token_id]
    grid = np.linspace(0.0, 1.0, ALIGN_CONFIG["output_dimension"])
    bands = sum(h * np.exp(-((grid - c) / w) ** 2)
                for h, c, w in ((0.8, 0.2, 0.02), (0.5, 0.55, 0.05), (0.6, 0.8, 0.03)))
    target = np.clip(bands[None, :] + 0.05 * rng.random((BATCH, grid.size)), 0.0, 1.0)
    batch = {"encoder_inputs": {"Formula": formula, "IR": ir}, "encoder_mask": mask,
             "decoder_ids": dec, "decoder_mask": (labels != -100).astype(np.int32),
             "labels": labels, "target_strings": smiles,
             "align_target": target.astype(np.float32), "n_valid": BATCH - dummies}
    if dummies:
        rows = slice(BATCH - dummies, BATCH)
        fill = np.random.default_rng(dummy_seed) if dummy_seed is not None else None
        batch["encoder_mask"][rows] = 0
        batch["labels"][rows] = -100
        batch["decoder_mask"][rows] = 0
        batch["align_target"][rows] = 0.0 if fill is None else fill.random((dummies, grid.size))
        if fill is not None:
            formula[rows] = fill.integers(4, 32, (dummies, MM_FORMULA))
            ir[rows] = fill.random((dummies, MM_PATCHES, MM_PATCH))
    return batch


def run_align_path() -> None:
    """Phase 8: the align recipe at full width. ``Trainer.fit`` takes 6
    AdamW steps on the repeated B 128 batch with one validation pass (K 1)
    and a ``CheckpointManager``: every loss finite, loss = ce + 50 x
    alignment_loss within fp32 rounding at every step, the alignment loss
    above 0 and falling; ``best`` restored into a fresh model bit for bit,
    the align network included. Then dummy rows: the batch with its last 28
    rows as batch padding gives the align loss of its first 100 rows alone
    (to bf16 rounding, ALIGN_DUMMY_RTOL), and the same bits whatever the
    dummy rows hold."""
    import math
    import tempfile

    import torch

    from multimodalanalytical_tpu_torch.training import Trainer
    from multimodalanalytical_tpu_torch.training.checkpoint import (
        CheckpointManager,
        restore_params,
    )
    from multimodalanalytical_tpu_torch.training.trainer import device_batch

    tokenizer = FixedVocabTokenizer()
    batch = _align_batch(tokenizer, seed=800)
    model = _align_model()
    trainer = Trainer(model, tokenizer, optimiser="adamw", lr=TRAIN_LR, num_steps=ALIGN_STEPS,
                      clip_grad=1.0)
    steps, validations = [], []
    train_step, validate = trainer.train_step, trainer.validate
    trainer.train_step = lambda b: steps.append(train_step(b)) or steps[-1]
    trainer.validate = lambda *a, **k: validations.append(validate(*a, **k)) or validations[-1]
    with tempfile.TemporaryDirectory() as tmp:
        checkpoints = CheckpointManager(Path(tmp) / "checkpoints")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = trainer.fit([batch] * ALIGN_STEPS, [batch], epochs=1, checkpoints=checkpoints)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        rows = [{k: float(m[k]) for k in ("loss", "model_only_loss", "alignment_loss")}
                for m in steps]
        lam = ALIGN_CONFIG["loss_lambda"]
        identity = max(abs(r["loss"] - (r["model_only_loss"] + lam * r["alignment_loss"]))
                       / abs(r["loss"]) for r in rows)
        align = [r["alignment_loss"] for r in rows]
        print(f"align fit: {ALIGN_STEPS} AdamW steps at B {BATCH} and one validation (K 1) in "
              f"{fit_s:.4f} s; losses {[round(x, 4) for x in losses]}; ce "
              f"{[round(r['model_only_loss'], 4) for r in rows]}; alignment_loss "
              f"{[round(x, 6) for x in align]}; max |loss - (ce + {lam} x align)| / loss "
              f"{identity:.3e} (tol {ALIGN_IDENTITY_RTOL}); validation {validations}",
              flush=True)
        _require(len(losses) == ALIGN_STEPS and all(math.isfinite(x) for x in losses),
                 "non-finite align training loss")
        _require(identity <= ALIGN_IDENTITY_RTOL, "loss != ce + lambda x alignment_loss")
        _require(min(align) > 0 and align[-1] < align[0], "the alignment loss did not fall")
        _require(len(validations) == 1 and validations[0]["val_alignment_loss"] > 0,
                 "the validation pass did not report the alignment loss")
        best = checkpoints.restore("best")["params"]
        fresh = _align_model()
        fresh.load_state_dict(restore_params(checkpoints.directory / "best"))
        restored = fresh.state_dict()
        identical = all(torch.equal(restored[k].cpu(), best[k]) for k in best)
        head = [k for k in best if k.startswith("align_network.")]
        print(f"align restore best (step {checkpoints.best_step}) into a fresh model: "
              f"{len(best)} tensors ({len(head)} of the align network) bit-identical "
              f"{identical}", flush=True)
        _require(identical and set(restored) == set(best) and len(head) == 8,
                 "restored align params differ")

    model.eval()
    keys = ("encoder_mask", "decoder_ids", "decoder_mask", "labels", "align_target")

    def align_loss(b, rows=BATCH):
        dev = device_batch(b, torch.device(DEVICE))
        cut = {k: dev[k][:rows] for k in keys}
        with torch.no_grad():
            return float(model({m: x[:rows] for m, x in dev["encoder_inputs"].items()},
                               *(cut[k] for k in keys))["alignment_loss"])

    valid = BATCH - ALIGN_DUMMIES
    padded = align_loss(_align_batch(tokenizer, seed=801, dummies=ALIGN_DUMMIES))
    other = align_loss(_align_batch(tokenizer, seed=801, dummies=ALIGN_DUMMIES, dummy_seed=9))
    alone = align_loss(_align_batch(tokenizer, seed=801), rows=valid)
    rel = abs(padded - alone) / alone
    print(f"align dummy rows: B {BATCH} with {ALIGN_DUMMIES} dummy rows {padded:.7f}, the same "
          f"with other dummy contents {other:.7f} (bit-equal {padded == other}), the {valid} "
          f"valid rows alone {alone:.7f}: rel diff {rel:.3e} (tol {ALIGN_DUMMY_RTOL})",
          flush=True)
    _require(padded == other and rel <= ALIGN_DUMMY_RTOL, "dummy rows change the align loss")
    del model, fresh, trainer
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 9
PRESET_REQUEST_SEEDS = (900, 901)          # the capturing request, the counted one
PRESET_TRAINED = ("hf_bart_medium", "t5_small")
PRESET_TRAIN_STEPS = 3
# bf16 against fp32 on one dropout-0 step: the loss within MM_LOSS_RTOL, the
# gradient norm within MM_GRAD_NORM_RTOL, and for T5 within
# T5_GRAD_NORM_RTOL: its unscaled attention makes random-weight logits ~8
# wide, and the JAX package's own bf16 step is 7.9% off its fp32 one in
# gradient norm at t5_small's widths (seeded weights, B 4, on the CPU).
T5_GRAD_NORM_RTOL = 0.1
BUCKET_SPAN = 4096
# The reference's executed HF graphs (tests/golden/reference_model_goldens.npz,
# read with numpy alone) at their widths, held as tests/test_reference_model_
# parity.py holds the JAX package: logits rtol 2e-4 / atol 2e-5, loss 1e-5 /
# 1e-6, fp32 with TF32 off.
GOLDEN_PATH = REPO / "tests" / "golden" / "reference_model_goldens.npz"
GOLDEN_CASES = {"bart_executed_graph": "BartForConditionalGeneration",
                "t5_executed_graph": "T5ForConditionalGeneration"}
GOLDEN_MODEL = {"d_model": 32, "encoder_layers": 2, "decoder_layers": 2,
                "encoder_attention_heads": 4, "decoder_attention_heads": 4,
                "encoder_ffn_dim": 64, "decoder_ffn_dim": 64, "dropout": 0.1,
                "max_position_embeddings": 64}
GOLDEN_VOCAB = 50
GOLDEN_DATA_CONFIG = {
    "Formula": {"type": "text", "column": "molecular_formula", "target": False,
                "vocab_size": 32, "pad_token_id": 0, "preprocessor_arguments": {}},
    "IR": {"type": "1D_patches", "column": "ir", "target": False,
           "preprocessor_arguments": {"patch_size": 16}},
    "Smiles": {"type": "text", "column": "smiles", "target": True,
               "vocab_size": GOLDEN_VOCAB, "pad_token_id": 0, "preprocessor_arguments": {}},
}
GOLDEN_RTOL, GOLDEN_ATOL, GOLDEN_LOSS_RTOL, GOLDEN_LOSS_ATOL = 2e-4, 2e-5, 1e-5, 1e-6


def _preset_model(name: str, dtype: str = "bfloat16", dropout=None):
    """The shipped model config ``name`` resolved by the port at vocab 320
    on DATA_CONFIG (Formula 12 + IR 14 x 125), seeded random weights."""
    import torch

    from multimodalanalytical_tpu_torch.models.config import resolve_model_config
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel

    model_config = dict(PRESET_MODEL_CONFIGS[name], dtype=dtype, max_target_length=MAX_LENGTH)
    if dropout is not None:
        model_config["dropout"] = dropout
    cfg = resolve_model_config(model_config, vocab_size=VOCAB, pad_token_id=0, bos_token_id=2,
                               eos_token_id=3)
    dev = torch.device(DEVICE)
    return Seq2SeqModel(cfg, DATA_CONFIG, "Smiles",
                        multimodal_norm=model_config["multimodal_norm"], device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))


def _plain_attention_ms(dmodel, bounds) -> tuple:
    """Device ms per request of the plain self- and cross-attention route of
    the decoder's 6 layers (T5's): one layer's call timed by CUDA-graph
    replay at each stage's last position, weighted by the stage's steps
    (a random-weight request decodes all 127)."""
    import torch

    cfg = dmodel.config
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(5)
    layer = dmodel.decoder.layers[0]
    x = torch.randn(BATCH * BEAMS, cfg.d_model, generator=g, device=dev).bfloat16()
    cache = torch.randn(2, BATCH, MAX_LENGTH * BEAMS, cfg.d_model, generator=g,
                        device=dev).bfloat16()
    anc = torch.randint(0, BEAMS, (BATCH, BEAMS, MAX_LENGTH), generator=g, device=dev,
                        dtype=torch.int32)
    kv = [torch.randn(BATCH, FORMULA_LEN + N_PATCHES, cfg.d_model, generator=g,
                      device=dev).bfloat16() for _ in range(2)]
    bias = torch.zeros(BATCH, FORMULA_LEN + N_PATCHES, device=dev)
    self_ms, start = 0.0, 0
    with torch.no_grad():
        for bound in bounds:
            pos = torch.full((), bound - 1, dtype=torch.int32, device=dev)
            extra = dmodel.decoder.rel_bias(pos[None], torch.arange(bound, device=dev))
            stage = anc[:, :, :bound].contiguous()
            ms = _device_ms(lambda: layer.self_attn.beam_decode_self_attention(
                x, cache, stage, pos, extra), iters=5, reps=3)
            self_ms += ms * (bound - 1 - start)
            start = bound - 1
        cross_ms = _device_ms(lambda: layer.cross_attn.beam_decode_cross_attention(
            x, kv, bias), iters=5, reps=3) * (MAX_LENGTH - 1)
    return self_ms * LAYERS, cross_ms * LAYERS


def _serve_preset(name: str) -> dict:
    """One shipped config at full width: one 128-spectrum request at K 10
    through the decode graphs (captured by an earlier request) and through
    the eager loop, bit-equal; #1-#3 launched on every layer of every step,
    or (T5) never; one request profiled for its device time and busy share.
    Returns the decode kernels' launches."""
    import torch

    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine
    from multimodalanalytical_tpu_torch.generation.beam_search import stage_bounds

    model = _preset_model(name)
    cfg = model.config
    # The JAX package's route choice: the decode kernels need the 1/sqrt(Dh)
    # scale and no extra self-attention bias (T5 has neither).
    kernels = cfg.attention_scale and not cfg.relative_position_bias
    print(f"preset {name}: {cfg.d_model} wide, {cfg.encoder_layers} + {cfg.decoder_layers} "
          f"layers, {cfg.encoder_attention_heads} heads, FFN {cfg.encoder_ffn_dim} "
          f"{cfg.activation_function}, {cfg.norm_type}, "
          f"{'pre' if cfg.post_layer_normalisation else 'post'}-LN, final norms "
          f"{cfg.final_layer_norm}, relative bias {cfg.relative_position_bias}, scale "
          f"{cfg.attention_scale}: decode kernels {'#1-#3' if kernels else 'none (plain route)'}",
          flush=True)
    _require((cfg.d_model, cfg.encoder_layers, cfg.decoder_layers, cfg.decoder_attention_heads,
              cfg.decoder_ffn_dim) == (D_MODEL, LAYERS, LAYERS, HEADS, FFN),
             f"{name} does not resolve to the published widths")
    engine = InferenceEngine(model, n_beams=BEAMS, batch_size=BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.decode_batch(*_request(seed=PRESET_REQUEST_SEEDS[0]))   # captures; not counted
    first_s = time.perf_counter() - t0
    capture = engine.last_stats
    print(f"preset {name}: graph capture (first request) {capture['capture_s']:.4f} s for "
          f"{capture['warmup_steps']} stages, first request {first_s:.4f} s in all", flush=True)
    request = _request(seed=PRESET_REQUEST_SEEDS[1])
    launches, per_batch, results = _serve_requests(engine, [request], f"preset {name}", model,
                                                   kernels=kernels)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        engine.decode_batch(*request)
        torch.cuda.synchronize()
    device_s, rows, _, graphs = _device_time(prof)
    _require(graphs >= results[0][2]["replays"], "the profiled request did not replay graphs")
    split = {k: round(v, 2) for k, v in _kernel_split(rows).items()}
    print(f"preset {name}: one request profiled: device time {device_s:.4f} s (kernels and "
          f"copies only), busy share {device_s / per_batch:.3f} (device / unprofiled s/batch), "
          f"{results[0][2]['steps']} steps; device ms by kernel {split}", flush=True)
    for ms, calls, kernel in rows[:6]:
        print(f"  {100 * ms / (device_s * 1e3):5.1f}% {ms:10.2f} ms x {calls:6d}  "
              f"{kernel[:100]}", flush=True)
    if not kernels:
        self_ms, cross_ms = _plain_attention_ms(engine.decoder.dmodel,
                                                stage_bounds(32, MAX_LENGTH))
        print(f"preset {name}: plain route per request (6 layers, timed per call by CUDA-graph "
              f"replay): self-attention {self_ms:.2f} ms ({self_ms / (10 * device_s):.1f}% of "
              f"device time), cross attention {cross_ms:.2f} ms "
              f"({cross_ms / (10 * device_s):.1f}%)", flush=True)
    del engine, model
    torch.cuda.empty_cache()
    return launches


def check_bucket_table() -> None:
    """T5's relative buckets computed on the card for offsets -4096..4096,
    both directions, integer for integer against the CPU's."""
    import torch

    from multimodalanalytical_tpu_torch.ops.positional import t5_relative_bucket

    rel = torch.arange(-BUCKET_SPAN, BUCKET_SPAN + 1, dtype=torch.int32)
    for bidirectional in (True, False):
        cpu = t5_relative_bucket(rel, bidirectional)
        card = t5_relative_bucket(rel.to(DEVICE), bidirectional).cpu()
        differ = (cpu != card).nonzero().flatten()
        print(f"T5 buckets, {'bidirectional' if bidirectional else 'causal'}, offsets "
              f"-{BUCKET_SPAN}..{BUCKET_SPAN}: card equal to CPU {len(differ) == 0} "
              f"({len(torch.unique(cpu))} buckets; differing offsets "
              f"{(rel[differ[:8]]).tolist()})", flush=True)
        _require(len(differ) == 0, "the card's T5 buckets differ from the CPU's")


def _golden_forward(model, ins):
    import torch

    dev = torch.device(DEVICE)
    enc = {"Formula": torch.as_tensor(ins["Formula"], device=dev).long(),
           "IR": torch.as_tensor(ins["IR"], device=dev).float()}
    args = [torch.as_tensor(ins[k], device=dev).long()
            for k in ("enc_mask", "dec_ids", "dec_mask", "labels")]
    with torch.no_grad():
        return model(enc, *args)


def _golden_model(model_type: str):
    import torch

    from multimodalanalytical_tpu_torch.models.config import resolve_model_config
    from multimodalanalytical_tpu_torch.models.seq2seq import Seq2SeqModel

    cfg = resolve_model_config(dict(GOLDEN_MODEL, model_type=model_type),
                               vocab_size=GOLDEN_VOCAB, pad_token_id=0, bos_token_id=2,
                               eos_token_id=3)
    return Seq2SeqModel(cfg, GOLDEN_DATA_CONFIG, "Smiles", device=torch.device(DEVICE))


def _golden_case(golden, name: str) -> tuple:
    parts = {}
    for part in ("param", "in", "out"):
        prefix = f"{name}/{part}/"
        parts[part] = {k[len(prefix):]: golden[k] for k in golden.files if k.startswith(prefix)}
    return parts["param"], parts["in"], parts["out"]


def check_hf_goldens() -> None:
    """The reference's executed HF BART and T5 graphs through
    ``load_reference_state_dict`` into fp32 port models on the card, held
    to their logits and loss; then the converter on the card's machine: a
    Lightning-shaped ``.ckpt`` of the T5 golden converted by
    ``python -m ...cli.convert_reference_checkpoint``, restored by
    ``load_finetune_params``, gives the directly loaded model's logits."""
    import tempfile

    import numpy as np
    import torch

    from multimodalanalytical_tpu_torch.models.weights import load_reference_state_dict
    from multimodalanalytical_tpu_torch.training.checkpoint import load_finetune_params

    golden = np.load(GOLDEN_PATH, allow_pickle=False)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        logits = {}
        for name, model_type in GOLDEN_CASES.items():
            sd, ins, outs = _golden_case(golden, name)
            model = _golden_model(model_type)
            load_reference_state_dict(model, sd)
            res = _golden_forward(model, ins)
            got = res["logits"].double().cpu().numpy()
            err = np.abs(got - outs["logits"])
            worst = float((err / (GOLDEN_ATOL + GOLDEN_RTOL * np.abs(outs["logits"]))).max())
            loss_err = abs(float(res["loss"]) - float(outs["loss"]))
            loss_ok = loss_err <= GOLDEN_LOSS_ATOL + GOLDEN_LOSS_RTOL * abs(float(outs["loss"]))
            print(f"golden {name} on the card ({len(sd)} reference tensors, fp32, TF32 off): "
                  f"logits max abs err {err.max():.3e} ({worst:.3f} of rtol {GOLDEN_RTOL} / atol "
                  f"{GOLDEN_ATOL}), loss {float(res['loss']):.7f} vs {float(outs['loss']):.7f} "
                  f"(err {loss_err:.2e})", flush=True)
            _require(worst <= 1.0 and loss_ok, f"{name}: the card misses the reference's graph")
            logits[name] = res["logits"]

        sd, ins, _ = _golden_case(golden, "t5_executed_graph")
        with tempfile.TemporaryDirectory() as tmp:
            ckpt, out = Path(tmp) / "reference.ckpt", Path(tmp) / "converted"
            torch.save({"state_dict": {f"hf_model.{k}": torch.from_numpy(np.array(v))
                                       for k, v in sd.items()}, "epoch": 3, "global_step": 42},
                       ckpt)
            t0 = time.perf_counter()
            result = subprocess.run(
                [sys.executable, "-m",
                 "multimodalanalytical_tpu_torch.cli.convert_reference_checkpoint", str(ckpt),
                 str(out)], cwd=REPO, capture_output=True, text=True, timeout=300)
            convert_s = time.perf_counter() - t0
            _require(result.returncode == 0, f"the converter failed: {result.stderr[-2000:]}")
            model = _golden_model("T5ForConditionalGeneration")
            params, _ = load_finetune_params(out, model, strip_align=False)
            model.load_state_dict(params)
        converted = _golden_forward(model, ins)["logits"]
        same = torch.equal(converted, logits["t5_executed_graph"])
        print(f"converter on the card's machine: {result.stdout.strip()} in {convert_s:.2f} s; "
              f"restored by load_finetune_params, logits bit-equal to the direct load {same}",
              flush=True)
        _require(same, "the converted checkpoint gives other logits")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def run_preset_training() -> None:
    """hf_bart_medium and t5_small at B 128 on one Formula + IR batch: one
    dropout-0 step of the bf16 model against its fp32 twin (loss and
    gradient norm), then ``Trainer.fit`` takes 3 AdamW steps: finite, and
    the last loss below the first."""
    import math

    import numpy as np
    import torch

    from multimodalanalytical_tpu_torch.training import Trainer

    inputs, mask = _request(seed=920, batch=BATCH)
    batch = {"encoder_inputs": inputs, "encoder_mask": mask,
             **_targets(np.random.default_rng(921), BATCH)}
    for name in PRESET_TRAINED:
        routes = {}
        for dtype in ("bfloat16", "float32"):
            routes[dtype] = _step_twice(_preset_model(name, dtype=dtype, dropout=0.0), batch)
            torch.cuda.empty_cache()
        (b_loss, b_norm, b_s, _), (f_loss, f_norm, f_s, _) = routes["bfloat16"], routes["float32"]
        loss_rel, norm_rel = abs(b_loss - f_loss) / abs(f_loss), abs(b_norm - f_norm) / abs(f_norm)
        norm_tol = T5_GRAD_NORM_RTOL if name == "t5_small" else MM_GRAD_NORM_RTOL
        print(f"preset {name} train step, dropout 0: bf16 loss {b_loss:.6f} grad_norm "
              f"{b_norm:.6f} ({b_s:.4f} s), fp32 loss {f_loss:.6f} grad_norm {f_norm:.6f} "
              f"({f_s:.4f} s): loss rel diff {loss_rel:.3e} (tol {MM_LOSS_RTOL}), grad_norm "
              f"rel diff {norm_rel:.3e} (tol {norm_tol})", flush=True)
        _require(loss_rel <= MM_LOSS_RTOL and norm_rel <= norm_tol,
                 f"{name}: the bf16 train step disagrees with the fp32 one")
        model = _preset_model(name)
        trainer = Trainer(model, optimiser="adamw", lr=TRAIN_LR,
                          num_steps=PRESET_TRAIN_STEPS + 1, clip_grad=1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = trainer.fit([batch], epochs=PRESET_TRAIN_STEPS, max_steps=PRESET_TRAIN_STEPS)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / PRESET_TRAIN_STEPS
        print(f"preset {name} train fit: {PRESET_TRAIN_STEPS} AdamW steps, B {BATCH}, dropout "
              f"{model.config.dropout}: {step_s:.4f} s/step (first step included); losses "
              f"{[round(x, 4) for x in losses]}", flush=True)
        _require(len(losses) == PRESET_TRAIN_STEPS and all(math.isfinite(x) for x in losses)
                 and losses[-1] < losses[0], f"{name}: the training loss is not finite and falling")
        del model, trainer
        torch.cuda.empty_cache()


def run_presets() -> dict:
    """Phase 9; returns the decode kernels' launches over the four
    configs' counted requests."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launches = {}
    for name in PRESET_MODEL_CONFIGS:
        for kernel, count in _serve_preset(name).items():
            launches[kernel] = launches.get(kernel, 0) + count
    check_bucket_table()
    check_hf_goldens()
    run_preset_training()
    print(f"phase 9: {time.perf_counter() - t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches


# --------------------------------------------------------------- phase 10
# The mixture paper's Table 1 recipe (paper_replication/mixture/scripts/
# replicate_table_1.sh): model=custom_model_align data=ir/patches_mixture_text_align
# mixture=ir/binary, then mixture=ir/multitask (Tables 2/3). The configs as
# dict literals equal to the files as the config loader composes them
# (tests/test_torch_presets.py holds them so).
ALIGN_MODEL_CONFIG = {
    "model_type": "CustomModel", "d_model": 512, "encoder_attention_heads": 8,
    "decoder_attention_heads": 8, "encoder_layers": 6, "decoder_layers": 6,
    "encoder_ffn_dim": 2048, "decoder_ffn_dim": 2048, "multimodal_norm": True,
    "final_layer_norm": True, "positional_encoding_type": "sin_cos", "gated_linear": False,
    "post_layer_normalisation": True, "optimiser": "adamw", "lr": 1.0e-4, "weight_decay": 0.0,
    "adam_beta1": 0.9, "adam_beta2": 0.999, "model_checkpoint_path": None, "batch_size": 128,
    "cv_split": 0, "guided_generation": False, "max_position_embeddings": 1024,
    "align_config": {"align_network": "convolutional", "hidden_dimension": 256,
                     "conv_channels": 512, "kernel_size": 5, "output_dimension": 1800,
                     "loss_lambda": 50, "loss_function": "mae"},
    "n_beams": 10, "rejection_sampling": False, "dtype": "bfloat16", "use_flash_attention": True,
}
_MIX_PATCHES = {"patch_size": 75, "interpolation": False, "masking": False}
MIX_DATA_CONFIG = {
    "Formula": {"type": "text", "column": "molecular_formula", "target": False,
                "preprocessor_arguments": {"tokenizer": "formula",
                                           "tokenizer_regex": FORMULA_REGEX}},
    "IR": {"type": "1D_patches", "column": "ir_spectra", "target": False,
           "preprocessor_arguments": dict(_MIX_PATCHES)},
    "IR_target": {"type": "1D_patches", "column": "", "target": True, "alignment": True,
                  "preprocessor_arguments": dict(_MIX_PATCHES)},
    "Smiles": {"type": "text", "column": "smiles", "target": True,
               "preprocessor_arguments": {
                   "tokenizer": "smiles",
                   "tokenizer_regex": (r"(\[[^\]]+]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p|\(|\)|"
                                       r"\.|=|#|-|\+|\\\\|\/|:|~|@|\?|>|\*|\$|\%[0-9]{2}|"
                                       r"[0-9])")}},
}


def _mix_mode(ratio, normalize: bool) -> dict:
    return {"n_compounds": 2, "compounds_ratio": ratio, "train_max_n_samples": 320000000,
            "validation_max_n_samples": 10000, "test_max_n_samples": 10000,
            "parallel_samples": 16384, "normalize": normalize}


MIXTURE_CONFIGS = {
    "ir/binary": {"balanced": _mix_mode(None, False)},
    "ir/multitask": {"balanced": _mix_mode(None, True),
                     "unbalanced_4_6": _mix_mode([0.4, 0.6], True),
                     "unbalanced_3_7": _mix_mode([0.3, 0.7], True),
                     "unbalanced_2_8": _mix_mode([0.2, 0.8], True),
                     "unbalanced_1_9": _mix_mode([0.1, 0.9], True)},
}
# The pure-compound pool: the size the JAX package's note measured
# (data/device_mixture.py there, a 38k x 1800 fp32 pool), of seeded
# synthetic spectra at the real data's 1791 points; the targets cycle
# through phase 5's corpus, each with its formula.
MIX_POOL_ROWS, MIX_SPECTRUM_LEN = 38_000, 1791
MIX_STEPS = 6                  # AdamW steps at B 128 per fit: the stream is cut to 6 batches
MIX_SAMPLE = 256               # mixtures the preprocessors and the collator's lengths fit on
MIX_CHECK_BATCHES = 4          # premixed batches held against the host collator
MIX_FLOAT_TOL = 1e-6           # patches and align targets: of the batch's largest magnitude
MIX_FIT_RTOL = 5e-4            # tests/test_device_mixture.py's bound, device route vs host
# Two ranks sharing the card over gloo against one process at the same
# global batch (fp32, dropout 0): losses and gradient norms to DP_RTOL; the
# parameters to DP_RTOL on all but DP_NOISE_SHARE of their entries. Those
# are the entries whose gradient is rounding noise of its sum (the attention
# key biases, whose gradient is 0 in exact arithmetic, and mae signs that
# cancel over the batch), which Adam turns into steps of the learning
# rate's size, so they are held to twice the sum of the fit's rates.
DP_RANKS, DP_RTOL, DP_NOISE_SHARE = 2, 1e-5, 1e-3
DP_TIMEOUT_S = 300


def _mixture_setup(mixture_name: str) -> tuple:
    """(stream, data config, preprocessors, collator) of the recipe on the
    seeded pool, built as ``cli/training.py`` builds them: the stream is
    ``multi_config_mix`` over the pool (cut to MIX_STEPS batches), the patch
    preprocessors are fitted and the collator's lengths fitted on
    MIX_SAMPLE of its mixtures; the two text modalities take the
    fixed-vocabulary stand-in (the card's machine has no ``tokenizers``)."""
    import copy

    import numpy as np

    from multimodalanalytical_tpu_torch.chem import mol_formula
    from multimodalanalytical_tpu_torch.configuration import DEFAULT_SETTINGS
    from multimodalanalytical_tpu_torch.data.collator import MultiModalCollator
    from multimodalanalytical_tpu_torch.data.datasets import (
        IterableDatasetWithLength,
        TableDataset,
        multi_config_mix,
    )
    from multimodalanalytical_tpu_torch.data.preprocessing import PatchPreprocessor

    rng = np.random.default_rng(1000)
    spectra = rng.random((MIX_POOL_ROWS, MIX_SPECTRUM_LEN), dtype=np.float32)
    smiles = [SMILES_CORPUS[i % len(SMILES_CORPUS)] for i in range(MIX_POOL_ROWS)]
    formula = {s: mol_formula(s) for s in SMILES_CORPUS}
    pool = TableDataset({"Smiles": smiles, "Formula": [formula[s] for s in smiles],
                         "IR": list(spectra)})
    stream = IterableDatasetWithLength(
        generator_fn=multi_config_mix, length=MIX_STEPS * BATCH, split="train",
        generator_args={"dataset": pool, "mixture_config": MIXTURE_CONFIGS[mixture_name],
                        "split": "train", "seed": DEFAULT_SETTINGS.default_seed})
    sample = stream.take(MIX_SAMPLE).columns
    data_config = copy.deepcopy(MIX_DATA_CONFIG)
    preps = {"Formula": FixedVocabTokenizer(FORMULA_REGEX, formula.values(), (), FORMULA_VOCAB),
             "Smiles": FixedVocabTokenizer()}
    for modality in ("Formula", "Smiles"):
        data_config[modality].update(vocab_size=preps[modality].vocab_size,
                                     pad_token_id=preps[modality].pad_token_id)
    for modality in ("IR", "IR_target"):
        preps[modality] = PatchPreprocessor(**data_config[modality]["preprocessor_arguments"])
        preps[modality].fit(sample[modality])
        data_config[modality]["n_features"] = preps[modality].n_features
    collator = MultiModalCollator(preps, data_config, pad_to_batch_size=BATCH)
    collator.fit_lengths(sample)
    return stream, data_config, preps, collator


def _device_mixture(setup):
    """``try_build_device_mixture`` on the recipe, as ``cli/training.py``
    calls it: the pool staged on the card, or None where the route is
    refused."""
    import torch

    from multimodalanalytical_tpu_torch.configuration import DEFAULT_SETTINGS
    from multimodalanalytical_tpu_torch.data.device_mixture import try_build_device_mixture

    stream, data_config, preps, collator = setup
    return try_build_device_mixture(stream, data_config, preps, collator, BATCH,
                                    seed=DEFAULT_SETTINGS.default_seed,
                                    device=torch.device(DEVICE))


def _host_loader(setup):
    """The host generator's train loader through ``cli/common.py:build_loaders``
    (row-sharded under a process group)."""
    from multimodalanalytical_tpu_torch.cli.common import build_loaders
    from multimodalanalytical_tpu_torch.configuration import DEFAULT_SETTINGS

    stream, _, _, collator = setup
    return build_loaders({"train": stream}, collator, BATCH,
                         DEFAULT_SETTINGS.default_seed)["train"]


def _mix_fit(setup, route: str, dtype: str, dropout=None, val=None,
             cuda_graph: bool = True) -> dict:
    """``Trainer.fit`` of custom_model_align (at ``dtype``, and ``dropout``
    where given) for MIX_STEPS AdamW steps on a route ("device" or "host"),
    as ``cli/training.py`` builds it (one accumulation step); with ``val``,
    one validation pass (K 1) at the end. Returns each step's metrics, the
    final parameters (on the host), the seconds per train step (from the
    end of the first step, which carries the warm-up, to the end of the
    last, between CUDA events: the host's loader time within it counts),
    the learning rates and the trainer. ``cuda_graph``: the train step's
    route (the replayed graph, or its eager body)."""
    import torch

    from multimodalanalytical_tpu_torch.cli.common import build_model
    from multimodalanalytical_tpu_torch.configuration import DEFAULT_SETTINGS
    from multimodalanalytical_tpu_torch.training import Trainer

    _, data_config, preps, _ = setup
    seed = DEFAULT_SETTINGS.default_seed
    loader, transform = _host_loader(setup), None
    if route == "device":
        mix = _device_mixture(setup)
        _require(mix is not None, "the recipe did not take the device route")
        loader, transform = mix.loader, mix.expand
    config = dict(ALIGN_MODEL_CONFIG, dtype=dtype)
    if dropout is not None:
        config["dropout"] = dropout
    model, _ = build_model(config, data_config, "Smiles", preps["Smiles"],
                           torch.device(DEVICE), seed)
    trainer = Trainer(model, preps["Smiles"], optimiser="adamw", lr=ALIGN_MODEL_CONFIG["lr"],
                      num_steps=MIX_STEPS, clip_grad=1.0, seed=seed, batch_transform=transform,
                      cuda_graph=cuda_graph)
    steps, ends = [], []
    train_step = trainer.train_step

    def timed_step(batch):
        steps.append(train_step(batch))
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return steps[-1]

    trainer.train_step = timed_step
    trainer.fit(loader, val, epochs=1)
    torch.cuda.synchronize()
    step_s = ends[0].elapsed_time(ends[-1]) / 1e3 / (len(ends) - 1)
    replay_s = ends[1].elapsed_time(ends[-1]) / 1e3 / (len(ends) - 2)
    opt = trainer.optimizer
    return {"steps": [{k: float(v) for k, v in m.items()} for m in steps],
            "params": [p.detach().cpu() for p in trainer.params], "step_s": step_s,
            "replay_s": replay_s, "moments": [t.detach().cpu() for t in opt.mu + opt.nu],
            "trainer": trainer, "lrs": [trainer.optimizer.schedule(t) for t in range(len(steps))]}


def _host_ms_per_batch(loader) -> float:
    """Host time per batch of a loader iterated alone (no prefetch thread)."""
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return 1e3 * (time.perf_counter() - t0) / n


def _check_premix(setup, mixture_name: str) -> dict:
    """The first MIX_CHECK_BATCHES premixed batches on the card against the
    host collator's batches of the same samples. Returns the loaders' host
    ms per batch and the pool bytes."""
    import numpy as np
    import torch

    from multimodalanalytical_tpu_torch.training.loader import DataLoader
    from multimodalanalytical_tpu_torch.training.trainer import device_batch

    stream, _, _, collator = setup
    mix = _device_mixture(setup)
    _require(mix is not None, "the recipe did not take the device route")
    host = DataLoader(stream, collator, BATCH, prefetch=0)
    worst = 0.0
    for i, (host_batch, index_batch) in enumerate(zip(host, mix.loader)):
        if i == MIX_CHECK_BATCHES:
            break
        got = mix.premix(mix.consts, device_batch(index_batch, torch.device(DEVICE)))
        _require(index_batch["n_valid"] == host_batch["n_valid"] == BATCH, "partial batch")
        for key in ("encoder_mask", "decoder_ids", "decoder_mask", "labels"):
            _require(np.array_equal(got[key].cpu().numpy(), host_batch[key]),
                     f"{mixture_name} premix batch {i}: {key} differs from the host's")
        _require(np.array_equal(got["encoder_inputs"]["Formula"].cpu().numpy(),
                                host_batch["encoder_inputs"]["Formula"]),
                 f"{mixture_name} premix batch {i}: Formula ids differ from the host's")
        for what, a, b in (("IR patches", got["encoder_inputs"]["IR"],
                            host_batch["encoder_inputs"]["IR"]),
                           ("align target", got["align_target"], host_batch["align_target"])):
            err = float(np.abs(a.cpu().numpy().astype(np.float64) - b).max()
                        / np.abs(b).max())
            worst = max(worst, err)
            _require(err <= MIX_FLOAT_TOL, f"{mixture_name} premix batch {i}: {what} off by "
                                           f"{err:.3e} of its largest magnitude")
    times = {"host": _host_ms_per_batch(DataLoader(stream, collator, BATCH, prefetch=0)),
             "device": _host_ms_per_batch(mix.loader)}
    print(f"mixture {mixture_name}: {MIX_CHECK_BATCHES} premixed B {BATCH} batches equal the "
          f"host collator's (ids, masks, labels bit for bit; patches and align target within "
          f"{worst:.3e} of their largest magnitude, tol {MIX_FLOAT_TOL}); pool "
          f"{MIX_POOL_ROWS} x {MIX_SPECTRUM_LEN} spectra, {mix.pool_bytes} B on the card; "
          f"index batch {mix.loader.batch_bytes} B; host ms per batch: host generator "
          f"{times['host']:.2f}, device route {times['device']:.2f}", flush=True)
    return {"pool_bytes": mix.pool_bytes, "host_ms": times}


def _require_same_fit(what: str, got: dict, want: dict, rtol: float) -> float:
    """Each step's losses and gradient norm within ``rtol``; the worst."""
    worst = 0.0
    for a, b in zip(got["steps"], want["steps"]):
        for key in ("loss", "model_only_loss", "alignment_loss", "grad_norm"):
            worst = max(worst, abs(a[key] - b[key]) / abs(b[key]))
    _require(len(got["steps"]) == len(want["steps"]) == MIX_STEPS and worst <= rtol,
             f"{what}: steps differ by {worst:.3e} (tol {rtol})")
    return worst


def run_mixture_path() -> tuple:
    """Phase 10 (a). Returns (the decode kernels' launches in the
    validation, the fp32 fits of ir/binary on each route)."""
    import math

    import torch

    counters = _decode_counters()
    torch.cuda.reset_peak_memory_stats()
    fp32 = {}
    for mixture_name in MIXTURE_CONFIGS:
        t0 = time.perf_counter()
        setup = _mixture_setup(mixture_name)
        setup_s = time.perf_counter() - t0
        checked = _check_premix(setup, mixture_name)
        fits = {route: _mix_fit(setup, route, "float32", 0.0) for route in ("device", "host")}
        worst = _require_same_fit(f"{mixture_name} fp32 device route vs host", fits["device"],
                                  fits["host"], MIX_FIT_RTOL)
        _require(all(math.isfinite(s["loss"]) for f in fits.values() for s in f["steps"]),
                 "non-finite mixture loss")
        print(f"mixture {mixture_name} fp32 fits ({MIX_STEPS} AdamW steps, B {BATCH}, dropout "
              f"0; setup {setup_s:.2f} s): losses device "
              f"{[round(s['loss'], 5) for s in fits['device']['steps']]}, host "
              f"{[round(s['loss'], 5) for s in fits['host']['steps']]}, worst rel diff "
              f"{worst:.3e} (tol {MIX_FIT_RTOL}); s/step (steps 2-{MIX_STEPS}) device "
              f"{fits['device']['step_s']:.5f}, host {fits['host']['step_s']:.5f}", flush=True)
        if mixture_name == "ir/binary":
            fp32 = {route: {k: v for k, v in fit.items() if k != "trainer"}
                    for route, fit in fits.items()}
            binary_setup = setup
        del fits

    # The recipe as it trains (bf16, dropout 0.1) on each route; the device
    # route validates once at the end (K 1) through the decode graphs.
    val = [next(iter(_host_loader(binary_setup)))]
    for fn in counters:
        fn.launches = 0
    device = _mix_fit(binary_setup, "device", "bfloat16", val=val)
    launches = {fn.__name__: fn.launches for fn in counters}
    trainer = device["trainer"]
    host = _mix_fit(binary_setup, "host", "bfloat16")
    # The same fits on the eager body: bit-equal to the graphs'.
    eager = {route: _mix_fit(binary_setup, route, "bfloat16", cuda_graph=False)
             for route in ("device", "host")}
    for route, fit in (("device", device), ("host", host)):
        other = eager[route]
        _require(fit["steps"] == other["steps"] and all(
            torch.equal(a, b) for a, b in zip(fit["params"] + fit["moments"],
                                              other["params"] + other["moments"])),
                 f"mixture {route} route: the graph's fit differs from the eager body's")
        _require(fit["trainer"].step_stats["captures"] >= 1
                 and not other["trainer"].step_stats["graph"],
                 f"mixture {route} route: a fit did not take its train-step route")
    replays, warmups = trainer.decode_replays, trainer.decode_warmups
    for name, count in launches.items():
        _require(count == LAYERS * (replays + warmups),
                 f"{name} launched {count} times in validation, want {LAYERS * (replays + warmups)}")
    _require(all(math.isfinite(s["loss"]) for s in device["steps"] + host["steps"]),
             "non-finite bf16 mixture loss")
    print(f"mixture ir/binary bf16 fits (the recipe, dropout 0.1): s/step (steps "
          f"2-{MIX_STEPS}) device route {device['step_s']:.5f}, host generator "
          f"{host['step_s']:.5f}; losses device "
          f"{[round(s['loss'], 4) for s in device['steps']]}, host "
          f"{[round(s['loss'], 4) for s in host['steps']]}; train step routes: graph "
          f"(steps 3-{MIX_STEPS}: device {device['replay_s']:.5f}, host "
          f"{host['replay_s']:.5f}) against the eager body's s/step (steps 2-{MIX_STEPS}) "
          f"device {eager['device']['step_s']:.5f}, host {eager['host']['step_s']:.5f} "
          f"(steps 3-{MIX_STEPS}: {eager['device']['replay_s']:.5f}, "
          f"{eager['host']['replay_s']:.5f}), bit-equal; capture "
          f"{trainer.step_stats['capture_s']:.3f} s; validation (K 1) "
          f"{trainer.decode_steps} decode steps in {replays} graph replays and {warmups} "
          f"eager capture steps, launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del device, host, trainer, eager
    torch.cuda.empty_cache()
    return launches, fp32


def _dp_command(spec: dict) -> list:
    return [sys.executable, str(REPO / "chip_smoke.py"), "--dp-rank", json.dumps(spec)]


def run_dp_rank(spec: dict) -> None:
    """One rank of phase 10 (b): joins a gloo group on card 0 (a file
    store), checks that the device route is refused at this world size,
    fits ir/binary on the host route in fp32 (its rows of each global
    batch), and writes its steps, its seconds per step and per gradient
    all-reduce, and (rank 0) the final parameters into ``spec["out"]``."""
    import torch
    import torch.distributed as dist

    from multimodalanalytical_tpu_torch.training.trainer import Trainer

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}", rank=spec["rank"],
                            world_size=spec["world"])
    try:
        setup = _mixture_setup("ir/binary")
        _require(_device_mixture(setup) is None,
                 "the device route was taken under several processes")
        reduce_s, reduce = [], Trainer._sum_over_ranks

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = reduce(*args)
            torch.cuda.synchronize()
            reduce_s.append(time.perf_counter() - t0)
            return out

        Trainer._sum_over_ranks = staticmethod(timed)
        fit = _mix_fit(setup, "host", "float32", 0.0)
        out = Path(spec["out"])
        stats = fit["trainer"].step_stats
        (out / f"rank{spec['rank']}.json").write_text(json.dumps(
            {"steps": fit["steps"], "step_s": fit["step_s"], "graph": stats["graph"],
             "eager_reason": stats["eager_reason"],
             "reduce_ms": 1e3 * sum(reduce_s[1:]) / len(reduce_s[1:])}))
        if spec["rank"] == 0:
            torch.save(fit["params"], out / "params.pt")
    finally:
        dist.destroy_process_group()


def _join_world_one_nccl() -> None:
    """Join a world-1 NCCL group as the CLIs join one: through
    ``initialize_multihost`` with torchrun's environment (a free local
    port); the process's environment is restored after."""
    import os
    import socket

    import torch
    import torch.distributed as dist

    from multimodalanalytical_tpu_torch.parallel import initialize_multihost

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(AFM_MULTIHOST="1", RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        joined = initialize_multihost(torch.device(DEVICE))
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key)
            else:
                os.environ[key] = value
    _require(joined == torch.device("cuda", 0) and dist.get_backend() == "nccl",
             f"initialize_multihost joined {dist.get_backend()} on {joined}, want nccl on cuda:0")


def run_distributed_path(fp32: dict) -> None:
    """Phase 10 (b): the process-group path on the one card. A world-1 NCCL
    group, joined through ``initialize_multihost`` as the CLIs join it,
    drives the fp32 device-route fit of (a) again: losses and
    parameters bit-equal to (a)'s fit with no group. Then DP_RANKS ranks
    share the card over gloo (two NCCL ranks on one device are refused as a
    duplicate GPU) and fit on the host route at the same global batch:
    against (a)'s one-process host fit, as DP_RTOL says."""
    import tempfile

    import torch
    import torch.distributed as dist

    _join_world_one_nccl()
    try:
        # NCCL sets up its communicator at the first collective: once here,
        # so that the fit's s/step is its steady cost.
        dist.all_reduce(torch.zeros(1, device=DEVICE))
        grouped = _mix_fit(_mixture_setup("ir/binary"), "device", "float32", 0.0)
    finally:
        dist.destroy_process_group()
    alone = fp32["device"]
    same_params = all(torch.equal(a, b) for a, b in zip(grouped["params"], alone["params"]))
    print(f"distributed: a world-1 NCCL group's fit (device route, fp32) against no group: "
          f"losses bit-equal {grouped['steps'] == alone['steps']}, {len(alone['params'])} "
          f"parameter tensors bit-equal {same_params}; s/step (steps 2-{MIX_STEPS}) "
          f"{grouped['step_s']:.5f} against {alone['step_s']:.5f}; train step route "
          f"{grouped['trainer'].step_stats}", flush=True)
    _require(grouped["steps"] == alone["steps"] and same_params,
             "the world-1 NCCL fit differs from the fit with no group")
    _require(grouped["trainer"].step_stats["captures"] >= 1,
             "the world-1 NCCL fit did not replay its train step's graph")
    del grouped

    with tempfile.TemporaryDirectory() as tmp:
        specs = [{"rank": r, "world": DP_RANKS, "store": f"{tmp}/store", "out": tmp}
                 for r in range(DP_RANKS)]
        logs = [Path(tmp) / f"rank{r}.log" for r in range(DP_RANKS)]
        t0 = time.perf_counter()
        procs = []
        for spec, log in zip(specs, logs):
            with open(log, "w") as out:   # a file: an unread pipe could block a rank
                procs.append(subprocess.Popen(_dp_command(spec), stdout=out,
                                              stderr=subprocess.STDOUT))
        try:
            for proc in procs:
                proc.wait(timeout=DP_TIMEOUT_S)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t0
        for r, (proc, log) in enumerate(zip(procs, logs)):
            _require(proc.returncode == 0,
                     f"rank {r} of {DP_RANKS} failed:\n{log.read_text()[-3000:]}")
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(DP_RANKS)]
        params = torch.load(Path(tmp) / "params.pt")
    ref = fp32["host"]
    worst = max(_require_same_fit(f"{DP_RANKS} ranks over gloo vs one process", rank, ref,
                                  DP_RTOL) for rank in ranks)
    _require(all(rank["steps"] == ranks[0]["steps"] for rank in ranks),
             "the ranks report different steps")
    print(f"distributed: the gloo ranks' train step ran eagerly: "
          f"{[(r['graph'], r['eager_reason']) for r in ranks]}", flush=True)
    _require(not any(rank["graph"] for rank in ranks), "a gloo rank captured its train step")
    got = torch.cat([p.reshape(-1) for p in params]).double()
    want = torch.cat([p.reshape(-1) for p in ref["params"]]).double()
    diff = (got - want).abs()
    outside = diff > DP_RTOL * want.abs() + 1e-7
    drift = 2 * sum(ref["lrs"])
    print(f"distributed: {DP_RANKS} ranks over gloo on one card (host route, fp32, B {BATCH} "
          f"global) against one process: worst step rel diff {worst:.3e} (tol {DP_RTOL}); "
          f"parameters outside rtol {DP_RTOL}: {int(outside.sum())} of {got.numel()} "
          f"(share {float(outside.double().mean()):.2e}, tol {DP_NOISE_SHARE}), max |diff| "
          f"{float(diff.max()):.3e} (tol {drift:.3e}); s/step (steps 2-{MIX_STEPS}) "
          f"{ranks[0]['step_s']:.5f} per rank against {ref['step_s']:.5f} in one process, "
          f"gradient all-reduce {ranks[0]['reduce_ms']:.2f} ms per step (steps 2-{MIX_STEPS}); "
          f"{wall:.1f} s with the ranks' start-up",
          flush=True)
    _require(float(outside.double().mean()) <= DP_NOISE_SHARE and float(diff.max()) <= drift,
             "the ranks' parameters differ from the one-process fit")


def run_mixture_phase() -> dict:
    """Phase 10; returns the decode kernels' launches."""
    import torch

    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    # The align head's convolutions take deterministic cuDNN algorithms, so
    # that fits repeated with the same inputs are bit-equal.
    torch.backends.cudnn.deterministic = True
    try:
        launches, fp32 = run_mixture_path()
        run_distributed_path(fp32)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"phase 10: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ------------------------------------------------------------- profiling
PROFILE_TOP = 14


def _device_time(prof) -> tuple:
    """(seconds, rows, kernel launches, graph launches) of one profiled run.
    Only the device's own events count (kernels, copies, sets): the
    profiler's operator rows (``aten::...``) carry their kernels' time a
    second time. rows: (ms, calls, name) by name, largest first. Launches
    are the host's calls: ``cudaLaunchKernel`` and ``cudaGraphLaunch``."""
    from torch.autograd import DeviceType

    by_name, launches, graphs = {}, 0, 0
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            ms, calls = by_name.get(event.name, (0.0, 0))
            by_name[event.name] = (ms + event.time_range.elapsed_us() / 1e3, calls + 1)
        elif event.name.startswith("cudaLaunchKernel"):
            launches += 1
        elif event.name.startswith("cudaGraphLaunch"):
            graphs += 1
    rows = sorted(((ms, calls, name) for name, (ms, calls) in by_name.items()), reverse=True)
    return sum(ms for ms, _, _ in rows) / 1e3, rows, launches, graphs


# --profile-eval of the last tree with the host-side decode loop (48c0f37;
# H100 80GB HBM3, 700 W): wall s, device s, busy share, kernel launches per
# decode step.
EAGER_LOOP_PROFILE = {f"predict K {EVAL_BEAMS}": (1.4533, 0.3732, 0.257, 199.5),
               f"serve K {BEAMS}": (1.3963, 0.1707, 0.122, 195.7),
               "validate K 1": (1.5311, 0.1100, 0.072, 201.4)}


def profile_eval() -> None:
    """The decode paths under ``torch.profiler``: one beam-30 predict batch
    of 128 spectra, one greedy (K 1) validation pass over 128, and one
    128-spectrum serving request at beam 10 (phase 2's), on a fresh
    flagship model (random weights, so every row decodes all steps), each
    through its CUDA graphs. Each runs once to capture and warm up, once
    unprofiled for its wall time and once profiled; prints device time by
    kernel, the busy share (device time / unprofiled wall time), the host's
    ms per decode step launching it and the launches per step as the host
    makes them (graph launches plus eager kernel launches), beside the
    host-side loop's (EAGER_LOOP_PROFILE)."""
    import torch

    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine
    from multimodalanalytical_tpu_torch.training import Trainer

    tokenizer = FixedVocabTokenizer()
    val = _eval_loader(tokenizer, EVAL_TRAIN, EVAL_VAL)
    test = _eval_loader(tokenizer, EVAL_TRAIN + EVAL_VAL, BATCH)
    trainer = Trainer(_flagship(), tokenizer, n_beams=EVAL_BEAMS)
    engine = InferenceEngine(trainer.model, n_beams=BEAMS, batch_size=BATCH)
    request = _request(seed=1)

    def counted(fn):
        """``fn`` returning the stats of its (last) decode."""
        def run():
            fn()
            return trainer.last_decode_stats
        return run

    runs = {f"predict K {EVAL_BEAMS}": counted(lambda: trainer.predict(test, n_beams=EVAL_BEAMS)),
            "validate K 1": counted(lambda: trainer.validate(val)),
            f"serve K {BEAMS}": lambda: (engine.decode_batch(*request), engine.last_stats)[1]}
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with torch.profiler.profile(activities=activities) as prof:
            run()
            torch.cuda.synchronize()
        device_s, rows, launches, graphs = _device_time(prof)
        steps, replays = stats["steps"], stats["replays"]
        host_ms = 1e3 * stats["dispatch_s"] / replays
        old_wall, old_device, old_busy, old_launches = EAGER_LOOP_PROFILE[name]
        print(f"profile {name}: {steps} decode steps in {replays} graph replays; wall "
              f"{wall:.4f} s unprofiled (host-side loop: {old_wall}); device time "
              f"{device_s:.4f} s (kernels and copies only; host-side loop: {old_device}); busy "
              f"share {device_s / wall:.3f} (host-side loop: {old_busy}); host {host_ms:.4f} ms "
              f"per decode step launching it; launches as the host makes them: {graphs} graph "
              f"launches + {launches} kernel launches = {(graphs + launches) / replays:.2f} per "
              f"step (host-side loop: {old_launches} kernel launches per step)", flush=True)
        _require(stats["graph"] and graphs >= replays,
                 f"profile {name}: the decode did not replay its graphs")
        ffn = [(ms, calls) for ms, calls, kernel in rows if "ffn_" in kernel]
        ffn_ms = sum(ms for ms, _ in ffn)
        print(f"profile {name}: decode FFN (#3) kernels {ffn_ms:.2f} ms "
              f"({100 * ffn_ms / (device_s * 1e3):.1f}% of device time) in "
              f"{sum(calls for _, calls in ffn)} launches", flush=True)
        for ms, calls, kernel in rows[:PROFILE_TOP]:
            print(f"  {100 * ms / (device_s * 1e3):5.1f}% {ms:10.2f} ms x {calls:6d}  "
                  f"{kernel[:100]}", flush=True)


def _ir_recipe_batch() -> dict:
    """Phase 4's batch: the flagship IR recipe's inputs at B 128."""
    import numpy as np

    inputs, mask = _request(seed=11, batch=IR_RECIPE_BATCH)
    return {"encoder_inputs": inputs, "encoder_mask": mask,
            **_targets(np.random.default_rng(12), IR_RECIPE_BATCH)}


def _profile_steps(trainer, batch, steps: int) -> dict:
    """``steps`` train steps under ``torch.profiler`` (CPU and CUDA): per
    step, the device seconds (device events only, as ``--profile-eval``),
    the kernels the device ran, and the host's kernel and graph launches;
    with the rows by kernel."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
    device_s, rows, launches, graphs = _device_time(prof)
    host_ms = {}
    for row in prof.key_averages():
        if "dropout" in row.key.lower() and row.cpu_time_total > 0:
            host_ms[row.key] = round(row.cpu_time_total / 1e3 / steps, 3)
    return {"device_s": device_s / steps, "kernels": sum(calls for _, calls, _ in rows) / steps,
            "launches": launches / steps, "graph_launches": graphs / steps, "rows": rows,
            "steps": steps, "dropout_host_ms": host_ms}


def profile_train(routes=("eager", "graph")) -> None:
    """The train steps under ``torch.profiler``, on each of ``routes`` (the
    eager body, ``cuda_graph=False``, and the replayed graph): phase 3's
    (the flagship-width RLE model, B 8, L 4090, dropout 0.1, flash route)
    with ``ops/dropout.py`` and with every dropout site through fused
    dropout, and phase 4's (the flagship IR recipe, B 128, dropout 0.1).
    Each takes two warm-up steps (the graph route's first step runs
    eagerly, the second captures), four unprofiled steps for the wall time
    and two profiled ones; prints device time per step by kernel (device
    events only, as ``--profile-eval``), the kernels per step, the host's
    launches per step, host time per step in the dropout calls, the busy
    share and the peak memory. Copied into a ``git archive`` of an earlier
    commit, whose ``Trainer`` has no graph route, it profiles that
    commit's (eager) step with ``--profile-train eager``."""
    import inspect

    import torch

    from multimodalanalytical_tpu_torch.training import Trainer

    has_routes = "cuda_graph" in inspect.signature(Trainer).parameters
    _require(has_routes or routes == ("eager",),
             "this commit's Trainer has no graph route: profile it with --profile-train eager")
    cases = [("RLE ops/dropout.py", lambda: _rle_model(dropout=DROPOUT, use_flash=True),
              _rle_batch(), False),
             ("RLE fused_dropout", lambda: _rle_model(dropout=DROPOUT, use_flash=True),
              _rle_batch(), True),
             ("IR recipe", _flagship, _ir_recipe_batch(), False)]
    for name, make_model, batch, fused in cases:
        for route in routes:
            route_kwargs = {"cuda_graph": route == "graph"} if has_routes else {}
            trainer = Trainer(make_model(), optimiser="adamw", lr=TRAIN_LR, num_steps=100,
                              clip_grad=1.0, **route_kwargs)
            steps = 2
            with _fused_dropout_sites([0]) if fused else contextlib.nullcontext():
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
                prof = _profile_steps(trainer, batch, steps)
            device_s = prof["device_s"]
            pool = trainer.graph_pool_bytes() if has_routes else 0
            stats = trainer.step_stats if has_routes else {}
            print(f"profile train step ({name}, route {route}): wall {wall:.4f} s/step "
                  f"unprofiled; device time {device_s:.4f} s/step (kernels and copies only); "
                  f"busy share {device_s / wall:.3f}; {prof['kernels']:.0f} device kernels and "
                  f"copies per step; host launches per step: {prof['launches']:.0f} kernel, "
                  f"{prof['graph_launches']:.0f} graph; peak {peak:.2f} GiB; graph pool "
                  f"{pool / 2**30:.2f} GiB; host ms per step in dropout "
                  f"calls {prof['dropout_host_ms']}; {stats}", flush=True)
            for ms, calls, kernel in prof["rows"][:PROFILE_TOP]:
                print(f"  {100 * ms / (device_s * steps * 1e3):5.1f}% {ms / steps:10.2f} ms x "
                      f"{calls // steps:6d} per step  {kernel[:100]}", flush=True)
            del trainer, prof
            torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 11
TP_RANKS = 2                  # layout (1, 2): one model group of two ranks sharing the card
TP_TIMEOUT_S = 420
TP_LOSS_TOL = 1e-5            # tests/test_multichip.py's bound on the loss across meshes
TP_PARAM_RTOL, TP_PARAM_ATOL = 2e-4, 2e-5   # and on the parameters after the step
TP_REQUEST_SEEDS = (1, 2, 3)  # phase 2's requests
TP_LOGIT_STEPS = 8
TP_TIMED_STEPS = 3            # s/step is the mean of steps 2-4 (the first carries warm-up)
# The bf16 decode against one process. The two differ only where a
# row-parallel product's fp32 partial sums, added in another order, round
# to another bf16 value, and where that flips an int8 rounding of the cache
# (the int8 cache alone moves phase 2's kernel-vs-plain logits by ~5e-2).
# Teacher-forced logits are held to LOGIT_TOL (phase 2's bound between the
# kernel and the plain route). A beam search on random weights turns any
# such difference into other beams at its top-K cuts (phase 2's plain route
# agrees with the kernel route on ~6% of top beams), so the beams are held
# by their scores: every row's top beam of the tensor-parallel decode,
# rescored by the one-process model along its own tokens (the same decode
# step and int8 cache, identity ancestry), within TP_SCORE_TOL of the score
# the ranks reported (length-normalised log-probabilities; the bound stated
# before the phase's first run for the beams the two decodes share); the
# rescoring itself is held to the one-process decode's own scores within
# TP_RESCORE_TOL (summation order only). The search's quality: the best
# score of every row, the tensor-parallel decode's minus the one process's,
# averaged over all rows, within TP_BEST_MEAN_TOL of 0 (the rows scatter
# both ways; a search that scores its tokens right but finds worse beams
# throughout fails here). The top-beam agreement is printed.
TP_SCORE_TOL = 1e-2
TP_RESCORE_TOL = 1e-4
TP_BEST_MEAN_TOL = 1e-2


def _tp_batch() -> dict:
    """Phase 4's IR-recipe batch (B 128)."""
    import numpy as np

    inputs, mask = _request(seed=11, batch=IR_RECIPE_BATCH)
    return {"encoder_inputs": inputs, "encoder_mask": mask,
            **_targets(np.random.default_rng(12), IR_RECIPE_BATCH)}


def _tp_trainer(model):
    from multimodalanalytical_tpu_torch.training import Trainer

    return Trainer(model, optimiser="adamw", lr=TRAIN_LR, num_steps=IR_RECIPE_STEPS,
                   clip_grad=1.0)


def _tp_teacher_forced(model):
    """Decode logits of TP_LOGIT_STEPS teacher-forced steps at B 128, K 10,
    int8 cache, permuted ancestry, on phase 2's first request: (steps, B,
    K, V) fp32 on the CPU."""
    import torch

    from multimodalanalytical_tpu_torch.generation.beam_search import decode_model

    dev = torch.device(DEVICE)
    inputs, mask = _request(seed=TP_REQUEST_SEEDS[0], batch=BATCH)
    inputs = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
    mask = torch.as_tensor(mask, device=dev)
    g = torch.Generator().manual_seed(7)
    steps = TP_LOGIT_STEPS
    tokens = torch.randint(4, VOCAB, (BATCH, BEAMS, steps), generator=g).to(dev)
    anc = torch.randint(0, BEAMS, (BATCH, BEAMS, steps), generator=g, dtype=torch.int32).to(dev)
    out = []
    with torch.no_grad():
        hidden = model.encode(inputs, mask)
        dm = decode_model(model)
        cache = dm.init_beam_cache(BATCH, BEAMS, steps, hidden, mask, True)
        for t in range(steps):
            a = anc.clone()
            a[:, :, t] = torch.arange(BEAMS, device=dev, dtype=torch.int32)
            out.append(dm.beam_decode_step(tokens[:, :, t], t, cache, a).float().cpu())
    return torch.stack(out)


def _rescore(model, inputs, mask, seqs):
    """The score ``model``'s decode step gives each beam of ``seqs`` (B, K,
    L) along its own tokens, as the beam search scores a finished
    hypothesis: its log-probabilities summed up to and with its first EOS
    (forced at step L - 2, as the search forces it), over that length
    (length penalty 1). The step runs as the search runs it (one stage,
    the search's cache, each beam's rows in its own slot). (B, K) numpy."""
    import torch

    from multimodalanalytical_tpu_torch.generation.beam_search import (
        decode_model,
        kv_cache_quantized,
    )

    cfg = model.config
    dev = torch.device(DEVICE)
    seqs = torch.as_tensor(seqs, device=dev)
    b, k, length = seqs.shape
    inputs = {key: torch.as_tensor(v, device=dev) for key, v in inputs.items()}
    mask = torch.as_tensor(mask, device=dev)
    with torch.no_grad():
        hidden = model.encode(inputs, mask)
        dm = decode_model(model)
        cache = dm.init_beam_cache(b, k, length, hidden, mask,
                                   kv_cache_quantized(cfg, k, length))
        anc = torch.arange(k, device=dev, dtype=torch.int32)[None, :, None].expand(
            b, k, length).contiguous()
        forced = torch.full((cfg.vocab_size,), -1.0e7, device=dev)
        forced[cfg.eos_token_id] = 0.0
        total = torch.zeros(b, k, dtype=torch.float64, device=dev)
        count = torch.zeros(b, k, dtype=torch.float64, device=dev)
        done = torch.zeros(b, k, dtype=torch.bool, device=dev)
        for t in range(length - 1):
            logp = torch.log_softmax(dm.beam_decode_step(seqs[:, :, t], t, cache, anc).float(),
                                     dim=-1)
            if t == length - 2:
                logp = forced.expand_as(logp)
            token = seqs[:, :, t + 1]
            picked = logp.gather(-1, token[..., None])[..., 0].double()
            total += torch.where(done, 0.0, picked)
            count += (~done).double()
            done |= token == cfg.eos_token_id
    return (total / count).cpu().numpy()


@contextlib.contextmanager
def _timed_model_reduces():
    """Every sum over the model group, synchronised and timed on the host:
    yields the list of seconds, one per all-reduce."""
    import torch

    from multimodalanalytical_tpu_torch.parallel.mesh import Mesh

    original, seconds = Mesh.all_reduce_model_, []

    def timed(self, tensor):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(self, tensor)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    Mesh.all_reduce_model_ = timed
    try:
        yield seconds
    finally:
        Mesh.all_reduce_model_ = original


def run_tp_rank(spec: dict) -> None:
    """One rank of phase 11: joins a gloo group on card 0 (a file store),
    builds the (1, 2) mesh, and (a) takes one fp32 AdamW step of the IR
    recipe from the parent's initial weights, then TP_TIMED_STEPS timed
    ones (s/step), then one more with its model all-reduces timed; (b) decodes TP_LOGIT_STEPS teacher-forced steps and
    phase 2's requests in bf16 with the int8 cache (eager steps: gloo
    collectives are not captured) and counts #1, #2 and #3 (#3's partial
    calls apart). Writes its report, and (rank 0) the gathered parameters,
    the logits and the beams, into ``spec["out"]``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine
    from multimodalanalytical_tpu_torch.models import transformer
    from multimodalanalytical_tpu_torch.models.weights import gather_state_dict, shard_state_dict
    from multimodalanalytical_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    rank, out = spec["rank"], Path(spec["out"])
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}", rank=rank,
                            world_size=spec["world"])
    try:
        mesh = make_mesh(1, spec["world"])
        report = {"rank": rank, "backend": dist.get_backend()}
        # (a) the fp32 step
        model = _flagship(dtype="float32", mesh=mesh)
        model.load_state_dict(shard_state_dict(
            torch.load(out / "fp32_init.pt", map_location=DEVICE), model))
        report["local_heads"] = model.encoder.layer_0.self_attn.num_heads
        report["local_ffn"] = model.encoder.layer_0.ff.linear1.weight.shape[0]
        trainer = _tp_trainer(model)
        batch = _tp_batch()
        torch.cuda.reset_peak_memory_stats()
        report["loss"] = float(trainer.train_step(batch)["loss"])
        params = gather_state_dict(model)
        if rank == 0:
            torch.save({k: v.cpu() for k, v in params.items()}, out / "tp_params.pt")
        del params
        report["step_s"] = _mean_step_s(trainer, batch)
        with _timed_model_reduces() as seconds:
            trainer.train_step(batch)
        report["step_reduce_ms"], report["step_reduces"] = 1e3 * sum(seconds), len(seconds)
        report["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        report["train_graph"] = trainer.step_stats["graph"]
        report["train_eager_reason"] = trainer.step_stats["eager_reason"]
        del trainer, model
        torch.cuda.empty_cache()

        # (b) the bf16 decode
        model = _flagship(mesh=mesh)
        model.load_state_dict(shard_state_dict(
            torch.load(out / "bf16_init.pt", map_location=DEVICE), model))
        logits = _tp_teacher_forced(model)
        if rank == 0:
            torch.save(logits, out / "tp_logits.pt")
        engine = InferenceEngine(model, n_beams=BEAMS, batch_size=BATCH)
        real_ffn, partial_calls = transformer.geglu_ffn, [0]

        def counting_ffn(*args, partial=False):
            partial_calls[0] += int(partial)
            return real_ffn(*args, partial=partial)

        transformer.geglu_ffn = counting_ffn
        counters = _decode_counters()
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        seqs, scores, seconds, steps, replays, graph = [], [], [], 0, 0, set()
        try:
            for i, seed in enumerate(TP_REQUEST_SEEDS):
                timed = (_timed_model_reduces() if i == len(TP_REQUEST_SEEDS) - 1
                         else contextlib.nullcontext([]))
                with timed as reduce_s:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = engine.decode_batch(*_request(seed, batch=BATCH))
                    seconds.append(time.perf_counter() - t0)
                stats = engine.last_stats
                seqs.append(got[0])
                scores.append(got[1])
                steps += stats["steps"]
                replays += stats["replays"]
                graph.add(stats["graph"])
        finally:
            transformer.geglu_ffn = real_ffn
        report.update(
            launches={fn.__name__: fn.launches for fn in counters},
            partial_ffn_calls=partial_calls[0], steps=steps, replays=replays,
            graph=sorted(graph), request_s=seconds,
            decode_reduce_ms_per_step=1e3 * sum(reduce_s) / max(stats["replays"], 1),
            decode_reduces_per_step=len(reduce_s) / max(stats["replays"], 1),
            decode_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        np.savez(out / f"tp_beams_rank{rank}.npz", seqs=np.stack(seqs), scores=np.stack(scores))
        (out / f"tp_rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def _mean_step_s(trainer, batch) -> float:
    """Seconds per step of TP_TIMED_STEPS steps after the first, with no
    synchronisation between them."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TP_TIMED_STEPS):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / TP_TIMED_STEPS


def _tp_command(spec: dict) -> list:
    return [sys.executable, str(REPO / "chip_smoke.py"), "--tp-rank", json.dumps(spec)]


def run_tensor_parallel() -> dict:
    """Phase 11: the flagship CustomModel at full width (d_model 512, 6 + 6
    layers, 8 heads, FFN 2048, vocab 320) on the (1, 2) layout, two ranks of
    this script (``--tp-rank``) sharing the card over gloo (two NCCL ranks
    on one device are refused), against one process on the same weights:
    (a) one fp32 AdamW step of the IR recipe at B 128 (dropout 0.1: the
    ranks draw the one process's masks), loss within TP_LOSS_TOL and the
    gathered parameters within TP_PARAM_RTOL / TP_PARAM_ATOL, s/step of
    steps 2-4 on each side; (b) bf16 with
    the int8 cache at K 10: teacher-forced logits within LOGIT_TOL, then
    phase 2's three requests (B 128, max length 128) decoded on both ranks
    with eager steps (``graph`` False: gloo collectives are not captured),
    beams the same on both ranks, every row's top beam rescored by the
    one-process model within TP_SCORE_TOL of its score (the rescoring held
    to the one-process decode's own scores within TP_RESCORE_TOL), the mean
    best-score difference over all rows within TP_BEST_MEAN_TOL; #1, #2
    and #3 (every call in partial mode) launched 6 x the steps on each
    rank. Returns the
    decode kernels' launches, both ranks together."""
    import tempfile

    import numpy as np
    import torch

    from multimodalanalytical_tpu_torch.cli.serve import InferenceEngine

    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fp32 = _flagship(dtype="float32")
        torch.save(fp32.state_dict(), tmp / "fp32_init.pt")
        trainer = _tp_trainer(fp32)
        batch = _tp_batch()
        loss_one = float(trainer.train_step(batch)["loss"])
        params_one = {k: v.detach().cpu() for k, v in fp32.state_dict().items()}
        step_one_s = _mean_step_s(trainer, batch)
        del trainer, fp32
        bf16 = _flagship()
        torch.save(bf16.state_dict(), tmp / "bf16_init.pt")
        logits_one = _tp_teacher_forced(bf16)
        engine = InferenceEngine(bf16, n_beams=BEAMS, batch_size=BATCH)
        one, one_s = [], []
        for seed in TP_REQUEST_SEEDS:
            t0 = time.perf_counter()
            one.append(engine.decode_batch(*_request(seed, batch=BATCH)))
            one_s.append(time.perf_counter() - t0)
        del engine
        torch.cuda.empty_cache()

        specs = [{"rank": r, "world": TP_RANKS, "store": str(tmp / "store"), "out": str(tmp)}
                 for r in range(TP_RANKS)]
        logs = [tmp / f"tp_rank{r}.log" for r in range(TP_RANKS)]
        t0 = time.perf_counter()
        procs = []
        for spec, log in zip(specs, logs):
            with open(log, "w") as out:   # a file: an unread pipe could block a rank
                procs.append(subprocess.Popen(_tp_command(spec), stdout=out,
                                              stderr=subprocess.STDOUT))
        try:
            for proc in procs:
                proc.wait(timeout=TP_TIMEOUT_S)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t0
        for r, (proc, log) in enumerate(zip(procs, logs)):
            _require(proc.returncode == 0,
                     f"tensor-parallel rank {r} failed:\n{log.read_text()[-3000:]}")
        ranks = [json.loads((tmp / f"tp_rank{r}.json").read_text()) for r in range(TP_RANKS)]
        params = torch.load(tmp / "tp_params.pt")
        logits = torch.load(tmp / "tp_logits.pt")
        beams = [np.load(tmp / f"tp_beams_rank{r}.npz") for r in range(TP_RANKS)]
        beams = [(b["seqs"], b["scores"]) for b in beams]

    # (a) the fp32 step
    loss_err = max(abs(r["loss"] - loss_one) for r in ranks)
    _require(set(params) == set(params_one), "the gathered parameters name other tensors")
    outside, worst = 0, 0.0
    for name, want in params_one.items():
        diff = (params[name] - want).abs()
        outside += int((diff > TP_PARAM_RTOL * want.abs() + TP_PARAM_ATOL).sum())
        worst = max(worst, float(diff.max()))
    print(f"tensor parallel (1, {TP_RANKS}) over gloo on one card, flagship fp32 AdamW step of "
          f"the IR recipe (B {IR_RECIPE_BATCH}, dropout 0.1): losses "
          f"{[r['loss'] for r in ranks]} against one process {loss_one} (max |diff| "
          f"{loss_err:.3e}, tol {TP_LOSS_TOL}); {sum(v.numel() for v in params_one.values())} "
          f"parameters, {outside} outside rtol {TP_PARAM_RTOL} / atol {TP_PARAM_ATOL}, max "
          f"|diff| {worst:.3e}; local heads {ranks[0]['local_heads']} of {HEADS}, local FFN "
          f"{ranks[0]['local_ffn']} of {FFN}; s/step of steps 2-{1 + TP_TIMED_STEPS} "
          f"{[round(r['step_s'], 5) for r in ranks]} per rank against {step_one_s:.5f} in one "
          f"process; model all-reduces of step {2 + TP_TIMED_STEPS} (each synchronised and "
          f"timed) {[round(r['step_reduce_ms'], 3) for r in ranks]} ms over "
          f"{ranks[0]['step_reduces']} calls; peak memory "
          f"{[round(r['train_peak_gib'], 3) for r in ranks]} GiB", flush=True)
    _require(all(r["local_heads"] == HEADS // TP_RANKS and r["local_ffn"] == FFN // TP_RANKS
                 for r in ranks), "the ranks do not hold their shares of the heads and the FFN")
    print(f"tensor parallel train step route: "
          f"{[('graph' if r['train_graph'] else 'eager', r['train_eager_reason']) for r in ranks]}",
          flush=True)
    _require(not any(r["train_graph"] for r in ranks),
             "a tensor-parallel rank over gloo captured its train step")
    _require(loss_err <= TP_LOSS_TOL and outside == 0,
             "the tensor-parallel step differs from the one-process step")

    # (b) the bf16 decode
    logit_err = (logits - logits_one).abs().max().item()
    logit_tol = LOGIT_TOL * max(1.0, logits_one.abs().max().item())
    print(f"tensor parallel bf16 teacher-forced logits (K {BEAMS}, int8 cache, "
          f"{TP_LOGIT_STEPS} steps, B {BATCH}) against one process: max_abs_err "
          f"{logit_err:.3e} tol {logit_tol:.3e}", flush=True)
    _require(bool(torch.isfinite(logits).all()) and logit_err <= logit_tol,
             "the tensor-parallel decode logits differ from one process")
    _require(all(np.array_equal(beams[0][0], b[0]) and np.array_equal(beams[0][1], b[1])
                 for b in beams[1:]), "the ranks decoded different beams")
    seqs, scores = beams[0]
    one_seqs = np.stack([s for s, _ in one])
    one_scores = np.stack([c for _, c in one])
    _require(bool(np.isfinite(scores).all()) and seqs.shape == one_seqs.shape
             and bool((np.diff(scores, axis=-1) <= 0).all()),
             "unexpected tensor-parallel beams")
    # Both decodes' beams rescored by the one-process model along their own
    # tokens (the top beam of every row is compared).
    t0 = time.perf_counter()
    rescored, rescored_one = [], []
    for i, seed in enumerate(TP_REQUEST_SEEDS):
        inputs, mask = _request(seed, batch=BATCH)
        rescored.append(_rescore(bf16, inputs, mask, seqs[i]))
        rescored_one.append(_rescore(bf16, inputs, mask, one_seqs[i]))
    rescore_s = time.perf_counter() - t0
    rescored, rescored_one = np.stack(rescored), np.stack(rescored_one)
    self_err = float(np.abs(rescored_one[..., 0] - one_scores[..., 0]).max())
    score_err = float(np.abs(rescored[..., 0] - scores[..., 0]).max())
    all_beams_err = float(np.abs(rescored - scores).max())
    agree = (seqs[:, :, 0] == one_seqs[:, :, 0]).all(axis=-1)
    best_diff = (scores[:, :, 0] - one_scores[:, :, 0]).astype(np.float64).ravel()
    best_mean = float(best_diff.mean())
    best_sem = float(best_diff.std(ddof=1) / np.sqrt(best_diff.size))
    per_request = [float(x) for r in ranks for x in r["request_s"]]
    print(f"tensor parallel bf16 decode of {len(TP_REQUEST_SEEDS)} requests x {BATCH} spectra, "
          f"K {BEAMS}, int8 cache: every row's top beam rescored by the one-process model, "
          f"max |diff| to the ranks' score {score_err:.3e} (tol {TP_SCORE_TOL}; all {BEAMS} "
          f"beams {all_beams_err:.3e}); the rescoring against the one-process decode's own "
          f"top scores {self_err:.3e} (tol {TP_RESCORE_TOL}); {rescore_s:.1f} s to rescore; "
          f"top beams equal to one process's on {float(agree.mean()):.4f} of rows (reported), "
          f"best score tensor-parallel minus one process over {best_diff.size} rows: mean "
          f"{best_mean:.3e} (tol {TP_BEST_MEAN_TOL}; standard error {best_sem:.3e}), max "
          f"|diff| {float(np.abs(best_diff).max()):.3e} (reported); route graph "
          f"{ranks[0]['graph']} (backend {ranks[0]['backend']}); s/request per rank "
          f"{[round(x, 4) for x in per_request]} against one process (graphs) "
          f"{[round(x, 4) for x in one_s]} (first with its capture); model all-reduces per "
          f"decode step {[round(r['decode_reduce_ms_per_step'], 3) for r in ranks]} ms over "
          f"{ranks[0]['decode_reduces_per_step']:.1f} calls (last request, synchronised); peak "
          f"memory {[round(r['decode_peak_gib'], 3) for r in ranks]} GiB", flush=True)
    _require(self_err <= TP_RESCORE_TOL, "the rescoring does not reproduce the one-process "
                                         "decode's scores")
    _require(score_err <= TP_SCORE_TOL,
             "the tensor-parallel beams' scores differ from the one-process model's")
    _require(abs(best_mean) <= TP_BEST_MEAN_TOL,
             "the tensor-parallel search finds other best scores than one process on average")
    del bf16
    torch.cuda.empty_cache()
    launches = {}
    for r in ranks:
        print(f"tensor parallel rank {r['rank']}: launches {r['launches']} over {r['steps']} "
              f"decode steps in {r['replays']} eager steps; geglu_ffn calls in partial mode "
              f"{r['partial_ffn_calls']}", flush=True)
        for name, count in r["launches"].items():
            _require(count == LAYERS * r["replays"],
                     f"rank {r['rank']}: {name} launched {count} times, want "
                     f"{LAYERS * r['replays']} ({LAYERS} x the steps)")
            launches[name] = launches.get(name, 0) + count
        _require(r["graph"] == [False], "a tensor-parallel decode over gloo used graphs")
        _require(r["partial_ffn_calls"] == r["launches"]["geglu_ffn"],
                 "a tensor-parallel decode FFN ran outside the partial mode")
    print(f"phase 11 done in {time.perf_counter() - start:.1f} s ({wall:.1f} s with the ranks' "
          f"start-up)", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; this check "
                         "runs only on a CUDA device")
    if not (REPO / "multimodalanalytical_tpu_torch").is_dir():
        raise SystemExit("chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    if sys.argv[1:2] == ["--dp-rank"]:
        run_dp_rank(json.loads(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--tp-rank"]:
        run_tp_rank(json.loads(sys.argv[2]))
        return 0
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
        route = sys.argv[sys.argv.index("--profile-train") + 1:][:1]
        profile_train(tuple(route) if route else ("eager", "graph"))
        return 0
    if "--time-ffn" in sys.argv[1:]:
        print(smi, flush=True)
        time_ffn()
        return 0
    if "--time-cross" in sys.argv[1:]:
        print(smi, flush=True)
        time_cross()
        return 0
    if "--tensor-parallel" in sys.argv[1:]:
        print(smi, flush=True)
        run_tensor_parallel()
        return 0
    if "--eval-path" in sys.argv[1:]:
        print(smi, flush=True)
        run_eval_path()
        return 0

    records = check_kernels() + [check_ffn()]
    records[-1]["partial_mode"] = check_ffn_partial()
    records[1]["long_encoder"] = check_cross_long()
    records[1]["rle_encoder"] = check_cross_rle()
    read_only = check_read_only_attention()
    dropout, dropout_phase1 = check_fused_dropout()
    records += check_flash_kernels()
    by_phase = {name: {"2": n} for name, n in run_slice().items()}
    flash_launches, dropout_phase3 = run_training_slice()
    by_phase.update({name: {"3": n} for name, n in flash_launches.items()})
    run_ir_recipe()
    eval_launches, predictor, test = run_eval_path()
    for name, n in eval_launches.items():
        by_phase[name]["5"] = n
    for name, n in run_guided_path(predictor, predictor.tokenizer, test).items():
        by_phase[name]["6"] = n
    del predictor, test
    for name, n in run_multimodal_path().items():
        by_phase[name]["7"] = n
    run_multimodal_training()
    run_align_path()
    for name, n in run_presets().items():
        by_phase[name]["9"] = n
    for name, n in run_mixture_phase().items():
        by_phase[name]["10"] = n
    for name, n in run_tensor_parallel().items():
        by_phase[name]["11"] = n
    for name, n in run_rle_serving().items():
        by_phase[name]["12"] = n
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
