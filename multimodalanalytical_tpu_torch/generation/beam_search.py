"""Beam search with a lazy-ancestry KV cache (counterpart of ``generation/beam_search.py``).

The decode loop is a Python loop over steps. Per step:

* the slot-flattened self cache gets this step's rows at slot = live-beam
  index, and an int32 ancestry table (B, K, L) records which slot holds
  beam n's time-l row, so beam reordering never moves the cache;
* cross-attention K/V are projected once, at batch size;
* HF semantics with the reference's generation config: log_softmax, forced
  EOS at ``t == max_length - 2``, length-normalised finished hypotheses,
  ``num_return_sequences = num_beams``, beams sorted by normalised score;
* the provably safe early exit: stop once no live beam can beat the worst
  finished hypothesis (one host sync per step).

Ties in every top-k break toward the lower index, as ``jax.lax.top_k`` does
(a stable descending sort), so fp32 runs pick the beams the JAX package
picks. Decode stages (growing attended cache prefixes) are kept; the JAX
package's rounding of stage sizes to its kernel's tiling is not needed.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.seq2seq import Seq2SeqModel
from ..ops.layers import Dense

NEG_INF = -1.0e7


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def decode_model(model: Seq2SeqModel) -> Seq2SeqModel:
    """The model to decode with: for bf16 models, a copy whose float32
    weights with ndim >= 2 (Dense kernels, embedding tables, the lm_head)
    are pre-cast to bf16 once, as the JAX package does before its loop, and
    so are the biases of the Dense layers that compute in bf16 (each call
    would cast them to bf16 again: the same values, bit for bit). Norm
    parameters stay fp32, and the lm_head then runs in fp32 on
    bf16-rounded weights and its fp32 bias. A model with no such parameter
    left is returned as is.
    """
    cast = [p for p in model.parameters() if p.dtype == torch.float32 and p.ndim >= 2]
    cast += [m.bias for m in model.modules()
             if isinstance(m, Dense) and m.dtype == torch.bfloat16 and m.bias is not None
             and m.bias.dtype == torch.float32]
    if model.config.compute_dtype != torch.bfloat16 or not cast:
        return model
    memo = {id(p): torch.nn.Parameter(p.detach().to(torch.bfloat16), requires_grad=False)
            for p in cast}
    return copy.deepcopy(model, memo)


def kv_cache_quantized(cfg, num_beams: int, max_length: int) -> bool:
    """The JAX package's int8-cache decision (so both pick the same cache)."""
    head_dim = cfg.d_model // cfg.decoder_attention_heads
    return (
        cfg.kv_cache_dtype == "int8"
        and 4 <= num_beams <= 32
        and cfg.d_model % 128 == 0
        and head_dim % 64 == 0
        and (max_length * num_beams) % 32 == 0
        and max_length * num_beams >= 64
        and not cfg.relative_position_bias
        and cfg.use_beam_kernel
    )


@torch.no_grad()
def beam_search(
    model: Seq2SeqModel,
    encoder_inputs: Dict[str, torch.Tensor],
    encoder_mask: torch.Tensor,
    num_beams: int,
    max_length: int = 128,
    length_penalty: float = 1.0,
    stage_size: Optional[int] = 32,
    stats: Optional[Dict[str, Any]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sequences (B, K, max_length) int64, scores (B, K) fp32).

    Sequences start with BOS and are padded after EOS; beams are sorted
    best-first by normalised score. ``stage_size`` decodes in stages whose
    attended cache prefix grows (stage_size, 2*stage_size, ..., max_length);
    stages never change results. ``stats``, if given, receives ``steps``:
    the number of decode steps run.
    """
    cfg = model.config
    batch = encoder_mask.shape[0]
    device = encoder_mask.device
    bos, eos, pad = cfg.decoder_start_token_id, cfg.eos_token_id, cfg.pad_token_id
    quantize = kv_cache_quantized(cfg, num_beams, max_length)
    if stage_size is None or stage_size >= max_length:
        bounds = [max_length]
    else:
        bounds = list(range(stage_size, max_length, stage_size)) + [max_length]

    encoder_hidden = model.encode(encoder_inputs, encoder_mask)
    dmodel = decode_model(model)
    cache = dmodel.init_beam_cache(batch, num_beams, max_length, encoder_hidden, encoder_mask,
                                   quantize)

    live_seqs = torch.full((batch, num_beams, max_length), pad, dtype=torch.long, device=device)
    live_seqs[:, :, 0] = bos
    live_scores = torch.full((batch, num_beams), NEG_INF, device=device)
    live_scores[:, 0] = 0.0
    finished_seqs = torch.full_like(live_seqs, pad)
    finished_scores = torch.full((batch, num_beams), NEG_INF, device=device)
    ancestry = torch.zeros((batch, num_beams, max_length), dtype=torch.int32, device=device)
    beam_ids = torch.arange(num_beams, dtype=torch.int32, device=device)
    live_bound_norm = float(max_length) ** length_penalty

    t = 0
    while t < max_length - 1:
        # Early exit: a live beam's best reachable score is sum / max_length.
        best_live = live_scores.max(dim=1).values / live_bound_norm
        if bool((finished_scores.min(dim=1).values >= best_live).all()):
            break
        stage_len = next(b for b in bounds if t < b - 1)
        ancestry[:, :, t] = beam_ids
        logits = dmodel.beam_decode_step(live_seqs[:, :, t], t, cache,
                                         ancestry[:, :, :stage_len])
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        vocab = logprobs.shape[-1]
        if t == max_length - 2:
            logprobs = torch.full_like(logprobs, NEG_INF)
            logprobs[:, :, eos] = 0.0

        total = (live_scores[:, :, None] + logprobs).reshape(batch, num_beams * vocab)
        topk_scores, topk_idx = _top_k(total, 2 * num_beams)
        topk_beam = topk_idx // vocab
        topk_token = topk_idx % vocab
        cand_seqs = live_seqs.gather(1, topk_beam[:, :, None].expand(-1, -1, max_length))
        cand_seqs[:, :, t + 1] = topk_token
        is_eos = topk_token == eos

        # Finished pool: HF normalises by the length before this EOS.
        cand_fin = torch.where(is_eos, topk_scores / float(t + 1) ** length_penalty, NEG_INF)
        finished_scores, fin_idx = _top_k(torch.cat([finished_scores, cand_fin], 1), num_beams)
        finished_seqs = torch.cat([finished_seqs, cand_seqs], 1).gather(
            1, fin_idx[:, :, None].expand(-1, -1, max_length))

        # Top-K non-EOS continuations become the live beams; a new beam's
        # history is its parent's (an int32 table gather, not a cache move).
        live_scores, live_idx = _top_k(torch.where(is_eos, NEG_INF, topk_scores), num_beams)
        live_seqs = cand_seqs.gather(1, live_idx[:, :, None].expand(-1, -1, max_length))
        beam_src = topk_beam.gather(1, live_idx)
        ancestry = ancestry.gather(1, beam_src[:, :, None].expand(-1, -1, max_length))
        t += 1
    if stats is not None:
        stats["steps"] = t

    merged_scores = torch.cat([finished_scores, live_scores / live_bound_norm], 1)
    merged_seqs = torch.cat([finished_seqs, live_seqs], 1)
    final_scores, final_idx = _top_k(merged_scores, num_beams)
    final_seqs = merged_seqs.gather(1, final_idx[:, :, None].expand(-1, -1, max_length))
    return final_seqs, final_scores


def greedy_decode(model: Seq2SeqModel, encoder_inputs, encoder_mask,
                  max_length: int = 128) -> torch.Tensor:
    """Greedy decoding = beam search with one beam; returns (B, max_length)."""
    seqs, _ = beam_search(model, encoder_inputs, encoder_mask, num_beams=1,
                          max_length=max_length)
    return seqs[:, 0, :]
