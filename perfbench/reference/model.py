"""The plain reference: the CustomModel encoder-decoder in float32 PyTorch.

Pre-LN Transformer (configs/model/custom_model.yaml): per-modality token
tables or a linear patch projection, each followed by its LayerNorm, the
modalities concatenated in the data config's order, interleaved sin/cos
positions over the concatenation; encoder layers ``x + attn(LN(x))``,
``x + FFN(LN(x))`` with an exact-erf GELU FFN; decoder layers with causal
self-attention, cross-attention to the encoder and the FFN; a final
LayerNorm on each stack; an fp32 lm_head. Masked keys get -1e9.

It reads its weights by the names of the program's state dict (the load
path's format) from the tensors the benchmark made, and computes all else
again itself: the int8 self cache of beam decoding (per position and head:
``amax / 127`` scales, rounded values), dropout masks from the training
stream, the optimizer's state. With ``fp8`` every projection's input and
weight are rounded to float8 e4m3 with a per-tensor scale first: the
control, one precision step below the configuration's bfloat16.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..modality_types import TEXT_LIKE_TYPES, require_plain_ids

MASKED = -1.0e9
LN_EPS = 1e-5
FP8_MAX = 448.0
# The most bytes one (rows, H, Lq, Lk) float32 tensor of attention logits
# may take: at H 8 the encoder of a B 128 batch is one block up to Ls 724
# (26 and 279 among them) and 4 rows at Ls 4090 (0.5 GB a row; two such
# tensors are live at once).
LOGITS_BUDGET_BYTES = 2 * 2 ** 30


def sincos_table(rows: int, width: int, device) -> torch.Tensor:
    """Interleaved [sin(p w0), cos(p w0), sin(p w1), ...], w_i = 10000**(-2i/D)."""
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, width, 2) / width))
    angles = np.arange(rows)[:, None] * inv_freq[None, :]
    table = np.stack([np.sin(angles), np.cos(angles)], axis=2).reshape(rows, -1)[:, :width]
    return torch.as_tensor(table, dtype=torch.float32, device=device)


def rows_in_budget(batch: int, heads: int, lq: int, lk: int,
                   budget: int = LOGITS_BUDGET_BYTES) -> int:
    """Batch rows whose (rows, heads, lq, lk) float32 logits fit in
    ``budget`` bytes: at least 1, at most ``batch``."""
    return max(1, min(batch, budget // (heads * lq * lk * 4)))


class _Fp8Round(torch.autograd.Function):
    """Round to float8 e4m3 under a per-tensor scale; the gradient passes."""

    @staticmethod
    def forward(ctx, x):
        scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    @staticmethod
    def backward(ctx, grad):
        return grad


def int8_roundtrip(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., D) -> the int8 cache's values: per head, ``amax / 127`` scale,
    values rounded to nearest and clamped to +-127, times the scale."""
    xh = x.reshape(*x.shape[:-1], heads, -1)
    scale = xh.abs().amax(dim=-1, keepdim=True) / 127.0
    return (torch.clamp(torch.round(xh / scale), -127, 127) * scale).reshape(x.shape)


class Reference:
    """``params``: name -> float32 tensor (the program's state-dict names).
    ``config``: the configuration file's dict (``model`` and ``data``).
    ``logits_budget``: bytes of float32 logits that one block of attention
    rows may take (:func:`rows_in_budget`)."""

    def __init__(self, params: Dict[str, torch.Tensor], config: Dict[str, Any],
                 fp8: bool = False, logits_budget: int = LOGITS_BUDGET_BYTES):
        model = config["model"]
        self.p = params
        self.data = config["data"]
        self.d = model["d_model"]
        self.heads = model["encoder_attention_heads"]
        self.dec_heads = model["decoder_attention_heads"]
        self.enc_layers, self.dec_layers = model["encoder_layers"], model["decoder_layers"]
        self.rate = float(model.get("dropout", 0.0))
        self.fp8 = fp8
        self.logits_budget = logits_budget
        self.target = next(m for m, s in self.data.items() if s["target"])
        device = next(iter(params.values())).device
        self.positions = sincos_table(model["max_position_embeddings"], self.d, device)

    # ------------------------------------------------------------ pieces
    def dense(self, x: torch.Tensor, name: str) -> torch.Tensor:
        weight = self.p[name + ".weight"]
        if self.fp8:
            x, weight = _Fp8Round.apply(x), _Fp8Round.apply(weight)
        y = x @ weight.t()
        bias = self.p.get(name + ".bias")
        return y if bias is None else y + bias

    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, (self.d,), self.p[name + ".weight"], self.p[name + ".bias"],
                            LN_EPS)

    def drop(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """Inverted dropout; the mask is the training stream's next draw."""
        if generator is None or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), device=x.device))

    def attention(self, prefix: str, query: torch.Tensor, memory: Optional[torch.Tensor],
                  bias: torch.Tensor, heads: int, int8_kv: bool = False) -> torch.Tensor:
        """Self-attention (``memory`` None: fused qkv projection) or
        cross-attention; ``bias`` broadcasts to (B, H, Lq, Lk). The logits,
        softmax and product with V are taken in blocks of the batch rows
        whose logits fit in ``logits_budget`` (the whole batch at every
        shape of the benchmark's cells up to Ls 279); the projections see
        the whole batch, so the control's per-tensor scales do too."""
        if memory is None:
            q, k, v = self.dense(query, prefix + ".qkv_proj").chunk(3, dim=-1)
        else:
            q = self.dense(query, prefix + ".q_proj")
            k, v = self.dense(memory, prefix + ".kv_proj").chunk(2, dim=-1)
        if int8_kv:
            k, v = int8_roundtrip(k, heads), int8_roundtrip(v, heads)
        b, lq, _ = q.shape

        def split(t):
            return t.reshape(b, t.shape[1], heads, -1).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        bias = bias.expand(b, -1, -1, -1)
        step = rows_in_budget(b, heads, lq, k.shape[2], self.logits_budget)
        out = torch.cat([self.attend(q[r], k[r], v[r], bias[r])
                         for r in (slice(s, s + step) for s in range(0, b, step))])
        return self.dense(out.transpose(1, 2).reshape(b, lq, self.d), prefix + ".out_proj")

    @staticmethod
    def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
        """softmax(q k^T / sqrt(Dh) + bias) v over every key, (B, H, Lq, Dh)."""
        logits = (q @ k.transpose(-1, -2)) * (q.shape[-1] ** -0.5) + bias
        return torch.softmax(logits, dim=-1) @ v

    def ffn(self, x: torch.Tensor, prefix: str, generator) -> torch.Tensor:
        hidden = self.drop(F.gelu(self.dense(x, prefix + ".linear1")), generator)
        return self.drop(self.dense(hidden, prefix + ".linear2"), generator)

    def embed(self, modality: str, x: torch.Tensor) -> torch.Tensor:
        spec = self.data[modality]
        if spec["type"] in TEXT_LIKE_TYPES:
            require_plain_ids(modality, spec)
            e = self.p[f"embedding.embed_{modality}.weight"][x.long()]
        elif spec["type"] == "1D_patches":
            e = self.dense(x.float(), f"embedding.embed_{modality}.proj")
        else:
            raise ValueError(f"no reference embedding for {spec['type']!r}")
        return self.norm(e, f"embedding.norm_{modality}")

    @staticmethod
    def key_bias(mask: torch.Tensor) -> torch.Tensor:
        """(B, L) keep-mask -> (B, 1, 1, L) additive bias."""
        return torch.where(mask[:, None, None, :] > 0, 0.0, MASKED)

    # ------------------------------------------------------------ stacks
    def encode(self, inputs: Dict[str, torch.Tensor], mask: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        order = [m for m in self.data if m in inputs]
        x = torch.cat([self.embed(m, inputs[m]) for m in order], dim=1)
        x = x + self.positions[: x.shape[1]]
        bias = self.key_bias(mask)
        for i in range(self.enc_layers):
            prefix = f"encoder.layer_{i}"
            x = x + self.drop(self.attention(prefix + ".self_attn",
                                             self.norm(x, prefix + ".norm1"), None, bias,
                                             self.heads), generator)
            x = x + self.ffn(self.norm(x, prefix + ".norm2"), prefix + ".ff", generator)
        return self.norm(x, "encoder.final_norm")

    def decode(self, ids: torch.Tensor, ids_mask: Optional[torch.Tensor], memory: torch.Tensor,
               memory_mask: torch.Tensor, generator: Optional[torch.Generator] = None,
               int8_kv: bool = False) -> torch.Tensor:
        """Teacher-forced logits (B, Lt, V) of target ``ids`` (B, Lt)."""
        length = ids.shape[1]
        x = self.embed(self.target, ids) + self.positions[:length]
        causal = torch.triu(torch.full((length, length), MASKED, device=ids.device), 1)
        self_bias = causal[None, None]
        if ids_mask is not None:
            self_bias = self_bias + self.key_bias(ids_mask)
        cross_bias = self.key_bias(memory_mask)
        for i in range(self.dec_layers):
            prefix = f"decoder.layer_{i}"
            x = x + self.drop(self.attention(prefix + ".self_attn",
                                             self.norm(x, prefix + ".norm1"), None, self_bias,
                                             self.dec_heads, int8_kv), generator)
            x = x + self.drop(self.attention(prefix + ".cross_attn",
                                             self.norm(x, prefix + ".norm2"), memory,
                                             cross_bias, self.dec_heads), generator)
            x = x + self.ffn(self.norm(x, prefix + ".norm3"), prefix + ".ff", generator)
        return self.dense(self.norm(x, "decoder.final_norm"), "lm_head")

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Mean cross entropy over the labels that are not -100."""
        memory = self.encode(batch["encoder_inputs"], batch["encoder_mask"], generator)
        logits = self.decode(batch["decoder_ids"], batch["decoder_mask"], memory,
                             batch["encoder_mask"], generator)
        labels = batch["labels"].long()
        keep = labels != -100
        logp = torch.log_softmax(logits, dim=-1)
        picked = logp.gather(-1, torch.where(keep, labels, 0)[..., None])[..., 0]
        return -(picked * keep).sum() / keep.sum()
