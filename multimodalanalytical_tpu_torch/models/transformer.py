"""Transformer encoder/decoder stacks (counterpart of ``models/transformer.py``).

Pre- or post-LN layers with an optional gated FFN. Norms (LayerNorm, or
T5's RMSNorm) run in fp32 and their output is cast to the compute dtype;
residual streams stay in the compute dtype. Dropout sits where the JAX
layers put it (FFN hidden and FFN output, every attention output before its
residual add) and is drawn from the ``generator`` that a training forward
passes down; ``generator=None`` is the deterministic (inference) mode. With
``relative_position_bias`` (T5) each stack holds one
:class:`RelativePositionBias`, added to every layer's self-attention bias.

Under tensor parallelism (a ``mesh`` with a model axis) the attention
modules run on their local heads (``ops/attention.py``) and the FFN holds
F / n_model of the hidden width: ``linear1`` and ``gate`` column-parallel,
``linear2`` row-parallel. Each residual branch ends in a sum over the model
group, so the residual stream, the norms and every dropout on a branch's
output act on the replicated activation: their draws must be the same on
every rank of the group, which the trainer ensures by seeding the dropout
stream from the data index. The dropout on the FFN's sharded hidden draws
the mask of the whole hidden and keeps this rank's columns
(``ops/dropout.py``), so a tensor-parallel step drops what the one-process
step drops.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import MultiHeadAttention
from ..ops.decode_ffn import geglu_ffn
from ..ops.dropout import dropout
from ..ops.layers import Dense, LayerNorm, RMSNorm
from ..ops.positional import RelativePositionBias
from ..parallel.mesh import shards_width
from ..parallel.tensor import reduce_from_model

ACTIVATIONS = {
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def _norm(norm_type: str, dim: int, device=None) -> nn.Module:
    """LayerNorm (eps 1e-5, torch's default, as the reference's layers) or
    RMSNorm (eps 1e-6, T5's), both fp32."""
    return RMSNorm(dim, device=device) if norm_type == "rmsnorm" else LayerNorm(dim, device=device)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, ffn_dim: int, activation: str = "gelu",
                 gated_linear: bool = False, *, dtype=torch.float32, use_bias: bool = True,
                 dropout: float = 0.0, device=None, generator: torch.Generator, mesh=None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"Unsupported activation {activation!r}")
        self.activation, self.dtype, self.use_bias = activation, dtype, use_bias
        self.dropout, self.ffn_dim = dropout, ffn_dim
        split = shards_width(ffn_dim, mesh)
        self.mesh = mesh if split else None
        dense = dict(bias=use_bias, dtype=dtype, device=device, generator=generator)
        column = dict(mesh=mesh, shard_axis=0) if split else {}
        self.linear1 = Dense(d_model, ffn_dim, **dense, **column)
        self.gate = Dense(d_model, ffn_dim, **dense, **column) if gated_linear else None
        self.linear2 = Dense(ffn_dim, d_model, **dense,
                             **(dict(mesh=mesh, shard_axis=1) if split else {}))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        hidden = ACTIVATIONS[self.activation](self.linear1(x))
        if self.gate is not None:
            hidden = hidden * self.gate(x)
        if self.mesh is None:
            hidden = dropout(hidden, self.dropout, generator)
        else:
            hidden = dropout(hidden, self.dropout, generator,
                             (self.mesh.n_model, self.mesh.model_index))
        return dropout(self.linear2(hidden), self.dropout, generator)

    def decode_fused(self, x: torch.Tensor) -> torch.Tensor:
        """Decode-path FFN: the fused kernel (ops/decode_ffn.py) for bf16
        GELU FFNs with biases on flat (M, D) rows; the plain path otherwise.
        Split over a model group, the kernel's partial mode gives this
        rank's fp32 down product over its F columns; the sum over the group
        is rounded, b2 added and rounded, where the full kernel rounds."""
        if not (self.dtype == torch.bfloat16 and self.use_bias
                and self.activation == "gelu" and x.ndim == 2):
            return self(x)
        gate = self.gate
        args = (x, self.linear1.weight, self.linear1.bias,
                gate.weight if gate is not None else None,
                gate.bias if gate is not None else None, self.linear2.weight)
        if self.mesh is None:
            return geglu_ffn(*args, self.linear2.bias)
        partial = geglu_ffn(*args, None, partial=True)
        return (reduce_from_model(partial, self.mesh).to(torch.bfloat16)
                + self.linear2.bias.to(torch.bfloat16))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, activation: str = "gelu",
                 gated_linear: bool = False, norm_first: bool = True, *, dtype=torch.float32,
                 dropout: float = 0.0, use_flash: bool = False, norm_type: str = "layernorm",
                 attention_bias: bool = True, attention_scale: bool = True,
                 ffn_bias: bool = True, device=None, generator: torch.Generator, mesh=None):
        super().__init__()
        self.norm_first, self.dtype, self.dropout = norm_first, dtype, dropout
        self.self_attn = MultiHeadAttention(
            num_heads, d_model, dtype=dtype, use_flash=use_flash, use_bias=attention_bias,
            scale_qk=attention_scale, device=device, generator=generator, mesh=mesh)
        self.ff = FeedForward(d_model, ffn_dim, activation, gated_linear, dtype=dtype,
                              use_bias=ffn_bias, dropout=dropout, device=device,
                              generator=generator, mesh=mesh)
        self.norm1 = _norm(norm_type, d_model, device)
        self.norm2 = _norm(norm_type, d_model, device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def drop(h):
            return dropout(h, self.dropout, generator)

        if self.norm_first:
            normed = self.norm1(x).to(self.dtype)
            x = x + drop(self.self_attn(normed, normed, bias))
            return x + self.ff(self.norm2(x).to(self.dtype), generator)
        x = self.norm1(x + drop(self.self_attn(x, x, bias))).to(self.dtype)
        return self.norm2(x + self.ff(x, generator)).to(self.dtype)


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, activation: str = "gelu",
                 gated_linear: bool = False, norm_first: bool = True, *, dtype=torch.float32,
                 dropout: float = 0.0, use_flash: bool = False, use_beam_kernel: bool = True,
                 norm_type: str = "layernorm", attention_bias: bool = True,
                 attention_scale: bool = True, ffn_bias: bool = True, device=None,
                 generator: torch.Generator, mesh=None):
        super().__init__()
        self.norm_first, self.dtype, self.dropout = norm_first, dtype, dropout
        attn = dict(dtype=dtype, use_bias=attention_bias, scale_qk=attention_scale,
                    device=device, generator=generator, mesh=mesh)
        self.self_attn = MultiHeadAttention(num_heads, d_model, use_flash=use_flash,
                                            use_beam_kernel=use_beam_kernel, **attn)
        # As in the JAX package, use_beam_kernel gates the self-attention
        # kernel only; cross-attention always takes its kernel.
        self.cross_attn = MultiHeadAttention(num_heads, d_model, mode="cross", **attn)
        self.ff = FeedForward(d_model, ffn_dim, activation, gated_linear, dtype=dtype,
                              use_bias=ffn_bias, dropout=dropout, device=device,
                              generator=generator, mesh=mesh)
        self.norm1 = _norm(norm_type, d_model, device)
        self.norm2 = _norm(norm_type, d_model, device)
        self.norm3 = _norm(norm_type, d_model, device)

    def beam_decode_step(self, x, self_cache, ancestry, cross_kv, cross_bias, position,
                         extra_bias=None):
        """Lazy-ancestry beam decode through this layer on flat (B*K, D) rows;
        appends to ``self_cache`` in place. ``extra_bias`` (1, H, 1, L) is
        added to the self-attention logits (T5's relative bias)."""
        dt = self.dtype
        if self.norm_first:
            x = x + self.self_attn.beam_decode_self_attention(
                self.norm1(x).to(dt), self_cache, ancestry, position, extra_bias)
            x = x + self.cross_attn.beam_decode_cross_attention(
                self.norm2(x).to(dt), cross_kv, cross_bias)
            return x + self.ff.decode_fused(self.norm3(x).to(dt))
        h = self.self_attn.beam_decode_self_attention(x, self_cache, ancestry, position,
                                                       extra_bias)
        x = self.norm1(x + h).to(dt)
        x = self.norm2(x + self.cross_attn.beam_decode_cross_attention(
            x, cross_kv, cross_bias)).to(dt)
        return self.norm3(x + self.ff.decode_fused(x)).to(dt)

    def forward(self, x, encoder_hidden, self_bias, cross_bias,
                generator: Optional[torch.Generator] = None):
        dt = self.dtype

        def drop(h):
            return dropout(h, self.dropout, generator)

        if self.norm_first:
            normed = self.norm1(x).to(dt)
            x = x + drop(self.self_attn(normed, normed, self_bias))
            x = x + drop(self.cross_attn(self.norm2(x).to(dt), encoder_hidden, cross_bias))
            return x + self.ff(self.norm3(x).to(dt), generator)
        x = self.norm1(x + drop(self.self_attn(x, x, self_bias))).to(dt)
        x = self.norm2(x + drop(self.cross_attn(x, encoder_hidden, cross_bias))).to(dt)
        return self.norm3(x + self.ff(x, generator)).to(dt)


def _stack_kwargs(cfg, num_heads: int, ffn_dim: int, dtype, device, generator, mesh) -> dict:
    return dict(mesh=mesh,
        d_model=cfg.d_model, num_heads=num_heads, ffn_dim=ffn_dim,
        activation=cfg.activation_function, gated_linear=cfg.gated_linear,
        norm_first=cfg.post_layer_normalisation, dtype=dtype, dropout=cfg.dropout,
        use_flash=cfg.use_flash_attention, norm_type=cfg.norm_type,
        attention_bias=cfg.attention_bias, attention_scale=cfg.attention_scale,
        ffn_bias=cfg.ffn_bias, device=device, generator=generator,
    )


class Encoder(nn.Module):
    def __init__(self, cfg, *, device=None, generator: torch.Generator, mesh=None):
        super().__init__()
        kw = _stack_kwargs(cfg, cfg.encoder_attention_heads, cfg.encoder_ffn_dim,
                           cfg.compute_dtype, device, generator, mesh)
        self.dtype = cfg.compute_dtype
        self.num_layers = cfg.encoder_layers
        self.rel_bias = (RelativePositionBias(cfg.encoder_attention_heads, bidirectional=True,
                                              device=device, generator=generator)
                         if cfg.relative_position_bias else None)
        for i in range(cfg.encoder_layers):
            self.add_module(f"layer_{i}", EncoderLayer(**kw))
        self.final_norm = (_norm(cfg.norm_type, cfg.d_model, device)
                           if cfg.final_layer_norm else None)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rel_bias is not None:
            # T5: the bidirectional bucketed bias, shared by the layers.
            positions = torch.arange(x.shape[1], device=x.device)
            bias = bias + self.rel_bias(positions, positions)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, bias, generator)
        if self.final_norm is not None:
            x = self.final_norm(x).to(self.dtype)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg, *, device=None, generator: torch.Generator, mesh=None):
        super().__init__()
        kw = _stack_kwargs(cfg, cfg.decoder_attention_heads, cfg.decoder_ffn_dim,
                           cfg.compute_dtype, device, generator, mesh)
        self.dtype = cfg.compute_dtype
        for i in range(cfg.decoder_layers):
            self.add_module(f"layer_{i}",
                            DecoderLayer(use_beam_kernel=cfg.use_beam_kernel, **kw))
        self.final_norm = (_norm(cfg.norm_type, cfg.d_model, device)
                           if cfg.final_layer_norm else None)
        self.rel_bias = (RelativePositionBias(cfg.decoder_attention_heads, bidirectional=False,
                                              device=device, generator=generator)
                         if cfg.relative_position_bias else None)
        self.num_layers = cfg.decoder_layers

    @property
    def layers(self) -> List[DecoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def project_cross_kv(self, encoder_hidden: torch.Tensor, out=None):
        """Per-layer flat (B, Ls, D) cross-attention K/V of the encoder output.
        With ``out`` (per-layer (k, v) tensors of those shapes) each layer's
        are copied into it as they are projected, so that one layer's
        projection is live at a time, and ``out`` is returned."""
        if out is None:
            return [layer.cross_attn.project_kv_flat(encoder_hidden) for layer in self.layers]
        for layer, (k, v) in zip(self.layers, out):
            k_new, v_new = layer.cross_attn.project_kv_flat(encoder_hidden)
            k.copy_(k_new)
            v.copy_(v_new)
        return out

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        return self.final_norm(x).to(self.dtype) if self.final_norm is not None else x

    def beam_decode_step(self, x, self_caches, ancestry, cross_kvs, cross_bias, position):
        """``position``: the step index as a 0-d tensor on x's device; the
        relative bias is computed from it there, over the stage's
        ``ancestry.shape[2]`` times."""
        extra_bias = None
        if self.rel_bias is not None:
            extra_bias = self.rel_bias(position[None],
                                       torch.arange(ancestry.shape[2], device=x.device))
        for layer, cache, cross_kv in zip(self.layers, self_caches, cross_kvs):
            x = layer.beam_decode_step(x, cache, ancestry, cross_kv, cross_bias, position,
                                       extra_bias)
        return self._final(x)

    def forward(self, x, encoder_hidden, self_bias, cross_bias,
                generator: Optional[torch.Generator] = None):
        # As in the JAX package, a one-token target gets no relative bias.
        if self.rel_bias is not None and x.shape[1] > 1:
            positions = torch.arange(x.shape[1], device=x.device)
            self_bias = self_bias + self.rel_bias(positions, positions)
        for layer in self.layers:
            x = layer(x, encoder_hidden, self_bias, cross_bias, generator)
        return self._final(x)
