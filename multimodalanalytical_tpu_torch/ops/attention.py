"""Multi-head attention with the beam-decode paths (counterpart of ``ops/attention.py``).

Batch-first (B, L, D) throughout; masks are additive fp32 biases. Products
that the JAX package runs with ``preferred_element_type=float32`` upcast
their (bf16) operands to fp32 here, which is exact for the products and
keeps fp32 accumulation on every device.

Beam decode keeps the JAX package's path choices, which choose other math,
with one difference: ``use_beam_kernel`` and the 1/sqrt(Dh) scale take the
hand-written kernels of ``ops/beam_attention.py`` (for int8 or bf16 self
caches) at any beam count, greedy K = 1 included, where the JAX package
takes its XLA route below K = 2. At K = 1 with a bf16 cache the two
therefore round q*scale and the probabilities to bf16 in different places
(``tests/test_torch_model.py`` holds the greedy logits within the bf16
tolerance). Everything else (an fp32 cache, ``use_beam_kernel=False``)
takes the plain formulation ported from the JAX "XLA fallback". On a CUDA
tensor the kernel route is taken whatever the shape, and its wrapper
raises on a shape the kernels do not take; on the CPU the route follows
the kernels' shape limit, :func:`beam_kernel_supports`, so that both
devices compute the same math. A model without the 1/sqrt(Dh) scale, or
with an additive bias on the self-attention logits (``extra_bias``, T5's
relative bias), takes the plain formulation on every device, as the JAX
package routes it (its ``ops/attention.py``: the kernel only when
``extra_bias is None`` and ``scale_qk``): T5 decodes with no hand-written
kernel in either package, by that choice and not as a fallback. KV caches are
updated in place. Full-sequence attention at the flash gate (encoder
self-attention with Lq == Lk >= 2048) takes ``ops/flash_attention.py``.

Under tensor parallelism (a ``mesh`` whose model axis divides the heads)
a module holds the q, k and v columns of its H / n_model local heads
(column-parallel projections) and the matching input rows of ``out_proj``
(row-parallel, summed over the model group), and every path above runs on
the local heads at the local width (heads x head_dim): the kernels, the
flash route, the self cache (which holds only the local heads' rows and
scales). A per-head additive bias over all H heads (T5's relative bias) is
sliced to the local heads where it is added.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel.mesh import Mesh, shards_heads
from .beam_attention import beam_cross_attention, beam_kernel_supports, \
    beam_select_attention_update, quantize_kv_heads
from .flash_attention import NEG_INF, flash_attention, flash_qualifies
from .layers import Dense


def dequantize_kv(data: torch.Tensor, scale: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``data`` (2, B, F, D) int8, ``scale`` (2, B, H, F) fp32 -> (2, B, F, D) bf16."""
    two, b, f, d = data.shape
    x = data.reshape(two, b, f, num_heads, d // num_heads).float()
    s = scale.permute(0, 1, 3, 2)[..., None]
    return (x * s).to(torch.bfloat16).reshape(two, b, f, d)


def make_attention_bias(keep_mask: torch.Tensor) -> torch.Tensor:
    """(B, L) keep-mask (1 = attend) -> (B, 1, 1, L) fp32 additive bias."""
    return torch.where(keep_mask[:, None, None, :] > 0, 0.0, NEG_INF).float()


def make_causal_bias(seq_len: int, device=None) -> torch.Tensor:
    """(1, 1, L, L) fp32 additive causal bias."""
    mask = torch.tril(torch.ones(seq_len, seq_len, dtype=torch.bool, device=device))
    return torch.where(mask, 0.0, NEG_INF).float()[None, None]


def dot_product_attention(q, k, v, bias, use_flash: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, Lq, Dh) attention; fp32 logits and softmax, output in v's dtype.

    With ``use_flash`` and shapes that :func:`flash_qualifies`, on any device,
    it is :func:`flash_attention` and computes the flash kernels' math (fp32
    throughout, one rounding of the output), as the JAX package does."""
    if use_flash and flash_qualifies(q, k, bias, scale):
        return flash_attention(q, k, v, bias)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if bias is not None:
        logits = logits + bias
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


class MultiHeadAttention(nn.Module):
    """Projections + attention. ``mode`` "self" fuses q/k/v into one Dense,
    "cross" keeps q separate and fuses k/v. ``num_heads`` is the local head
    count (``total_heads`` / n_model under tensor parallelism) and ``width``
    the local width."""

    def __init__(self, num_heads: int, d_model: int, *, dtype=torch.float32,
                 use_flash: bool = False, use_beam_kernel: bool = True,
                 mode: str = "self", use_bias: bool = True, scale_qk: bool = True,
                 device=None, generator: torch.Generator, mesh: Optional[Mesh] = None):
        super().__init__()
        split = shards_heads(num_heads, mesh)
        self.total_heads, self.d_model, self.dtype = num_heads, d_model, dtype
        self.head_dim = d_model // num_heads
        self.num_heads = num_heads // mesh.n_model if split else num_heads
        self.head0 = mesh.model_index * self.num_heads if split else 0
        self.width = self.num_heads * self.head_dim
        self.use_flash, self.use_beam_kernel = use_flash, use_beam_kernel
        self.mode, self.scale_qk = mode, scale_qk
        dense = dict(bias=use_bias, dtype=dtype, device=device, generator=generator)
        column = dict(mesh=mesh, shard_axis=0) if split else {}
        if mode == "self":
            self.qkv_proj = Dense(d_model, 3 * d_model, blocks=3, **dense, **column)
        else:
            self.q_proj = Dense(d_model, d_model, **dense, **column)
            self.kv_proj = Dense(d_model, 2 * d_model, blocks=2, **dense, **column)
        self.out_proj = Dense(d_model, d_model, **dense,
                              **(dict(mesh=mesh, shard_axis=1) if split else {}))

    def _local_heads(self, bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """A (.., H, .., ..) per-head bias over all heads -> this rank's heads;
        a bias that broadcasts over the heads as it is."""
        if (bias is None or self.num_heads == self.total_heads or bias.ndim != 4
                or bias.shape[1] != self.total_heads):
            return bias
        return bias[:, self.head0:self.head0 + self.num_heads]

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        return x.reshape(b, l, self.num_heads, self.head_dim).transpose(1, 2)

    def project_kv_flat(self, kv_input: torch.Tensor):
        """Encoder K/V kept flat (B, Ls, D), projected once per sequence."""
        k, v = self.kv_proj(kv_input).chunk(2, dim=-1)
        return k.contiguous(), v.contiguous()

    def beam_decode_self_attention(
        self,
        x: torch.Tensor,             # (B*K, D) flat current-token hidden
        cache,                       # (2, B, L*K, D) | {"data": int8, "scale": (2, B, H, F_pad)}
        ancestry: torch.Tensor,      # (B, K, L) int32 slot table (stage slice)
        position,                    # step index: 0-d int32 tensor on x's device, or int
        extra_bias: Optional[torch.Tensor] = None,   # (1, H, 1, L) fp32 additive bias
    ) -> torch.Tensor:
        """Lazy-ancestry cached self-attention for beam search; appends this
        step's K/V rows to ``cache`` in place and returns (B*K, D). Neither
        route reads a tensor ``position`` on the host. ``extra_bias`` is
        added to the logits before the slot mask (plain route only)."""
        batch, beams, length = ancestry.shape
        if not isinstance(position, torch.Tensor):
            position = torch.full((), position, dtype=torch.int32, device=x.device)
        heads, head_dim, width = self.num_heads, self.head_dim, self.width
        extra_bias = self._local_heads(extra_bias)
        q_flat, k_new, v_new = self.qkv_proj(x).chunk(3, dim=-1)
        quantized = isinstance(cache, dict)
        # Unlike the Pallas kernel, the CUDA kernel takes one beam too, so
        # greedy decoding (validation's K = 1) runs through it as well.
        if (self.use_beam_kernel and self.scale_qk and extra_bias is None
                and (quantized or cache.dtype == torch.bfloat16)
                and (x.is_cuda or beam_kernel_supports(beams, width, heads))):
            # An int8 cache takes the projection's rows as they are: the
            # update quantizes them itself.
            if quantized:
                out = beam_select_attention_update(
                    q_flat.to(torch.bfloat16), k_new, v_new, cache["data"], ancestry,
                    position, heads, scales=cache["scale"])
            else:
                out = beam_select_attention_update(
                    q_flat.to(torch.bfloat16), k_new.to(cache.dtype), v_new.to(cache.dtype),
                    cache, ancestry, position, heads)
            return self.out_proj(out.to(x.dtype))

        # Plain formulation on (B, K, D) views of the flat rows.
        k_new = k_new.reshape(batch, beams, width)
        v_new = v_new.reshape(batch, beams, width)
        # This step's flat rows position*K .. position*K + K - 1.
        rows = position.long() * beams + torch.arange(beams, device=x.device)
        if quantized:
            k_q, k_s = quantize_kv_heads(k_new, heads)
            v_q, v_s = quantize_kv_heads(v_new, heads)
            cache["data"][0].index_copy_(1, rows, k_q)
            cache["data"][1].index_copy_(1, rows, v_q)
            cache["scale"][0].index_copy_(2, rows, k_s.transpose(1, 2))
            cache["scale"][1].index_copy_(2, rows, v_s.transpose(1, 2))
            flat = length * beams
            kv_store = dequantize_kv(cache["data"][:, :, :flat],
                                     cache["scale"][..., :flat], heads)
        else:
            cache[0].index_copy_(1, rows, k_new.to(cache.dtype))
            cache[1].index_copy_(1, rows, v_new.to(cache.dtype))
            kv_store = cache[:, :, : length * beams]

        q = q_flat.reshape(batch, beams, heads, head_dim)
        anc_onehot = (ancestry[..., None].long()
                      == torch.arange(beams, device=x.device)).float()   # (B, K, L, K')
        kv = kv_store.reshape(2, batch, length, beams, heads, head_dim)
        scale = head_dim ** -0.5 if self.scale_qk else 1.0
        qk_all = torch.einsum("bnhd,blkhd->bnhkl",
                              (q * scale).to(kv.dtype).float(), kv[0].float())
        logits = torch.einsum("bnhkl,bnlk->bnhl", qk_all, anc_onehot)
        if extra_bias is not None:
            logits = logits + extra_bias[0, :, 0, :]
        slots = torch.arange(length, device=x.device)
        logits = torch.where(slots <= position, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        pw = torch.einsum("bnhl,bnlk->bnhlk", probs.to(kv.dtype).float(), anc_onehot)
        out = torch.einsum("bnhlk,blkhd->bnhd", pw, kv[1].float()).to(x.dtype)
        return self.out_proj(out.reshape(batch * beams, width))

    def beam_decode_cross_attention(
        self,
        x: torch.Tensor,                          # (B*K, D) flat
        kv: Tuple[torch.Tensor, torch.Tensor],    # flat (B, Ls, D), beam-invariant
        bias: torch.Tensor,                       # (B, Ls) fp32, built once per request
    ) -> torch.Tensor:
        """Beam cross-attention against batch-sized encoder K/V; (B*K, D)."""
        batch, ls = kv[0].shape[:2]
        beams = x.shape[0] // batch
        heads, head_dim = self.num_heads, self.head_dim
        q_flat = self.q_proj(x)
        if (self.use_beam_kernel and self.scale_qk
                and (x.is_cuda or beam_kernel_supports(beams, self.width, heads))):
            out = beam_cross_attention(q_flat.to(kv[0].dtype), kv[0], kv[1], bias,
                                       heads, beams)
            return self.out_proj(out.to(x.dtype))

        q = q_flat.reshape(batch, beams, heads, head_dim)
        k = kv[0].reshape(batch, ls, heads, head_dim)
        v = kv[1].reshape(batch, ls, heads, head_dim)
        scale = head_dim ** -0.5 if self.scale_qk else 1.0
        logits = torch.einsum("bkhd,blhd->bkhl", (q * scale).to(k.dtype).float(), k.float())
        logits = logits + bias[:, None, None, :]
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkhl,blhd->bkhd", probs.to(v.dtype).float(), v.float())
        return self.out_proj(out.to(x.dtype).reshape(batch * beams, self.width))

    def forward(self, query_input: torch.Tensor, kv_input: Optional[torch.Tensor],
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence attention (encoder, teacher-forced decoder)."""
        if self.mode == "self":
            q, k, v = (self._split(t) for t in self.qkv_proj(query_input).chunk(3, dim=-1))
        else:
            q = self._split(self.q_proj(query_input))
            k, v = (self._split(t) for t in self.kv_proj(kv_input).chunk(2, dim=-1))
        out = dot_product_attention(q, k, v, self._local_heads(bias), use_flash=self.use_flash,
                                    scale=None if self.scale_qk else 1.0)
        b, h, lq, dh = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, h * dh))
