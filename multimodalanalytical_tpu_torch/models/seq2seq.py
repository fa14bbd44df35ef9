"""The multimodal encoder-decoder (counterpart of ``models/seq2seq.py``).

``encode``, ``decode_train``, ``forward`` (loss and logits, with the
alignment head's loss when the config has one), the lazy-ancestry beam
cache and ``beam_decode_step``. Module and parameter names follow the JAX
param tree (``models/weights.py``).

``forward(..., deterministic=False, generator=g)`` is the training forward:
dropout at the JAX sites, drawn from ``g``. The default is deterministic.

``Seq2SeqModel(..., mesh=m)`` builds this process's part of the model on
the mesh's layout (``parallel/mesh.py``): under tensor parallelism the
stacks run on local heads and FFN columns (``models/transformer.py``) and
the lm_head holds this rank's vocabulary columns; the logits are gathered
over the model group before the cross entropy and before the beam's
log-softmax and top-k, so everything after them is replicated. Weights are
drawn in full and sliced, so the ranks' slices are the one-process
model's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.attention import make_attention_bias, make_causal_bias
from ..ops.layers import Dense, LayerNorm, make_generator
from ..parallel.mesh import Mesh, shards_width
from ..parallel.tensor import gather_from_model
from .align import ALIGN_LOSSES, AlignNetwork
from .config import ModelConfig
from .embedding import MultimodalEmbedding
from .transformer import Decoder, Encoder


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over positions whose label is not -100: the sum over this
    batch's positions divided by ``count``, by default their number (under
    data parallelism, the number over every rank's rows)."""
    mask = labels != -100
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, torch.where(mask, labels, 0).long()[..., None])[..., 0]
    count = mask.sum() if count is None else count
    return -(picked * mask).sum() / count.clamp_min(1)


class Seq2SeqModel(nn.Module):
    def __init__(self, config: ModelConfig, data_config: Dict[str, Any],
                 target_modality: str, multimodal_norm: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None):
        """``generator`` seeds the initialisation (default: seed 0 on ``device``);
        ``mesh`` is this process's layout (None: one process, or data
        parallelism over the process group)."""
        super().__init__()
        self.config = config
        self.target_modality = target_modality
        self.mesh = mesh
        g = make_generator(generator, device)
        dtype = config.compute_dtype
        self.embedding = MultimodalEmbedding(
            data_config, config.d_model, embedding_norm=multimodal_norm,
            do_positional_encodings=config.use_absolute_positions,
            positional_encodings_type=config.positional_encoding_type,
            max_seq_len=config.max_position_embeddings,
            unnormed=() if config.decoder_modality_norm else (target_modality,),
            dtype=dtype, device=device, generator=g)
        self.encoder = Encoder(config, device=device, generator=g, mesh=mesh)
        self.decoder = Decoder(config, device=device, generator=g, mesh=mesh)
        self.lm_head = Dense(config.d_model, config.vocab_size, bias=config.lm_head_bias,
                             dtype=torch.float32, device=device, generator=g,
                             **(dict(mesh=mesh, shard_axis=0)
                                if shards_width(config.vocab_size, mesh) else {}))
        self.decoder_emb_norm = (LayerNorm(config.d_model, device=device)
                                 if config.decoder_embedding_layernorm else None)
        self.align_network = (AlignNetwork(config.align_config, config.d_model, device=device,
                                           generator=g)
                              if config.align_config is not None else None)

    def _embed_target(self, inputs, decode_positions=None) -> torch.Tensor:
        embeds = self.embedding(inputs, decode_positions=decode_positions,
                                apply_norm=self.config.decoder_modality_norm)
        if self.decoder_emb_norm is not None:
            embeds = self.decoder_emb_norm(embeds).to(embeds.dtype)
        return embeds

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """lm_head in fp32 (with T5's tied-embedding d**-0.5 output scaling),
        its vocabulary columns gathered over the model group when split."""
        hidden = hidden.float()
        if self.config.tied_logits_scale:
            hidden = hidden * (self.config.d_model ** -0.5)
        return gather_from_model(self.lm_head(hidden), self.lm_head.mesh)

    def encode(self, encoder_inputs: Dict[str, torch.Tensor], encoder_mask: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        embeds = self.embedding(encoder_inputs)
        return self.encoder(embeds, make_attention_bias(encoder_mask), generator)

    def decode_train(self, decoder_ids, decoder_mask, encoder_hidden, encoder_mask,
                     generator: Optional[torch.Generator] = None):
        """Teacher-forced logits (B, Lt, V)."""
        embeds = self._embed_target({self.target_modality: decoder_ids})
        self_bias = (make_causal_bias(decoder_ids.shape[1], device=decoder_ids.device)
                     + make_attention_bias(decoder_mask))
        hidden = self.decoder(embeds, encoder_hidden, self_bias,
                              make_attention_bias(encoder_mask), generator)
        return self._logits(hidden)

    def forward(self, encoder_inputs, encoder_mask, decoder_ids, decoder_mask, labels,
                align_target: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                loss_counts: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """Loss and logits. ``deterministic=False`` applies dropout, drawn
        from ``generator`` (required then, unless the dropout rate is 0).
        With an align head and an ``align_target`` (B, output_dimension),
        ``loss`` is the CE plus ``loss_lambda`` times the alignment loss.
        ``loss_counts`` = (target tokens, valid rows) of the global batch
        under data parallelism: the losses are then this rank's share of
        the global batch's, and the shares of all ranks sum to it."""
        if deterministic:
            generator = None
        elif generator is None and self.config.dropout > 0:
            raise ValueError("a training forward with dropout needs a generator")
        encoder_hidden = self.encode(encoder_inputs, encoder_mask, generator)
        logits = self.decode_train(decoder_ids, decoder_mask, encoder_hidden, encoder_mask,
                                   generator)
        tokens, valid_rows = (None, None) if loss_counts is None else loss_counts
        ce = cross_entropy_loss(logits, labels, tokens)
        align_loss, total = torch.zeros((), device=ce.device), ce
        if self.align_network is not None and align_target is not None:
            align_loss = self.alignment_loss(encoder_hidden, encoder_mask, align_target,
                                             valid_rows)
            total = ce + self.config.align_config.loss_lambda * align_loss
        return {"loss": total, "model_only_loss": ce, "alignment_loss": align_loss,
                "logits": logits}

    def alignment_loss(self, encoder_hidden: torch.Tensor, encoder_mask: torch.Tensor,
                       align_target: torch.Tensor,
                       valid_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The head's loss on the encoder states mean-pooled over the mask.
        Fully masked rows (batch padding) are zeroed in prediction and
        target, and the mse / mae mean is rescaled to the valid rows: this
        batch's, or ``valid_rows`` (a float count over every rank's rows)."""
        mask = encoder_mask[..., None].float()
        pooled = (encoder_hidden.float() * mask).sum(dim=1) / (mask.sum(dim=1) + 1e-9)
        pred = self.align_network(pooled)
        row_valid = (encoder_mask.sum(dim=1) > 0).float()[:, None]
        raw = ALIGN_LOSSES[self.config.align_config.loss_function](
            pred * row_valid, align_target.float() * row_valid)
        valid_rows = row_valid.sum() if valid_rows is None else valid_rows
        return raw * (pred.shape[0] / valid_rows.clamp_min(1.0))

    def init_beam_cache(self, batch_size: int, num_beams: int, max_length: int,
                        encoder_hidden: torch.Tensor, encoder_mask: torch.Tensor,
                        quantize: bool = False):
        """Lazy-ancestry beam cache: {"self": per-layer (2, B, L*K, D) buffers
        (or {"data": int8, "scale": (2, B, H, F_pad) fp32} with F_pad = L*K
        rounded up to 128), "cross": per-layer flat (k, v), "cross_bias":
        the (B, Ls) fp32 padding bias of ``encoder_mask``, built once for
        every step and layer}. Flat row l*K + s holds what beam slot s wrote
        at time l; rows are never reordered. Under tensor parallelism the
        self caches hold this rank's heads only (D and H local)."""
        cfg = self.config
        device = encoder_hidden.device
        flat = max_length * num_beams
        attn = self.decoder.layers[0].self_attn
        shape = (2, batch_size, flat, attn.width)
        if quantize:
            flat_pad = (flat + 127) // 128 * 128
            selves: list = [
                {"data": torch.zeros(shape, dtype=torch.int8, device=device),
                 "scale": torch.zeros((2, batch_size, attn.num_heads, flat_pad),
                                      device=device)}
                for _ in range(cfg.decoder_layers)]
        else:
            selves = [torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
                      for _ in range(cfg.decoder_layers)]
        return {"self": selves, "cross": self.decoder.project_cross_kv(encoder_hidden),
                "cross_bias": make_attention_bias(encoder_mask)[:, 0, 0]}

    def beam_decode_step(self, token_ids: torch.Tensor, position, cache,
                         ancestry: torch.Tensor) -> torch.Tensor:
        """One beam decode step: (B, K) tokens -> logits (B, K, V); appends to
        the self caches in place. ``position`` is the step index: a 0-d
        tensor on the tokens' device (the decode loop's, which a CUDA graph
        of the step reads at every replay) or an int; it is never read on
        the host here."""
        batch, beams = token_ids.shape
        if not isinstance(position, torch.Tensor):
            position = torch.full((), position, device=token_ids.device)
        position = position.to(torch.int32)
        positions = position.reshape(1, 1).expand(batch * beams, 1)
        embeds = self._embed_target(
            {self.target_modality: token_ids.reshape(batch * beams, 1)},
            decode_positions=positions)
        x = embeds.reshape(batch * beams, self.config.d_model)
        hidden = self.decoder.beam_decode_step(
            x, cache["self"], ancestry, cache["cross"], cache["cross_bias"], position)
        return self._logits(hidden).reshape(batch, beams, -1)
