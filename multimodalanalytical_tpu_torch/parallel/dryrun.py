"""One training step and one beam decode on this process's layout
(counterpart of ``__graft_entry__.py``'s ``_run_mesh_shape``).

The JAX package's multi-chip dry run jits the full training step on meshes
(n, 1), (n/2, 2) and (n/4, 4) and holds the losses and beams equal across
them. Here each process of a ``torch.distributed`` group calls
:func:`run_layout` with its :class:`~.mesh.Mesh`: the dry run's model
(``_flagship(d_model=128, layers=2, ffn=256)`` there: 8 heads, so a 4-way
model axis leaves 2 heads a rank), fp32, on the seeded batch of 8 rows,
each data rank feeding its row block. It takes one optimizer step (Adam,
lr 1e-3, as the JAX dry run's ``Trainer``), then decodes the batch at 2
beams and max length 8 with the new weights, and returns the global
batch's loss, beams and scores (gathered over the data group) and the full
parameters after the step (gathered over the model group), the same on
every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh

D_MODEL, LAYERS, FFN, HEADS, VOCAB = 128, 2, 256, 8, 64
BATCH, BEAMS, MAX_LENGTH, LR = 8, 2, 8, 1e-3
# The batch's shape: formula tokens, IR patches of PATCH points, target tokens.
FORMULA_LEN, N_PATCHES, PATCH, TARGET_LEN = 12, 14, 125, 24

DATA_CONFIG = {
    "Formula": {"type": "text", "column": "molecular_formula", "target": False,
                "vocab_size": 32, "pad_token_id": 0, "preprocessor_arguments": {}},
    "IR": {"type": "1D_patches", "column": "ir_spectra", "target": False,
           "preprocessor_arguments": {"patch_size": 125}},
    "Smiles": {"type": "text", "column": "smiles", "target": True,
               "vocab_size": VOCAB, "pad_token_id": 0, "preprocessor_arguments": {}},
}


class DryrunResult(NamedTuple):
    loss: float
    seqs: np.ndarray          # (BATCH, BEAMS, MAX_LENGTH) int64
    scores: np.ndarray        # (BATCH, BEAMS) fp32
    params: Dict[str, torch.Tensor]   # the full parameters after the step, on the CPU


def dryrun_config(dtype: str = "float32", **overrides):
    from ..models.config import ModelConfig

    kwargs = dict(d_model=D_MODEL, encoder_layers=LAYERS, decoder_layers=LAYERS,
                  encoder_attention_heads=HEADS, decoder_attention_heads=HEADS,
                  encoder_ffn_dim=FFN, decoder_ffn_dim=FFN, vocab_size=VOCAB, dtype=dtype)
    kwargs.update(overrides)
    return ModelConfig(**kwargs)


def dryrun_model(mesh: Optional[Mesh] = None, config=None):
    """The dry run's model on ``mesh``, seeded (seed 0), on the CPU: a
    rank's slices are the one-process model's."""
    from ..models.seq2seq import Seq2SeqModel

    return Seq2SeqModel(config or dryrun_config(), DATA_CONFIG, "Smiles",
                        device=torch.device("cpu"),
                        generator=torch.Generator().manual_seed(0), mesh=mesh)


def dryrun_batch() -> Dict[str, Any]:
    """The JAX dry run's ``_example_batch`` (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    return {
        "encoder_inputs": {
            "Formula": rng.integers(4, 32, (BATCH, FORMULA_LEN)).astype(np.int32),
            "IR": rng.random((BATCH, N_PATCHES, PATCH)).astype(np.float32),
        },
        "encoder_mask": np.ones((BATCH, FORMULA_LEN + N_PATCHES), np.int32),
        "decoder_ids": rng.integers(4, VOCAB, (BATCH, TARGET_LEN)).astype(np.int32),
        "decoder_mask": np.ones((BATCH, TARGET_LEN), np.int32),
        "labels": rng.integers(4, VOCAB, (BATCH, TARGET_LEN)).astype(np.int32),
    }


def _rows(tree, rows: slice):
    if isinstance(tree, dict):
        return {key: _rows(value, rows) for key, value in tree.items()}
    return tree[rows]


def _gather_rows(local: torch.Tensor, mesh: Mesh, total: int) -> torch.Tensor:
    """Every data rank's row block in data-index order (a zeroed buffer
    summed over the data group: exact)."""
    per = local.shape[0]
    full = local.new_zeros((total,) + tuple(local.shape[1:]))
    full[mesh.data_index * per:(mesh.data_index + 1) * per] = local
    return mesh.all_reduce_data_(full)


def run_layout(mesh: Mesh, state: Optional[Mapping[str, Any]] = None,
               modality_dropout: Sequence[str] = ("IR",), model=None) -> DryrunResult:
    """One Adam step and one beam decode on ``mesh``'s layout, on the CPU.
    ``state``: a full state dict to start from (default: the seeded init);
    ``model``: a model built on ``mesh`` to use instead of the dry run's."""
    from ..models.weights import gather_state_dict, shard_state_dict
    from ..training.trainer import Trainer, device_batch

    model = model if model is not None else dryrun_model(mesh)
    if state is not None:
        model.load_state_dict(shard_state_dict(state, model))
    if BATCH % mesh.n_data:
        raise ValueError(f"{BATCH} rows do not split over {mesh.n_data} data ranks")
    per = BATCH // mesh.n_data
    local = _rows(dryrun_batch(), slice(mesh.data_index * per, (mesh.data_index + 1) * per))
    local["n_valid"] = per
    trainer = Trainer(model, num_steps=4, lr=LR, modality_dropout=list(modality_dropout),
                      seed=0)
    metrics = trainer.train_step(local)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss} on layout ({mesh.n_data}, {mesh.n_model})")
    dev = device_batch(local, trainer.device)
    seqs, scores = trainer.beam_decoder().search(dev["encoder_inputs"], dev["encoder_mask"],
                                                 BEAMS, max_length=MAX_LENGTH)
    seqs, scores = _gather_rows(seqs, mesh, BATCH), _gather_rows(scores, mesh, BATCH)
    params = {name: value.detach().cpu() for name, value in gather_state_dict(model).items()}
    return DryrunResult(loss, seqs.cpu().numpy(), scores.float().cpu().numpy(), params)
