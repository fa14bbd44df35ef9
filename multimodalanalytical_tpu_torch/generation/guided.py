"""Formula-guided (constrained) decoding (counterpart of ``generation/guided.py``).

The reference's ``GuidedFormulaProcessor`` re-parses every beam at every
decode step. Two modes, as in the JAX package:

``surrogate`` (default, pure tensor code, captured in the decode step's
CUDA graph): three rules from a precomputed per-token atom-count table:

  1. prefix formula == target formula  -> force EOS (score 0),
  2. prefix formula <  target formula  -> ban EOS,
  3. token would overshoot any heavy-atom count -> ban token.

Rules 1-2 cover heavy atoms only (the H column is skipped); rule 3 uses the
reference's token -> atom attribution (substring matching over the vocab,
skipping H, with the C-vs-Cl disambiguation) over the first
``N_LOOKAHEAD`` atoms.

``exact`` (parity mode): rules 1-2 run on the host, one call per step, as
the JAX package's ``io_callback`` does: the live prefixes are copied to the
host, decoded, and their full formulas (implicit H included; an invalid
SMILES counts as all zeros) compared against the target by the chemistry
engine. Rule 3 stays on the device. A step that calls the host cannot be
captured, so the hook says so (``capturable = False``) and the beam search
runs its step eagerly.

Both modes are built once per run; the per-batch target counts ride in the
beam search's hook state (:meth:`GuidedDecoder.state_for`), so one captured
graph serves every batch of a shape.

Hook protocol (see ``beam_search.BeamDecoder.search``): hooks receive
LOG-PROBS, as the HF pipeline's logits processors do after
``log_softmax``, so rule 1's ``score[eos] = 0`` forces EOS.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..chem import GUIDED_ATOM_LIST, atom_counts

# Atoms in the lookahead rule (the reference skips H and checks the first 9).
N_LOOKAHEAD = 9
_H_INDEX = GUIDED_ATOM_LIST.index("H")


def build_token_atom_table(vocab: dict, special_tokens: Sequence[str]) -> np.ndarray:
    """(vocab_size, n_atoms) 0/1 table: does this token add one of atom i."""
    size = max(vocab.values()) + 1
    table = np.zeros((size, len(GUIDED_ATOM_LIST)), dtype=np.int32)
    specials = set(special_tokens)
    for token, token_id in vocab.items():
        if token in specials:
            continue
        for i, atom in enumerate(GUIDED_ATOM_LIST):
            if atom == "H":
                continue
            if atom.lower() in token.lower():
                if atom.lower() == "c" and token.lower() == "cl":
                    continue
                table[token_id, i] = 1
    return table


def target_formula_counts(target_smiles: Sequence[str]) -> np.ndarray:
    """(B, n_atoms) atom counts of the target molecules (incl. H); zeros for
    a target the chemistry engine cannot parse."""
    rows: List[List[int]] = []
    for smiles in target_smiles:
        counts = atom_counts(smiles)
        rows.append(counts if counts is not None else [0] * len(GUIDED_ATOM_LIST))
    return np.asarray(rows, dtype=np.int32).reshape(len(rows), len(GUIDED_ATOM_LIST))


def _prefix_heavy_counts(table: torch.Tensor, live_seqs: torch.Tensor, t) -> torch.Tensor:
    """(B, K, A) heavy-atom counts of each live prefix (positions 1..t)."""
    positions = torch.arange(live_seqs.shape[-1], device=live_seqs.device)
    valid = (positions >= 1) & (positions <= t)
    return (table[live_seqs] * valid[None, None, :, None]).sum(dim=2, dtype=torch.int32)


def _apply_rules(logprobs, counts, target, table, eos_token_id: int,
                 heavy_only: bool) -> torch.Tensor:
    """The three rules on (B, K, V) log-probs. ``counts``: (B, K, A) formula
    counts of the prefixes (heavy-only in surrogate mode, with H in exact
    mode); ``target``: (B, K, A); ``heavy_only``: rules 1-2 ignore H."""
    if heavy_only:
        relevant = torch.arange(table.shape[1], device=counts.device) != _H_INDEX
        matching = torch.where(relevant, counts == target, True).all(dim=-1)
        too_small = torch.where(relevant, counts < target, False).any(dim=-1)
    else:
        matching = (counts == target).all(dim=-1)
        too_small = (counts < target).any(dim=-1)
    eos_col = torch.arange(logprobs.shape[-1], device=logprobs.device) == eos_token_id
    # Rule 1: formula complete -> EOS score 0 (forces EOS: log-probs <= 0).
    logprobs = torch.where(eos_col & matching[:, :, None], 0.0, logprobs)
    # Rule 2: undershooting -> ban EOS.
    logprobs = torch.where(eos_col & too_small[:, :, None], -torch.inf, logprobs)
    # Rule 3: lookahead over the first N_LOOKAHEAD atoms, all heavy.
    next_counts = counts[:, :, None, :N_LOOKAHEAD] + table[None, None, :, :N_LOOKAHEAD]
    too_large = (next_counts > target[:, :, None, :N_LOOKAHEAD]).any(dim=-1)
    return torch.where(too_large, -torch.inf, logprobs)


class _DeviceTable:
    """The token table, copied to each device once, at the first (eager)
    call there: a captured step finds it in place."""

    def __init__(self, token_table: np.ndarray):
        self.host = torch.as_tensor(np.asarray(token_table, dtype=np.int32))
        self._on: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        if device not in self._on:
            self._on[device] = self.host.to(device)
        return self._on[device]


def make_formula_hook(token_table: np.ndarray, eos_token_id: int) -> Callable:
    """Surrogate guided hook, ``hook(state, logprobs, live_seqs, t) ->
    (state, logprobs)``, pure tensor code (``capturable``). ``state`` is
    ``{"target": (B, K, A) int32}``: the per-batch target counts tiled over
    the beams."""
    table = _DeviceTable(token_table)

    def hook(state, logprobs, live_seqs, t):
        on_device = table.on(logprobs.device)
        counts = _prefix_heavy_counts(on_device, live_seqs, t)
        return state, _apply_rules(logprobs, counts, state["target"], on_device,
                                   eos_token_id, heavy_only=True)

    hook.capturable = True
    return hook


def make_exact_formula_hook(token_table: np.ndarray, eos_token_id: int,
                            decode_tokens: Callable[[np.ndarray], List[str]]) -> Callable:
    """Exact (reference-parity) guided hook. ``decode_tokens`` maps an (N, L)
    int array of token ids to N SMILES strings (specials stripped). Each
    step the live prefixes (positions 0..t) are copied to the host and their
    full formulas (implicit H included) drive rules 1-2; rule 3 stays on the
    device. One host call per step, so not ``capturable``: the beam search
    runs its step eagerly."""
    table = _DeviceTable(token_table)
    n_atoms = len(GUIDED_ATOM_LIST)

    def host_counts(live_seqs: torch.Tensor, t: int) -> np.ndarray:
        b, k, length = live_seqs.shape
        prefixes = live_seqs.cpu().numpy().reshape(b * k, length)
        rows = np.zeros((b * k, n_atoms), dtype=np.int32)
        for i, smiles in enumerate(decode_tokens(prefixes[:, : t + 1])):
            counts = atom_counts(smiles)
            if counts is not None:
                rows[i] = counts
        return rows.reshape(b, k, n_atoms)

    def hook(state, logprobs, live_seqs, t):
        counts = torch.as_tensor(host_counts(live_seqs, int(t))).to(logprobs.device)
        return state, _apply_rules(logprobs, counts, state["target"],
                                   table.on(logprobs.device), eos_token_id, heavy_only=False)

    hook.capturable = False
    return hook


class GuidedDecoder:
    """Guided decoding for ``Trainer.predict``: ``hook`` is built once per
    run over static tables, and ``state_for(batch, num_beams, device)``
    gives the per-batch hook state."""

    def __init__(self, tokenizer, mode: str = "surrogate"):
        if mode not in ("surrogate", "exact"):
            raise ValueError(f"unknown guided_generation mode: {mode!r}")
        self.mode = mode
        self.tokenizer = tokenizer
        table = build_token_atom_table(
            tokenizer.vocab,
            [tokenizer.pad_token, tokenizer.unk_token, tokenizer.bos_token,
             tokenizer.eos_token],
        )
        if mode == "surrogate":
            self.hook = make_formula_hook(table, tokenizer.eos_token_id)
        else:
            def decode_tokens(ids: np.ndarray) -> List[str]:
                return tokenizer.batch_decode(ids, skip_special_tokens=True)

            self.hook = make_exact_formula_hook(table, tokenizer.eos_token_id, decode_tokens)

    def state_for(self, batch, num_beams: int, device="cpu") -> Dict[str, torch.Tensor]:
        """{"target": (B, K, A) int32} on ``device`` for this collated batch,
        B its padded size; padding rows and unparseable targets get 10_000
        of every atom, so that no rule fires on them."""
        targets = target_formula_counts(batch["target_strings"])
        padded_b = np.asarray(batch["encoder_mask"]).shape[0]
        if targets.shape[0] < padded_b:
            targets = np.pad(targets, ((0, padded_b - targets.shape[0]), (0, 0)))
        dead = targets.sum(axis=1) == 0
        targets[dead] = 10_000
        tiled = np.repeat(targets[:, None, :], num_beams, axis=1)
        return {"target": torch.as_tensor(tiled, device=device)}


def guided_hook_builder(tokenizer, mode: str = "surrogate") -> GuidedDecoder:
    """The guided-decoding adapter (the JAX package's name)."""
    return GuidedDecoder(tokenizer, mode=mode)
