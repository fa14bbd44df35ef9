"""Fixed-vocabulary stand-ins for the recipe's fitted regex tokenizers.

The program's ``data/tokenizer.py`` builds its tokenizers with the
``tokenizers`` package, which the card's machine lacks. These stand-ins
have the same special tokens and ids (pad 0, unk 1, bos 2, eos 3), the
same padded and truncated rows from ``__call__`` (BOS, tokens, EOS) and the
same ``batch_decode`` output (tokens joined by spaces, specials skipped).
The vocabulary is the regex's tokens of a small corpus, then fillers up to
the recipe's vocabulary size.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

import numpy as np

SMILES_CORPUS = [
    "CCO", "CC(=O)O", "c1ccccc1", "c1ccccc1O", "CC(C)O", "CCN(CC)CC", "O=C(O)c1ccccc1",
    "CC(=O)Nc1ccc(O)cc1", "COc1ccccc1", "CCOC(C)=O", "C1CCCCC1", "CC#N", "ClCCl",
    "Cc1ccccc1", "NCCO", "O=Cc1ccccc1", "CCCCBr", "c1ccncc1", "CC(C)(C)O", "OCC(O)CO",
]
# The molecular formulas of SMILES_CORPUS, in its order.
FORMULA_CORPUS = [
    "C2H6O", "C2H4O2", "C6H6", "C6H6O", "C3H8O", "C6H15N", "C7H6O2", "C8H9NO2", "C7H8O",
    "C4H8O2", "C6H12", "C2H3N", "CH2Cl2", "C7H8", "C2H7NO", "C7H6O", "C4H9Br", "C5H5N",
    "C4H10O", "C3H8O3",
]
SMILES_REGEX = (r"(\[[^\]]+]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p|\(|\)|\.|=|#|-|\+|\\|\/|:"
                r"|~|@|\?|>|\*|\$|\%[0-9]{2}|[0-9])")
SMILES_EXTRA_TOKENS = ("S", "P", "F", "I", "n", "o", "s", "[nH]", "=", "#", "(", ")")
FORMULA_REGEX = r"([A-Z]{1}[a-z]?[0-9]*)"
SPECIALS = ("<pad>", "<unk>", "<bos>", "<eos>")
PAD_ID, UNK_ID, BOS_ID, EOS_ID = 0, 1, 2, 3


class FixedVocabTokenizer:
    """A regex tokenizer over a fixed vocabulary of ``vocab_size`` ids."""

    def __init__(self, regex: str, corpus: Sequence[str], extra: Sequence[str],
                 vocab_size: int):
        self.regex = re.compile(regex)
        atoms = sorted({t for s in corpus for t in self.regex.findall(s)})
        atoms += [t for t in extra if t not in atoms]
        self.atoms = atoms
        tokens = list(SPECIALS) + atoms
        self.tokens = tokens + [f"<x{i}>" for i in range(vocab_size - len(tokens))]
        self.ids: Dict[str, int] = {t: i for i, t in enumerate(self.tokens)}
        self.pad_token_id, self.bos_token_id, self.eos_token_id = PAD_ID, BOS_ID, EOS_ID
        self.vocab_size = vocab_size

    def __call__(self, texts, padding: str = "max_length", max_length: int = 0,
                 truncation: bool = True) -> dict:
        """Rows of BOS, tokens, EOS padded to ``max_length``; a longer row
        keeps its EOS."""
        rows = [[BOS_ID] + self.encode(t) + [EOS_ID] for t in texts]
        rows = [r if len(r) <= max_length else r[:max_length - 1] + [EOS_ID] for r in rows]
        ids = np.zeros((len(rows), max_length), np.int32)
        mask = np.zeros((len(rows), max_length), np.int32)
        for i, row in enumerate(rows):
            ids[i, :len(row)], mask[i, :len(row)] = row, 1
        return {"input_ids": ids, "attention_mask": mask}

    def encode(self, text: str) -> List[int]:
        return [self.ids[t] for t in self.regex.findall(text)]

    def batch_decode(self, ids, skip_special_tokens: bool = True) -> List[str]:
        specials = {PAD_ID, BOS_ID, EOS_ID}
        return [" ".join(self.tokens[int(i)] for i in row
                         if not (skip_special_tokens and int(i) in specials))
                for row in ids]

    def ids_of_decoded(self, text: str) -> List[int]:
        """The ids of a ``batch_decode`` string: exact wherever the decoded
        row held no pad or BOS id before its EOS (the benchmark's weights
        rule both out)."""
        return [self.ids[t] for t in text.split(" ")] if text else []


def smiles_tokenizer(vocab_size: int) -> FixedVocabTokenizer:
    return FixedVocabTokenizer(SMILES_REGEX, SMILES_CORPUS, SMILES_EXTRA_TOKENS, vocab_size)


def formula_tokenizer(vocab_size: int) -> FixedVocabTokenizer:
    return FixedVocabTokenizer(FORMULA_REGEX, FORMULA_CORPUS, (), vocab_size)
