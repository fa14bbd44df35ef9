"""Regex WordLevel tokenizer.

Same tokenization scheme as the reference (reference: data/tokenizer.py:5-46):
a WordLevel vocab trained from an iterator with a regex pre-tokenizer,
specials ``<pad> <unk> <bos> <eos>`` and bos/eos template post-processing.

Differences (TPU-first): wraps the Rust ``tokenizers.Tokenizer`` directly and
returns numpy arrays (no torch / transformers slow wrapper in the hot path),
and serializes to JSON (no pickle) for the preprocessor artifact.
``tokenizers`` is imported where a tokenizer is built or loaded, so that
the collator and the preprocessors import on a machine without it (where
a stand-in with this class's interface takes the tokenizer's place).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

if TYPE_CHECKING:
    from tokenizers import Tokenizer

PAD, UNK, BOS, EOS = "<pad>", "<unk>", "<bos>", "<eos>"


class RegexTokenizer:
    """WordLevel tokenizer with numpy batch outputs and JSON round-tripping."""

    def __init__(self, tokenizer: Tokenizer, model_max_length: int = 512):
        self._tok = tokenizer
        self.model_max_length = model_max_length
        self.pad_token_id = tokenizer.token_to_id(PAD)
        self.unk_token_id = tokenizer.token_to_id(UNK)
        self.bos_token_id = tokenizer.token_to_id(BOS)
        self.eos_token_id = tokenizer.token_to_id(EOS)
        self.pad_token, self.unk_token = PAD, UNK
        self.bos_token, self.eos_token = BOS, EOS

    # -- vocab ------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    @property
    def vocab(self) -> Dict[str, int]:
        return self._tok.get_vocab()

    # -- encoding ---------------------------------------------------------
    def __call__(
        self,
        text: Union[str, Sequence[str]],
        padding: Union[bool, str] = True,
        max_length: Optional[int] = None,
        truncation: bool = False,
        return_tensors: Optional[str] = None,  # accepted for API parity; numpy always
    ) -> Dict[str, np.ndarray]:
        del return_tensors
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        encodings = self._tok.encode_batch(texts)

        ids = [e.ids for e in encodings]
        if truncation and max_length is not None:
            # HF fast tokenizers reserve space for the post-processor's
            # special tokens BEFORE truncating, so an over-long sequence
            # still ends with <eos>; a plain tail cut dropped it (caught by
            # the reference-collator parity golden).
            def trunc(row):
                if len(row) <= max_length:
                    return row
                keep = row[:max_length]
                if row[-1] == self.eos_token_id:
                    keep = keep[:-1] + [self.eos_token_id]
                return keep

            ids = [trunc(row) for row in ids]

        if padding == "max_length" and max_length is not None:
            width = max_length
        elif padding in (True, "longest"):
            width = max((len(row) for row in ids), default=0)
        else:
            if single:
                return {
                    "input_ids": np.asarray(ids[0], dtype=np.int32),
                    "attention_mask": np.ones(len(ids[0]), dtype=np.int32),
                }
            width = max((len(row) for row in ids), default=0)

        batch = np.full((len(ids), width), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(ids), width), dtype=np.int32)
        for i, row in enumerate(ids):
            n = min(len(row), width)
            batch[i, :n] = row[:n]
            mask[i, :n] = 1
        if single:
            return {"input_ids": batch[0], "attention_mask": mask[0]}
        return {"input_ids": batch, "attention_mask": mask}

    def encode_lengths(self, texts: Sequence[str]) -> List[int]:
        """Unpadded token lengths (used for max-length fitting)."""
        return [len(e.ids) for e in self._tok.encode_batch(list(texts))]

    # -- decoding ---------------------------------------------------------
    def batch_decode(
        self, ids: Union[np.ndarray, Sequence[Sequence[int]]], skip_special_tokens: bool = True
    ) -> List[str]:
        arr = np.asarray(ids)
        if arr.ndim == 1:
            arr = arr[None, :]
        # WordLevel decode joins tokens with spaces (matches reference behavior
        # through PreTrainedTokenizerFast, where SMILES come back spaced).
        specials = {self.pad_token_id, self.bos_token_id, self.eos_token_id}
        id_to_token = {v: k for k, v in self._tok.get_vocab().items()}
        out = []
        for row in arr.tolist():
            tokens = []
            for token_id in row:
                if token_id < 0:
                    continue
                if skip_special_tokens and token_id in specials:
                    continue
                tokens.append(id_to_token.get(int(token_id), UNK))
            out.append(" ".join(tokens))
        return out

    # -- serialization ----------------------------------------------------
    def to_json(self) -> Dict[str, object]:
        return {"tokenizer": self._tok.to_str(), "model_max_length": self.model_max_length}

    @classmethod
    def from_json(cls, payload: Dict[str, object]) -> "RegexTokenizer":
        from tokenizers import Tokenizer

        tok = Tokenizer.from_str(str(payload["tokenizer"]))
        return cls(tok, int(payload["model_max_length"]))  # type: ignore[arg-type]


def build_regex_tokenizer(
    feature: Iterable[str],
    regex_string: str,
    tokenizer_behaviour: str = "isolated",
    max_vocab_size: int = 10000,
    max_length: int = 512,
) -> RegexTokenizer:
    """Train a WordLevel tokenizer from an iterator (reference tokenizer.py:5-46)."""
    from tokenizers import Regex, Tokenizer, models, pre_tokenizers, processors, trainers

    tok = Tokenizer(models.WordLevel(unk_token=UNK))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(pattern=Regex(regex_string), behavior=tokenizer_behaviour)
    ])

    trainer = trainers.WordLevelTrainer(
        vocab_size=max_vocab_size, special_tokens=[PAD, UNK, BOS, EOS]
    )
    tok.train_from_iterator(feature, trainer=trainer)

    bos_id, eos_id = tok.token_to_id(BOS), tok.token_to_id(EOS)
    tok.post_processor = processors.TemplateProcessing(
        single=f"{BOS}:0 $A:0 {EOS}:0",
        special_tokens=[(BOS, bos_id), (EOS, eos_id)],
    )
    return RegexTokenizer(tok, model_max_length=max_length)
