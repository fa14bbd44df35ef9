"""The modality types whose encoder input is a row of token ids.

``TEXT_LIKE_TYPES`` is letter for letter the program's list
(``models/embedding.py``, held equal by a test), kept here so that the
traffic maker and the reference, which imports nothing of the program, read
one list. The program embeds each such modality by its own token table and
LayerNorm. Where the collator sends only ids, tail-padded with 0, they sit
at the positions that follow the modality before them. It sends more for
two kinds: peak positional encoding always sends the peaks' own positions
(``token_indices``), and a preprocessor argument ``numerical_encoding``
(multiplets' ``encoding``, a text spectrum's ``spectrum_to_text_y``) sends
XVal values that scale the embedding. :func:`require_plain_ids` refuses
those, so that neither the traffic nor the reference makes an input that
the program would not receive.
"""

from __future__ import annotations

from typing import Any, Dict

TEXT_LIKE_TYPES = (
    "text", "text_spectrum", "peak_positional_encoding",
    "run_length_encoding", "multiplets", "carbon", "msms_text",
)


def require_plain_ids(modality: str, spec: Dict[str, Any]) -> None:
    """Raise ValueError unless the collator sends ``modality`` (its data
    config ``spec``) as plain ids at sequential positions."""
    if spec["type"] == "peak_positional_encoding":
        raise ValueError(f"modality {modality!r}: peak positional encoding sends its own "
                         "positions, which neither the traffic nor the reference makes")
    args = spec.get("preprocessor_arguments") or {}
    if "numerical_encoding" in args.values():
        raise ValueError(f"modality {modality!r}: numerical_encoding sends XVal values, "
                         "which neither the traffic nor the reference makes")
