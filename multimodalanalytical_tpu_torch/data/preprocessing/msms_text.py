"""MS/MS text preprocessor: (m/z, intensity) peak pairs as token strings.

Reference behavior: src/analytical_fm/data/preprocessing/msms_text.py:15-67
(drops peaks with intensity < 1; "mz.x int.x" one-decimal tokens).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from ..tokenizer import RegexTokenizer, build_regex_tokenizer


class MSMSTextPreprocessor:
    def __init__(self) -> None:
        self.tokenizer: Optional[RegexTokenizer] = None
        self.max_sequence_length: int = 0

    def fit(self, values: Sequence[List[List[float]]]) -> None:
        processed = self.process_msms(values)
        longest = max(processed, key=len)
        self.max_sequence_length = longest.count(" ") + 15
        self.tokenizer = build_regex_tokenizer(
            processed, regex_string=r"(\s)", tokenizer_behaviour="removed",
            max_length=self.max_sequence_length,
        )

    def __call__(self, msms_spectra: Sequence[List[List[float]]]):
        if self.tokenizer is None:
            raise RuntimeError("MSMSTextPreprocessor must be fit before use")
        processed = self.process_msms(msms_spectra)
        return self.tokenizer(
            processed, padding="max_length",
            max_length=self.max_sequence_length, truncation=True,
        )

    def process_msms(self, msms_spectra: Sequence[List[List[float]]]) -> List[str]:
        processed = []
        for msms in msms_spectra:
            parts = []
            for peak in msms:
                if peak[1] < 1:
                    continue
                parts.append(f"{round(peak[0], 1):.1f} {round(peak[1], 1):.1f}")
            processed.append(" ".join(parts))
        return processed

    def state_dict(self) -> Dict[str, Any]:
        return {
            "type": "msms_text",
            "max_sequence_length": self.max_sequence_length,
            "tokenizer": self.tokenizer.to_json() if self.tokenizer else None,
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "MSMSTextPreprocessor":
        obj = cls()
        obj.max_sequence_length = state["max_sequence_length"]
        if state.get("tokenizer"):
            obj.tokenizer = RegexTokenizer.from_json(state["tokenizer"])
        return obj
