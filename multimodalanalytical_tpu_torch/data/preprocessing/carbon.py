"""13C-NMR peak-list preprocessor.

Rounded delta(ppm) token strings with optional sum-normalised intensities.
Reference behavior: src/analytical_fm/data/preprocessing/carbon.py:15-88.
Fixed max-length padding for static TPU shapes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..tokenizer import RegexTokenizer, build_regex_tokenizer


class CarbonPreprocessor:
    def __init__(self, intensities: bool = False):
        self.intensities = bool(intensities)
        self.tokenizer: Optional[RegexTokenizer] = None
        self.max_sequence_length: int = 0

    def fit(self, values: Sequence[Optional[List[Dict[str, Any]]]]) -> None:
        processed = self.process_carbon(values)
        self.tokenizer = build_regex_tokenizer(
            processed, regex_string=r"(\s)", tokenizer_behaviour="removed"
        )
        longest = max(processed, key=len)
        self.max_sequence_length = longest.count(" ") + 15

    def __call__(
        self, carbon_nmrs: Sequence[Optional[List[Dict[str, Any]]]]
    ) -> Dict[str, np.ndarray]:
        if self.tokenizer is None:
            raise RuntimeError("CarbonPreprocessor must be fit before use")
        processed = self.process_carbon(carbon_nmrs)
        out = self.tokenizer(
            processed, padding="max_length",
            max_length=self.max_sequence_length, truncation=True,
        )
        no_data = np.array([s == "" for s in processed], dtype=bool)
        out["attention_mask"][no_data] = 0
        return out

    def process_carbon(
        self, carbon_nmrs: Sequence[Optional[List[Dict[str, Any]]]]
    ) -> List[str]:
        processed = []
        for nmr in carbon_nmrs:
            if nmr is None:
                processed.append("")
                continue
            parts: List[str] = []
            if self.intensities:
                intensity_sum = sum(float(p["intensity"]) for p in nmr) or 1.0
            for peak in nmr:
                parts.append(
                    str(round(float(peak["delta (ppm)"]), 1))
                    if "delta (ppm)" in peak else "blah"
                )
                if self.intensities:
                    parts.append(str(round(float(peak["intensity"]) / intensity_sum, 1)))
            processed.append(" ".join(parts))
        return processed

    def state_dict(self) -> Dict[str, Any]:
        return {
            "type": "carbon",
            "intensities": self.intensities,
            "max_sequence_length": self.max_sequence_length,
            "tokenizer": self.tokenizer.to_json() if self.tokenizer else None,
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "CarbonPreprocessor":
        obj = cls(state["intensities"])
        obj.max_sequence_length = state["max_sequence_length"]
        if state.get("tokenizer"):
            obj.tokenizer = RegexTokenizer.from_json(state["tokenizer"])
        return obj
