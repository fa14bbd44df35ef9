"""1H-NMR multiplet preprocessor.

Converts per-molecule peak-dict lists into token strings (and optionally
XVal-style numerical-value vectors). Reference behavior:
src/analytical_fm/data/preprocessing/multiplets.py:16-230.

Encodings:
  * ``text``:      "1HNMR rangeMax rangeMin category nH | ..."
  * ``centroid``:  "1HNMR centroid category nH | ..."
  * ``numerical_encoding``: "[NUM] [NUM] category nH" tokens with a parallel
    float vector multiplied into the embeddings (XVal).

TPU note: the reference pads to the per-batch longest sequence
(multiplets.py:76); here every batch is padded to the fit-time
``max_sequence_length`` so shapes are static under jit. Masking makes the two
numerically identical.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..tokenizer import RegexTokenizer, build_regex_tokenizer


class MultipletPreprocessor:
    def __init__(self, encoding: str = "text", j_values: bool = False, normalise: bool = False):
        if encoding not in ("text", "centroid", "numerical_encoding"):
            raise ValueError(f"Unknown encoding type {encoding}")
        self.encoding = encoding
        self.j_values = bool(j_values)
        self.normalise = bool(normalise)

        self.tokenizer: Optional[RegexTokenizer] = None
        self.max_sequence_length: int = 0
        self.normalisation_factors: Optional[Dict[str, float]] = None

    # -- fitting ----------------------------------------------------------
    def fit(self, values: Sequence[Optional[List[Dict[str, Any]]]]) -> None:
        processed, numerical = self.process_multiplets(values, initialise=True)
        self.tokenizer = build_regex_tokenizer(
            processed, regex_string=r"(\s)", tokenizer_behaviour="removed"
        )
        longest = max(processed, key=len)
        self.max_sequence_length = longest.count(" ") + 30

        if self.normalise:
            tokenized = self.tokenizer(
                processed, padding="max_length",
                max_length=self.max_sequence_length, truncation=True,
            )
            padded = self._pad_numerical(tokenized["input_ids"].shape[1], numerical)
            flat = padded.reshape(-1)
            flat = flat[flat != 1]
            self.normalisation_factors = {
                "mean": float(flat.mean()) if flat.size else 0.0,
                "std": float(flat.std()) if flat.size else 1.0,
            }

    # -- transform --------------------------------------------------------
    def __call__(
        self, multiplets: Sequence[Optional[List[Dict[str, Any]]]]
    ) -> Dict[str, np.ndarray]:
        if self.tokenizer is None:
            raise RuntimeError("MultipletPreprocessor must be fit before use")
        processed, numerical = self.process_multiplets(multiplets)
        out = self.tokenizer(
            processed, padding="max_length",
            max_length=self.max_sequence_length, truncation=True,
        )
        if self.encoding == "numerical_encoding":
            out["numerical_values"] = self._pad_numerical(
                out["input_ids"].shape[1], numerical
            ).astype(np.float32)

        # Multitask: None rows fully masked (reference multiplets.py:91-94).
        no_data = np.array([s == "" for s in processed], dtype=bool)
        out["attention_mask"][no_data] = 0
        return out

    def process_multiplets(
        self,
        multiplets: Sequence[Optional[List[Dict[str, Any]]]],
        initialise: bool = False,
    ) -> Tuple[List[str], List[np.ndarray]]:
        strings, vectors = [], []
        for multiplet in multiplets:
            s, v = self._process_one(multiplet, initialise)
            strings.append(s)
            vectors.append(v)
        return strings, vectors

    def _normalise_float(self, value: float) -> float:
        if self.normalisation_factors is None:
            raise ValueError("Normalisation factors need to be initialised.")
        return (value - self.normalisation_factors["mean"]) / self.normalisation_factors["std"]

    def _process_one(
        self, peaks: Optional[List[Dict[str, Any]]], initialise: bool
    ) -> Tuple[str, np.ndarray]:
        out = "1HNMR "
        numeric: List[float] = [1.0]
        if peaks is None:
            return "", np.asarray(numeric)

        for peak in peaks:
            if self.encoding == "text":
                formatted = "{:.2f} {:.2f} {} {}H ".format(
                    float(peak["rangeMax"]), float(peak["rangeMin"]),
                    peak["category"], peak["nH"],
                )
            elif self.encoding == "centroid":
                formatted = "{:.2f} {} {}H ".format(
                    float(peak["centroid"]), peak["category"], peak["nH"],
                )
            else:  # numerical_encoding
                formatted = "[NUM] [NUM] {} {}H ".format(peak["category"], peak["nH"])
                range_max, range_min = float(peak["rangeMax"]), float(peak["rangeMin"])
                if self.normalise and not initialise:
                    range_max = self._normalise_float(range_max)
                    range_min = self._normalise_float(range_min)
                numeric.extend([range_max, range_min, 1.0, 1.0])

            js = str(peak.get("j_values"))
            if self.j_values and js != "None":
                split_js = [j for j in js.split("_") if j]
                if self.encoding == "text":
                    formatted_js = "J " + " ".join(f"{float(j):.2f}" for j in split_js)
                    formatted += formatted_js
                elif self.encoding == "numerical_encoding":
                    j_floats = [float(j) for j in split_js]
                    formatted += "J " + "[NUM] " * len(j_floats)
                    if self.normalise and not initialise:
                        j_floats = [self._normalise_float(j) for j in j_floats]
                    numeric.extend([1.0] + j_floats)

            out += formatted.strip() + " | "
            if self.encoding == "numerical_encoding":
                numeric.append(1.0)

        out = out[:-3]  # drop trailing separator
        return out, np.asarray(numeric[:-1] if len(numeric) > 1 else numeric)

    def _pad_numerical(
        self, seq_len: int, vectors: List[np.ndarray]
    ) -> np.ndarray:
        """BOS slot = 1.0, vector, then 1.0-padding to seq_len
        (reference multiplets.py:199-230)."""
        out = np.ones((len(vectors), seq_len), dtype=np.float64)
        for i, vec in enumerate(vectors):
            n = min(len(vec), seq_len - 1)
            out[i, 1 : 1 + n] = vec[:n]
        return out

    # -- serialization ----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "type": "multiplets",
            "encoding": self.encoding,
            "j_values": self.j_values,
            "normalise": self.normalise,
            "max_sequence_length": self.max_sequence_length,
            "normalisation_factors": self.normalisation_factors,
            "tokenizer": self.tokenizer.to_json() if self.tokenizer else None,
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "MultipletPreprocessor":
        obj = cls(state["encoding"], state["j_values"], state["normalise"])
        obj.max_sequence_length = state["max_sequence_length"]
        obj.normalisation_factors = state.get("normalisation_factors")
        if state.get("tokenizer"):
            obj.tokenizer = RegexTokenizer.from_json(state["tokenizer"])
        return obj
