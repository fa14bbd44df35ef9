"""Text-spectrum preprocessor family.

Encodes a continuous spectrum (optionally with the molecular formula) as a
token sequence. Reference behavior:
src/analytical_fm/data/preprocessing/text_spectrum.py:22-586.

X-axis modes: ``whole_spectrum`` / ``window`` / ``variance`` /
``run_length_encoding`` / ``threshold`` / ``no_action``.
Y-axis modes: ``integer`` bucketing / ``frequency_based_clustering`` (quantile
bins) / ``k_means_clustering`` / ``density_based_clustering`` /
``numerical_encoding`` (XVal [NUM] tokens + float vector).

Deviations from the reference (documented):
  * k-means / density cluster models serialize as plain center arrays and
    predict by nearest center (k-means semantics identical; the reference's
    OPTICS ``predict`` call does not exist on sklearn OPTICS and would crash —
    here density mode derives centers from the OPTICS labels and assigns by
    nearest center).
"""

from __future__ import annotations

import itertools
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...configuration import DEFAULT_SETTINGS
from ..tokenizer import RegexTokenizer, build_regex_tokenizer


def _interp(new_x: np.ndarray, old_x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return np.interp(new_x, old_x, y)


class TextSpectrumPreprocessor:
    def __init__(
        self,
        spectrum_tokens_x: int = 400,
        spectrum_tokens_y: int = 100,
        formula_regex: str = r"([A-Z]{1}[a-z]?[0-9]*)",
        spectrum_to_text_x: str = "whole_spectrum",
        spectrum_to_text_y: str = "integer",
        modality_type: str = "ir",
        spectra_only: bool = False,
        spectra_column: str = "",
        formula_column: str = "",
        numerical_encoding_strength: int = 10,
    ):
        self.spectrum_tokens_x = int(spectrum_tokens_x)
        self.spectrum_tokens_y = int(spectrum_tokens_y)
        self.formula_regex = formula_regex
        self.spectrum_to_text_x = spectrum_to_text_x
        self.spectrum_to_text_y = spectrum_to_text_y
        self.modality_type = modality_type
        self.spectra_only = bool(spectra_only)
        self.spectra_column = spectra_column
        self.formula_column = formula_column
        self.numerical_encoding_strength = int(numerical_encoding_strength)

        self.tokenizer: Optional[RegexTokenizer] = None
        self.max_sequence_length: int = 0
        self.processing_parameters: Dict[str, Any] = {}

    # ------------------------------------------------------------------ fit
    def fit(
        self,
        spectra: Sequence[Sequence[float]],
        formulae: Optional[Sequence[str]] = None,
    ) -> None:
        spectra_arr = np.asarray(spectra, dtype=np.float64)
        self.processing_parameters = {}
        self._init_x(spectra_arr)
        processed_x, _ = self.process_spectra_x(spectra_arr)
        self._init_y(processed_x)

        processed, _ = self.process_spectra(spectra_arr)
        combined = self._combine(processed, formulae)
        self.tokenizer = build_regex_tokenizer(
            combined, regex_string=r"(\s)", tokenizer_behaviour="removed"
        )
        longest = max(combined, key=len)
        self.max_sequence_length = longest.count(" ") + 10

    # ------------------------------------------------------------ transform
    def __call__(
        self,
        spectra: Sequence[Sequence[float]],
        formulae: Optional[Sequence[str]] = None,
    ) -> Dict[str, np.ndarray]:
        if self.tokenizer is None:
            raise RuntimeError("TextSpectrumPreprocessor must be fit before use")
        spectra_arr = np.asarray(spectra, dtype=np.float64)
        processed, _ = self.process_spectra(spectra_arr)
        combined = self._combine(processed, formulae)
        out = self.tokenizer(
            combined, padding="max_length",
            max_length=self.max_sequence_length, truncation=True,
        )
        if self.spectrum_to_text_y == "numerical_encoding":
            processed_formulae = (
                [] if self.spectra_only else self.process_formulae(formulae or [])
            )
            out["numerical_values"] = self._numerical_values(
                spectra_arr, processed_formulae, out["input_ids"].shape[1]
            )
        return out

    def _combine(
        self, processed_spectra: List[str], formulae: Optional[Sequence[str]]
    ) -> List[str]:
        if self.spectra_only:
            return processed_spectra
        if formulae is None:
            raise ValueError("formulae is None.")
        processed_formulae = self.process_formulae(formulae)
        return [f"{f} {s}" for f, s in zip(processed_formulae, processed_spectra)]

    def process_formulae(self, formulae: Sequence[str]) -> List[str]:
        """C6H12O6 -> "C6 H12 O6" (reference text_spectrum.py:134-143)."""
        out = []
        for formula in formulae:
            pieces = [p for p in re.split(self.formula_regex, formula) if p]
            out.append(" ".join(pieces))
        return out

    # ------------------------------------------------------------- X axis
    def _init_x(self, spectra: np.ndarray) -> None:
        if self.spectrum_to_text_x == "variance":
            variance = spectra.var(0)
            top = np.sort(np.argsort(variance)[-self.spectrum_tokens_x:])
            self.processing_parameters["variance"] = {"top_variance_index": top.tolist()}

    def process_spectra(self, spectra: np.ndarray) -> Tuple[List[str], List[np.ndarray]]:
        processed_x, indices = self.process_spectra_x(spectra)
        return self.process_spectra_y(processed_x), indices

    def process_spectra_x(
        self, spectra: np.ndarray
    ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        out, indices = [], []
        for spectrum in np.asarray(spectra, dtype=np.float64):
            if self.spectrum_to_text_x == "no_action":
                processed = spectrum
            elif self.spectrum_to_text_x == "whole_spectrum":
                processed = self._x_fixed(spectrum, "whole")
            elif self.spectrum_to_text_x == "window":
                processed = self._x_fixed(spectrum, "merged")
            elif self.spectrum_to_text_x == "variance":
                idx = self.processing_parameters["variance"]["top_variance_index"]
                processed = spectrum[np.asarray(idx)]
            elif self.spectrum_to_text_x == "run_length_encoding":
                processed = self._x_fixed(spectrum, "run_length_encoding")
            elif self.spectrum_to_text_x == "threshold" and isinstance(
                self, PeakPositionalEncodingPreprocessor
            ):
                processed, index = self._x_threshold(spectrum)
                indices.append(index)
            else:
                raise ValueError(
                    f"Processing {self.spectrum_to_text_x} not implemented."
                )
            out.append(processed)
        return out, indices

    def _x_fixed(self, spectrum: np.ndarray, x_window: str) -> np.ndarray:
        orig_x = np.arange(0, len(spectrum), dtype=np.float64)
        if x_window == "whole":
            new_x = np.linspace(0, len(spectrum) - 2, self.spectrum_tokens_x)
        elif x_window == "merged":
            orig_x = np.arange(0, 3980, 2, dtype=np.float64)
            resolution = (2000 - 400 + 500) / self.spectrum_tokens_x
            new_x = np.concatenate([
                np.arange(400, 2000, resolution),
                np.arange(2800, 3300 - resolution, resolution),
            ])
        elif x_window == "run_length_encoding":
            new_x = np.linspace(0, len(spectrum) - 2, self.spectrum_tokens_x * 2)
        else:
            raise ValueError(f"Invalid option: {x_window}")
        return _interp(new_x, orig_x, spectrum)

    def _x_threshold(self, spectrum: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Peak picking by median/quantile threshold
        (reference text_spectrum.py:256-291)."""
        if self.modality_type == "ir":
            orig_x = np.arange(400, 3982, 2, dtype=np.float64)
            new_x = np.linspace(400, 3980, 2 * self.spectrum_tokens_x)
            intp = _interp(new_x, orig_x, spectrum)
            median = np.median(intp)
            mask = intp > median
            return intp[mask], np.argwhere(mask).flatten()
        if self.modality_type in ("nmr", "sc", "weather"):
            quantile = 1 - (self.spectrum_tokens_x / spectrum.shape[0])
            threshold = np.quantile(spectrum, quantile)
            mask = spectrum > threshold
            values = spectrum[mask]
            idx = np.argwhere(mask).flatten()
            if len(values) < self.spectrum_tokens_x:
                n_pad = self.spectrum_tokens_x - len(values)
                values = np.concatenate([values, np.zeros(n_pad)])
                idx = np.concatenate([idx, np.arange(len(spectrum), len(spectrum) + n_pad)])
            return values, idx
        raise ValueError(f"Unknown modality type {self.modality_type}")

    # ------------------------------------------------------------- Y axis
    def _init_y(self, spectra: List[np.ndarray]) -> None:
        rng = np.random.default_rng(DEFAULT_SETTINGS.default_seed)
        chosen = rng.choice(
            len(spectra), size=min(len(spectra), DEFAULT_SETTINGS.default_samples),
            replace=False,
        )
        flat = np.concatenate([np.asarray(spectra[i]).ravel() for i in chosen])

        mode = self.spectrum_to_text_y
        if mode in ("integer", "numerical_encoding"):
            return
        if mode == "frequency_based_clustering":
            if self.modality_type in ("nmr", "sc", "weather"):
                flat = np.unique(np.around(flat, 6))
            quantiles = np.linspace(0, 1, self.spectrum_tokens_y + 1)
            bins = np.unique(np.quantile(flat, quantiles))
            labels = [f"freq_{i}" for i in range(1, self.spectrum_tokens_y + 1)]
            self.processing_parameters["frequency"] = {
                "bins": bins.tolist(), "labels": labels,
            }
        elif mode == "k_means_clustering":
            from sklearn.cluster import KMeans

            km = KMeans(n_clusters=100, n_init=5, random_state=DEFAULT_SETTINGS.default_seed)
            km.fit(flat.reshape(-1, 1))
            self.processing_parameters["k_means"] = {
                "centers": km.cluster_centers_.ravel().tolist()
            }
        elif mode == "density_based_clustering":
            from sklearn.cluster import OPTICS

            sub = flat[: min(len(flat), 20000)]
            optics = OPTICS(n_jobs=-1)
            labels = optics.fit_predict(sub.reshape(-1, 1))
            centers = [
                float(sub[labels == lab].mean())
                for lab in np.unique(labels) if lab >= 0
            ] or [float(sub.mean())]
            self.processing_parameters["density"] = {"centers": centers}
        else:
            raise ValueError(f"Invalid option: {mode}")

    def process_spectra_y(self, processed_x: List[np.ndarray]) -> List[str]:
        out = []
        for spectrum in processed_x:
            mode = self.spectrum_to_text_y
            if mode == "integer":
                tokens = self._y_integer(spectrum)
            elif mode == "frequency_based_clustering":
                tokens = self._y_frequency(spectrum)
            elif mode == "k_means_clustering":
                tokens = self._y_nearest_center(spectrum, "k_means")
            elif mode == "density_based_clustering":
                tokens = self._y_nearest_center(spectrum, "density")
            elif mode == "numerical_encoding":
                tokens = np.full(spectrum.shape, "[NUM]")
            else:
                raise ValueError(f"Processing {mode} not implemented.")
            out.append(" ".join(np.asarray(tokens).astype(str)))
        return out

    def _y_integer(self, spectrum: np.ndarray) -> np.ndarray:
        peak = spectrum.max()
        normalised = spectrum / (peak if peak else 1.0) * self.spectrum_tokens_y
        return np.clip(np.rint(normalised), 0, self.spectrum_tokens_y).astype(int)

    def _y_frequency(self, spectrum: np.ndarray) -> np.ndarray:
        params = self.processing_parameters["frequency"]
        bins = np.asarray(params["bins"])
        clipped = np.clip(spectrum, bins[0] + 1e-7, bins[-1] - 1e-7)
        idx = np.digitize(clipped, bins)
        return np.asarray([params["labels"][i - 1] for i in idx])

    def _y_nearest_center(self, spectrum: np.ndarray, key: str) -> np.ndarray:
        centers = np.asarray(self.processing_parameters[key]["centers"])
        return np.abs(spectrum[:, None] - centers[None, :]).argmin(-1)

    # -------------------------------------------------- numerical values
    def _numerical_values(
        self,
        spectra: np.ndarray,
        processed_formulae: List[str],
        seq_len: int,
    ) -> np.ndarray:
        """XVal parallel float vector: 1.0 for BOS/formula/pad slots, scaled
        spectrum elsewhere (reference text_spectrum.py:370-415)."""
        processed_x, _ = self.process_spectra_x(spectra)
        stacked = np.vstack(processed_x)
        stacked = stacked / np.max(stacked, -1, keepdims=True) * self.numerical_encoding_strength

        out = np.ones((stacked.shape[0], seq_len), dtype=np.float32)
        for i in range(stacked.shape[0]):
            if not self.spectra_only and processed_formulae:
                start = 1 + processed_formulae[i].count(" ") + 1
            else:
                start = 1
            n = min(stacked.shape[1], seq_len - start)
            out[i, start : start + n] = stacked[i, :n]
        return out

    # ------------------------------------------------------ serialization
    def _base_state(self) -> Dict[str, Any]:
        return {
            "spectrum_tokens_x": self.spectrum_tokens_x,
            "spectrum_tokens_y": self.spectrum_tokens_y,
            "formula_regex": self.formula_regex,
            "spectrum_to_text_x": self.spectrum_to_text_x,
            "spectrum_to_text_y": self.spectrum_to_text_y,
            "modality_type": self.modality_type,
            "spectra_only": self.spectra_only,
            "spectra_column": self.spectra_column,
            "formula_column": self.formula_column,
            "numerical_encoding_strength": self.numerical_encoding_strength,
            "max_sequence_length": self.max_sequence_length,
            "processing_parameters": self.processing_parameters,
            "tokenizer": self.tokenizer.to_json() if self.tokenizer else None,
        }

    def state_dict(self) -> Dict[str, Any]:
        return {"type": "text_spectrum", **self._base_state()}

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "TextSpectrumPreprocessor":
        obj = cls(
            spectrum_tokens_x=state["spectrum_tokens_x"],
            spectrum_tokens_y=state["spectrum_tokens_y"],
            formula_regex=state["formula_regex"],
            spectrum_to_text_x=state["spectrum_to_text_x"],
            spectrum_to_text_y=state["spectrum_to_text_y"],
            modality_type=state["modality_type"],
            spectra_only=state["spectra_only"],
            spectra_column=state["spectra_column"],
            formula_column=state["formula_column"],
            numerical_encoding_strength=state["numerical_encoding_strength"],
        )
        obj.max_sequence_length = state["max_sequence_length"]
        obj.processing_parameters = state["processing_parameters"]
        if state.get("tokenizer"):
            obj.tokenizer = RegexTokenizer.from_json(state["tokenizer"])
        return obj


class RunLengthEncodingPreprocessor(TextSpectrumPreprocessor):
    """Value + run-length token pairs over the bucketed spectrum
    (reference text_spectrum.py:418-484)."""

    def fit(self, spectra, formulae=None) -> None:  # noqa: ARG002
        if self.spectrum_to_text_x not in (
            "run_length_encoding", "no_action", "whole_spectrum",
        ):
            raise ValueError(
                "Expected spectrum_to_text_x in "
                "['run_length_encoding', 'no_action', 'whole_spectrum']"
            )
        if self.spectrum_to_text_y not in ("integer", "frequency_based_clustering"):
            raise ValueError(
                f"Option {self.spectrum_to_text_y} not available for RLE."
            )
        spectra_arr = np.asarray(spectra, dtype=np.float64)
        self.processing_parameters = {}
        processed_x, _ = self.process_spectra_x(spectra_arr)
        self._init_y(processed_x)

        processed, _ = self.process_spectra(spectra_arr)
        rle = self.get_run_length_encoding(processed)
        self.tokenizer = build_regex_tokenizer(
            rle, regex_string=r"(\s)", tokenizer_behaviour="removed"
        )
        longest = max(rle, key=len)
        self.max_sequence_length = min(4090, longest.count(" ") + 10)

    def __call__(self, spectra, formulae=None) -> Dict[str, np.ndarray]:  # noqa: ARG002
        if self.tokenizer is None:
            raise RuntimeError("RunLengthEncodingPreprocessor must be fit before use")
        spectra_arr = np.asarray(spectra, dtype=np.float64)
        processed, _ = self.process_spectra(spectra_arr)
        rle = self.get_run_length_encoding(processed)
        return self.tokenizer(
            rle, padding="max_length",
            max_length=self.max_sequence_length, truncation=True,
        )

    @staticmethod
    def get_run_length_encoding(spectra: List[str]) -> List[str]:
        out = []
        for spectrum in spectra:
            runs = [(k, sum(1 for _ in g)) for k, g in itertools.groupby(spectrum.split(" "))]
            out.append(" ".join(f"{value} {n}" for value, n in runs))
        return out

    def state_dict(self) -> Dict[str, Any]:
        return {"type": "run_length_encoding", **self._base_state()}


class PeakPositionalEncodingPreprocessor(TextSpectrumPreprocessor):
    """Peak-picked tokens plus true spectral positions for positional
    encodings (reference text_spectrum.py:487-586)."""

    def fit(self, spectra, formulae=None) -> None:  # noqa: ARG002
        if self.spectrum_to_text_x not in ("variance", "threshold"):
            raise ValueError(
                f"Option {self.spectrum_to_text_x} not available for "
                "Peak Positional Encoding."
            )
        spectra_arr = np.asarray(spectra, dtype=np.float64)
        self.processing_parameters = {}
        self._init_x(spectra_arr)
        processed_x, _ = self.process_spectra_x(spectra_arr)
        self._init_y(processed_x)

        processed, _ = self.process_spectra(spectra_arr)
        self.tokenizer = build_regex_tokenizer(
            processed, regex_string=r"(\s)", tokenizer_behaviour="removed"
        )
        longest = max(processed, key=len)
        self.max_sequence_length = longest.count(" ") + 30

    def __call__(self, spectra, formulae=None) -> Dict[str, np.ndarray]:  # noqa: ARG002
        if self.tokenizer is None:
            raise RuntimeError(
                "PeakPositionalEncodingPreprocessor must be fit before use"
            )
        spectra_arr = np.asarray(spectra, dtype=np.float64)
        processed, indices = self.process_spectra(spectra_arr)
        out = self.tokenizer(
            processed, padding="max_length",
            max_length=self.max_sequence_length, truncation=True,
        )

        seq_len = out["input_ids"].shape[1]
        if self.spectrum_to_text_x == "threshold":
            max_spectra_len = (
                2 * self.spectrum_tokens_x
                if self.modality_type == "ir" else spectra_arr.shape[1]
            )
            rows = []
            for row in indices:
                row = np.asarray(row) + 1
                tail = np.arange(max_spectra_len + 1, max_spectra_len + (seq_len - len(row)))
                rows.append(np.concatenate([[0], row, tail])[:seq_len])
            token_indices = np.stack(rows).astype(np.int32)
        else:  # variance
            base = list(self.processing_parameters["variance"]["top_variance_index"])
            base.insert(0, min(base) - 1)
            end = list(range(max(base) + 1, max(base) + (seq_len - len(base)) + 1))
            full = np.asarray((base + end)[:seq_len], dtype=np.int32)
            token_indices = np.repeat(full[None, :], spectra_arr.shape[0], axis=0)

        out["indices"] = token_indices
        if self.spectrum_to_text_y == "numerical_encoding":
            out["numerical_values"] = self._numerical_values(
                spectra_arr, ["" for _ in range(spectra_arr.shape[0])], seq_len
            )
        return out

    def state_dict(self) -> Dict[str, Any]:
        return {"type": "peak_positional_encoding", **self._base_state()}
