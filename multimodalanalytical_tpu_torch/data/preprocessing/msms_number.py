"""MS/MS numerical preprocessor: raw float (m/z, intensity) pairs, z-scored.

Feeds the linear patch embedder with patch_size=2
(reference: src/analytical_fm/data/preprocessing/msms_number.py:13-80,
modeling/utils.py:108-110).

TPU note: the reference pads to the per-batch longest peak count; here the
fit records a fixed ``max_peaks`` so batch shapes are static.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np


class MSMSNumberPreprocessor:
    def __init__(self, normalise: bool = True, encoding_type: str = "linear"):
        self.normalise = bool(normalise)
        self.encoding_type = encoding_type
        self.normalisation_factors: Dict[str, Dict[str, float]] = {}
        self.max_peaks: int = 0
        self.n_features = 2

    def fit(self, values: Sequence[List[List[float]]]) -> None:
        filtered = self.filter_msms_peaks(values)
        flat = np.asarray([peak for spectrum in filtered for peak in spectrum], dtype=np.float64)
        self.normalisation_factors = {
            "mass": {"mean": float(flat[:, 0].mean()), "std": float(flat[:, 0].std())},
            "intensity": {"mean": float(flat[:, 1].mean()), "std": float(flat[:, 1].std())},
        }
        self.max_peaks = max((len(s) for s in filtered), default=1) + 8

    def __call__(self, msms_spectra: Sequence[List[List[float]]]) -> Dict[str, np.ndarray]:
        filtered = self.filter_msms_peaks(msms_spectra)
        batch = np.zeros((len(filtered), self.max_peaks, 2), dtype=np.float32)
        mask = np.zeros((len(filtered), self.max_peaks), dtype=np.int32)
        mass = self.normalisation_factors["mass"]
        inten = self.normalisation_factors["intensity"]
        for i, spectrum in enumerate(filtered):
            n = min(len(spectrum), self.max_peaks)
            if n == 0:
                continue
            arr = np.asarray(spectrum[:n], dtype=np.float64)
            if self.normalise:
                arr[:, 0] = (arr[:, 0] - mass["mean"]) / mass["std"]
                arr[:, 1] = (arr[:, 1] - inten["mean"]) / inten["std"]
            batch[i, :n] = arr
            mask[i, :n] = 1
        return {"input_ids": batch, "attention_mask": mask}

    @staticmethod
    def filter_msms_peaks(
        msms_spectra: Sequence[List[List[float]]],
    ) -> List[List[List[float]]]:
        return [[peak for peak in s if peak[1] >= 1] for s in msms_spectra]

    def state_dict(self) -> Dict[str, Any]:
        return {
            "type": "msms_number",
            "normalise": self.normalise,
            "encoding_type": self.encoding_type,
            "normalisation_factors": self.normalisation_factors,
            "max_peaks": self.max_peaks,
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "MSMSNumberPreprocessor":
        obj = cls(state["normalise"], state.get("encoding_type", "linear"))
        obj.normalisation_factors = state["normalisation_factors"]
        obj.max_peaks = state["max_peaks"]
        return obj
