"""z-score normalisation for continuous vector targets
(reference: data/preprocessing/normalization.py)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


class NormalisePreprocessor:
    def __init__(self) -> None:
        self.mean: float = 0.0
        self.std: float = 1.0
        self.n_features: int = 1

    def fit(self, values) -> None:
        data = np.asarray(values, dtype=np.float64)
        self.mean = float(data.mean())
        self.std = float(data.std())
        self.n_features = int(data.shape[-1]) if data.ndim > 1 else 1

    def normalise(self, data: np.ndarray) -> np.ndarray:
        return (np.asarray(data) - self.mean) / self.std

    def denormalise(self, data: np.ndarray) -> np.ndarray:
        return np.asarray(data) * self.std + self.mean

    def __call__(self, data: np.ndarray) -> np.ndarray:
        return self.normalise(data)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "type": "normalise",
            "mean": self.mean,
            "std": self.std,
            "n_features": self.n_features,
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "NormalisePreprocessor":
        obj = cls()
        obj.mean = state["mean"]
        obj.std = state["std"]
        obj.n_features = state["n_features"]
        return obj
