"""One-hot class label preprocessor (reference: data/preprocessing/onehot.py)."""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Any, Dict, List

import numpy as np


class OneHotPreprocessor:
    def __init__(self, feature_path: str):
        self.feature_path = feature_path
        classes: List[str] = []
        with Path(feature_path).open() as f:
            reader = csv.DictReader(f)
            for row in reader:
                classes.append(row["Classes"])
        self.classes = {value: i for i, value in enumerate(classes)}
        self.n_features = len(self.classes)

    def fit(self, values) -> None:  # noqa: ARG002 - stateless
        pass

    def __call__(self, features: List[str]) -> np.ndarray:
        labels = [self.classes[f] for f in features]
        one_hot = np.zeros((len(features), len(self.classes)), dtype=np.float32)
        one_hot[np.arange(len(features)), labels] = 1
        return one_hot

    def state_dict(self) -> Dict[str, Any]:
        return {
            "type": "class_one_hot",
            "feature_path": self.feature_path,
            "classes": self.classes,
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "OneHotPreprocessor":
        obj = cls.__new__(cls)
        obj.feature_path = state["feature_path"]
        obj.classes = state["classes"]
        obj.n_features = len(obj.classes)
        return obj
