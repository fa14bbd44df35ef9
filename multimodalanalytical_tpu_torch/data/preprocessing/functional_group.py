"""Functional-group featurizer: SMILES -> binary presence vector.

Reference behavior: src/analytical_fm/data/preprocessing/functional_group.py
+ data_utils.py:132-150 (37 SMARTS patterns matched with RDKit).  Here the
matching runs on the first-party SMARTS subset engine
(:mod:`multimodalanalytical_tpu_torch.chem.smarts`).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ...configuration import DEFAULT_SETTINGS


class FunctionalGroupPreprocessor:
    def __init__(self, group_definitions: str = "default"):
        if group_definitions != "default":
            raise ValueError(f"Unknown func_groups: {group_definitions}")
        self.group_definitions = group_definitions
        self.functional_groups = dict(DEFAULT_SETTINGS.default_func_groups)
        self.n_features = len(self.functional_groups)

    def fit(self, values) -> None:  # noqa: ARG002 - stateless
        pass

    def __call__(self, smiles: List[str]) -> np.ndarray:
        from ...chem.smarts import match_functional_groups

        rows = [
            match_functional_groups(s, list(self.functional_groups.values()))
            for s in smiles
        ]
        return np.vstack(rows).astype(np.float32)

    def state_dict(self) -> Dict[str, Any]:
        return {"type": "functional_group", "group_definitions": self.group_definitions}

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "FunctionalGroupPreprocessor":
        return cls(state["group_definitions"])
