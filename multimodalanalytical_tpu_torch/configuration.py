"""Global framework settings.

Mirrors the reference's pydantic ``DefaultSettings`` singleton
(reference: src/analytical_fm/configuration.py:9-97) with env-var overrides,
but stores functional groups as SMARTS strings (matched by the first-party
chem engine in :mod:`multimodalanalytical_tpu_torch.chem` instead of RDKit).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict

# 37 functional-group SMARTS patterns, same chemistry as the reference's
# DefaultSettings.default_func_groups (reference configuration.py:21-63).
DEFAULT_FUNC_GROUP_SMARTS: Dict[str, str] = {
    "Acid anhydride": "[CX3](=[OX1])[OX2][CX3](=[OX1])",
    "Acyl halide": "[CX3](=[OX1])[F,Cl,Br,I]",
    "Alcohol": "[#6][OX2H]",
    "Aldehyde": "[CX3H1](=O)[#6,H]",
    "Alkane": "[CX4;H3,H2]",
    "Alkene": "[CX3]=[CX3]",
    "Alkyne": "[CX2]#[CX2]",
    "Amide": "[NX3][CX3](=[OX1])[#6]",
    "Amine": "[NX3;H2,H1,H0;!$(NC=O)]",
    "Arene": "[cX3]1[cX3][cX3][cX3][cX3][cX3]1",
    "Azo compound": "[#6][NX2]=[NX2][#6]",
    "Carbamate": "[NX3][CX3](=[OX1])[OX2H0]",
    "Carboxylic acid": "[CX3](=O)[OX2H]",
    "Enamine": "[NX3][CX3]=[CX3]",
    "Enol": "[OX2H][#6X3]=[#6]",
    "Ester": "[#6][CX3](=O)[OX2H0][#6]",
    "Ether": "[OD2]([#6])[#6]",
    "Haloalkane": "[#6][F,Cl,Br,I]",
    "Hydrazine": "[NX3][NX3]",
    "Hydrazone": "[NX3][NX2]=[#6]",
    "Imide": "[CX3](=[OX1])[NX3][CX3](=[OX1])",
    "Imine": "[$([CX3]([#6])[#6]),$([CX3H][#6])]=[$([NX2][#6]),$([NX2H])]",
    "Isocyanate": "[NX2]=[C]=[O]",
    "Isothiocyanate": "[NX2]=[C]=[S]",
    "Ketone": "[#6][CX3](=O)[#6]",
    "Nitrile": "[NX1]#[CX2]",
    "Phenol": "[OX2H][cX3]:[c]",
    "Phosphine": "[PX3]",
    "Sulfide": "[#16X2H0]",
    "Sulfonamide": "[#16X4]([NX3])(=[OX1])(=[OX1])[#6]",
    "Sulfonate": "[#16X4](=[OX1])(=[OX1])([#6])[OX2H0]",
    "Sulfone": "[#16X4](=[OX1])(=[OX1])([#6])[#6]",
    "Sulfonic acid": "[#16X4](=[OX1])(=[OX1])([#6])[OX2H]",
    "Sulfoxide": "[#16X3]=[OX1]",
    "Thial": "[CX3H1](=O)[#6,H]",
    "Thioamide": "[NX3][CX3]=[SX1]",
    "Thiol": "[#16X2H]",
}


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value is not None else default


@dataclass
class DefaultSettings:
    """Env-overridable global constants (reference configuration.py:9-20)."""

    default_seed: int = field(default_factory=lambda: _env_int("AFM_DEFAULT_SEED", 3247))
    default_val_set_size: int = field(
        default_factory=lambda: _env_int("AFM_DEFAULT_VAL_SET_SIZE", 10000)
    )
    default_test_set_size: int = field(
        default_factory=lambda: _env_int("AFM_DEFAULT_TEST_SET_SIZE", 10000)
    )
    default_samples: int = field(
        default_factory=lambda: _env_int("AFM_DEFAULT_SAMPLES", 10000)
    )
    default_func_groups: Dict[str, str] = field(default_factory=lambda: _load_func_groups())


def _load_func_groups() -> Dict[str, str]:
    raw = os.environ.get("AFM_FUNC_GROUPS")
    if raw:
        return dict(json.loads(raw))
    return dict(DEFAULT_FUNC_GROUP_SMARTS)


DEFAULT_SETTINGS = DefaultSettings()
