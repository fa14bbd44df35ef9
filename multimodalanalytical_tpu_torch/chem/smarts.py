"""SMARTS matching (subset engine in csrc/chem/smarts.cpp).

Replaces RDKit ``GetSubstructMatches`` for the functional-group featurizer
(reference data_utils.py:132-150). Presence-only semantics — the reference
reduces match counts to a 0/1 vector (data_utils.py:139).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from .smiles import ChemEngineError, _get_lib


def _matcher():
    lib = _get_lib()
    if not hasattr(lib, "_smarts_configured"):
        lib.afm_smarts_match.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.afm_smarts_match.restype = ctypes.c_int
        lib._smarts_configured = True
    return lib


def smarts_match(smiles: str, pattern: str) -> bool:
    """Does ``smiles`` contain the SMARTS ``pattern``?  Raises on a pattern
    parse failure; an invalid molecule simply doesn't match."""
    rc = _matcher().afm_smarts_match(smiles.encode(), pattern.encode())
    if rc == -2:
        raise ChemEngineError(f"Unsupported SMARTS pattern: {pattern!r}")
    return rc == 1


def match_functional_groups(smiles: str, patterns: Sequence[str]) -> np.ndarray:
    """0/1 presence vector over ``patterns`` (reference data_utils.py:132-141)."""
    out = np.zeros(len(patterns), dtype=np.float32)
    for i, pattern in enumerate(patterns):
        if smarts_match(smiles, pattern):
            out[i] = 1.0
    return out
