"""First-party chemistry engine (C++ core, ctypes binding).

Replaces the reference's RDKit usage (canonicalisation in
reference utils.py:22-41, formulas in logit_processors.py:115,
randomized SMILES in augmentations.py:42-46) with an in-repo C++ kernel.
"""

from .smiles import (
    GUIDED_ATOM_LIST,
    ChemEngineError,
    atom_counts,
    canonicalize,
    embed_3d,
    is_valid,
    mol_formula,
    random_smiles,
)

__all__ = [
    "GUIDED_ATOM_LIST",
    "ChemEngineError",
    "atom_counts",
    "canonicalize",
    "embed_3d",
    "is_valid",
    "mol_formula",
    "random_smiles",
]
