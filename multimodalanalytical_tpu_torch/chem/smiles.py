"""ctypes binding for the C++ SMILES engine (csrc/chem/chem.cpp).

The shared library is compiled on first use from the repository's
framework-free sources in ``csrc/chem/`` and cached by a content hash in
this package's own build directory (``multimodalanalytical_tpu_torch/csrc/
build/``), so the package needs no install-time build step. g++ writes the
library under a temporary name that is then renamed into place, so a
concurrent process never loads a half-written one.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "csrc" / "chem" / "engine.cpp"
_SRC_PARTS = [
    _REPO_ROOT / "csrc" / "chem" / "chem.cpp",
    _REPO_ROOT / "csrc" / "chem" / "smarts.cpp",
]
_BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_OUT_LEN = 16384

# Atom list used by formula-guided decoding (reference logit_processors.py:25-40).
GUIDED_ATOM_LIST = ["C", "N", "O", "S", "P", "F", "Cl", "Br", "I", "B", "Si", "H", "Se", "As"]
_ATOMIC_NUMBERS: Dict[str, int] = {
    "H": 1, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "As": 33, "Se": 34, "Br": 35, "I": 53,
}


class ChemEngineError(RuntimeError):
    pass


def _build_library() -> Path:
    hasher = hashlib.sha256(_SRC.read_bytes())
    for part in _SRC_PARTS:
        hasher.update(part.read_bytes())
    digest = hasher.hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = _BUILD_DIR / f"libafmchem-{digest}.so"
    if so_path.exists():
        return so_path
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp_dir:
        tmp_so = Path(tmp_dir) / so_path.name
        cmd = [
            "g++", "-O2", "-fPIC", "-shared", "-std=c++17",
            str(_SRC), "-o", str(tmp_so),
        ]
        logger.info("Building chem engine: %s", " ".join(cmd))
        result = subprocess.run(cmd, capture_output=True, text=True)
        if result.returncode != 0:
            raise ChemEngineError(f"chem engine build failed:\n{result.stderr}")
        os.replace(tmp_so, so_path)
    return so_path


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so_path = _build_library()
            lib = ctypes.CDLL(str(so_path))
            lib.afm_canonicalize.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
            lib.afm_canonicalize.restype = ctypes.c_int
            lib.afm_mol_formula.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
            lib.afm_mol_formula.restype = ctypes.c_int
            lib.afm_parse_ok.argtypes = [ctypes.c_char_p]
            lib.afm_parse_ok.restype = ctypes.c_int
            lib.afm_random_smiles.argtypes = [
                ctypes.c_char_p, ctypes.c_uint, ctypes.c_char_p, ctypes.c_int,
            ]
            lib.afm_random_smiles.restype = ctypes.c_int
            lib.afm_atom_environment.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int,
            ]
            lib.afm_atom_environment.restype = ctypes.c_int
            lib.afm_embed3d.argtypes = [
                ctypes.c_char_p, ctypes.c_uint, ctypes.c_char_p, ctypes.c_int,
            ]
            lib.afm_embed3d.restype = ctypes.c_int
            lib.afm_atom_counts.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.afm_atom_counts.restype = ctypes.c_int
            _lib = lib
    return _lib


def canonicalize(smiles: str) -> Optional[str]:
    """Canonical SMILES, or None when the input is not a valid molecule.

    Mirrors ``Chem.MolToSmiles(Chem.MolFromSmiles(s))``-style usage in the
    reference (utils.py:38-39) — the canonical form is framework-consistent,
    not byte-identical to RDKit's.
    """
    if not smiles:
        return None
    lib = _get_lib()
    buf = ctypes.create_string_buffer(_OUT_LEN)
    rc = lib.afm_canonicalize(smiles.encode("utf-8"), buf, _OUT_LEN)
    if rc != 0:
        return None
    return buf.value.decode("utf-8")


def is_valid(smiles: str) -> bool:
    if not smiles:
        return False
    return bool(_get_lib().afm_parse_ok(smiles.encode("utf-8")))


def mol_formula(smiles: str) -> Optional[str]:
    """Hill-order molecular formula (reference uses rdMolDescriptors.CalcMolFormula)."""
    if not smiles:
        return None
    lib = _get_lib()
    buf = ctypes.create_string_buffer(_OUT_LEN)
    rc = lib.afm_mol_formula(smiles.encode("utf-8"), buf, _OUT_LEN)
    if rc != 0:
        return None
    return buf.value.decode("utf-8")


def random_smiles(smiles: str, n: int, seed: int = 0) -> List[str]:
    """N randomized (non-canonical) SMILES of the molecule.

    Reference equivalent: Chem.MolToSmiles(mol, canonical=False, doRandom=True)
    (augmentations.py:45).
    """
    lib = _get_lib()
    out: List[str] = []
    buf = ctypes.create_string_buffer(_OUT_LEN)
    for k in range(n):
        rc = lib.afm_random_smiles(smiles.encode("utf-8"), seed + k, buf, _OUT_LEN)
        if rc != 0:
            raise ChemEngineError(f"invalid SMILES for random enumeration: {smiles!r}")
        out.append(buf.value.decode("utf-8"))
    return out


def atom_environment(smiles: str, center_element: str = "P", radius: int = 1) -> Optional[str]:
    """Canonical SMILES of the local environment (bond radius N) around the
    first atom of ``center_element`` (phosphor paper targets; reference
    process_hack_data.py:18-36)."""
    lib = _get_lib()
    buf = ctypes.create_string_buffer(_OUT_LEN)
    z = _ATOMIC_NUMBERS[center_element]
    rc = lib.afm_atom_environment(smiles.encode("utf-8"), z, radius, buf, _OUT_LEN)
    if rc != 0:
        return None
    return buf.value.decode("utf-8")


def atom_counts(smiles: str, atoms: Sequence[str] = GUIDED_ATOM_LIST) -> Optional[List[int]]:
    """Per-element atom counts (H includes implicit hydrogens)."""
    if not smiles:
        return None
    lib = _get_lib()
    n = len(atoms)
    zs = (ctypes.c_int * n)(*[_ATOMIC_NUMBERS[a] for a in atoms])
    counts = (ctypes.c_int * n)()
    rc = lib.afm_atom_counts(smiles.encode("utf-8"), zs, n, counts)
    if rc != 0:
        return None
    return list(counts)


def embed_3d(smiles: str, seed: int = 0) -> Optional[str]:
    """XYZ-format 3D conformer via the engine's distance-geometry embedder.

    Replaces RDKit EmbedMolecule for the dataset-paper tooling (reference
    scripts_ir_nmr_multimodal_comp_spectra_dataset/scripts/
    make_xyz_file_from_smiles.py:22-29). Geometries are refinement-grade
    starting structures (CPMD/DFT optimizes them), not equilibrium ones.
    Returns the full XYZ block (count, comment, atom lines) or None for
    invalid SMILES.
    """
    lib = _get_lib()
    buf = ctypes.create_string_buffer(_OUT_LEN * 64)
    rc = lib.afm_embed3d(smiles.encode("utf-8"), seed, buf, _OUT_LEN * 64)
    if rc != 0:
        return None
    return buf.value.decode("utf-8")
