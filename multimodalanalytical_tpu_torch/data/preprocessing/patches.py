"""1D spectrum patch preprocessor.

Turns continuous spectra (e.g. 1800-point IR) into fixed-shape patch tensors
for the linear patch embedder. Reference behavior:
src/analytical_fm/data/preprocessing/patches.py:14-107.

TPU notes: everything is vectorized numpy over the whole batch; outputs are
(B, n_patches, patch_size) float32 plus a keep-mask (1 = attend). Output
shapes depend only on fit-time parameters, never on batch content.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np


class PatchPreprocessor:
    def __init__(
        self,
        patch_size: int,
        masking: bool = False,
        interpolation: bool = False,
        overlap: int = 1,
        derivative: bool = False,
        encoding_type: str = "",
        **_unused: Any,  # tolerate legacy config keys (e.g. interplation_merck)
    ):
        self.patch_size = int(patch_size)
        self.masking = bool(masking)
        self.interpolation = bool(interpolation)
        self.overlap = int(overlap)
        self.derivative = bool(derivative)
        self.encoding_type = encoding_type

        self.mean: float = 0.0
        self.std: float = 1.0
        self.mean_deriv: Optional[float] = None
        self.std_deriv: Optional[float] = None
        self.n_features = self.patch_size

    # -- fitting ----------------------------------------------------------
    def fit(self, values: Sequence[Sequence[float]]) -> None:
        """Fit mean/std on nonzero spectrum values (reference patches.py:37-39)."""
        spectra = np.asarray([v for v in values if v is not None], dtype=np.float64)
        nonzero = spectra[spectra != 0]
        self.mean = float(nonzero.mean()) if nonzero.size else 0.0
        self.std = float(nonzero.std()) if nonzero.size else 1.0
        if self.derivative:
            grad = np.gradient(spectra, axis=-1)
            self.mean_deriv = float(grad.mean())
            self.std_deriv = float(grad.std())

    # -- transform --------------------------------------------------------
    def interpolate(self, spectra: np.ndarray) -> np.ndarray:
        """Re-grid 400..4000(3982) cm^-1 spectra onto 650..3900 cm^-1
        (reference patches.py:48-52)."""
        length = spectra.shape[-1]
        old_x = np.arange(400, 4000 if length == 1800 else 3982, 2)
        new_x = np.arange(650, 3900, 2)
        out = np.empty((spectra.shape[0], new_x.shape[0]), dtype=np.float64)
        for i in range(spectra.shape[0]):
            out[i] = np.interp(new_x, old_x, spectra[i])
        return out

    def __call__(self, spectra: Sequence[Optional[Sequence[float]]]):
        """Returns (patches (B, P, patch), keep_mask (B, P) with 1 = attend)."""
        sizes = [len(s) if s is not None else -1 for s in spectra]
        max_size = max(sizes) if max(sizes) != -1 else 500
        dense = np.zeros((len(spectra), max_size), dtype=np.float64)
        none_mask = np.zeros(len(spectra), dtype=bool)
        for i, s in enumerate(spectra):
            if s is None:
                none_mask[i] = True
            else:
                dense[i, : len(s)] = np.asarray(s, dtype=np.float64)

        if self.interpolation:
            dense = self.interpolate(dense)

        standardized = (dense - self.mean) / self.std

        n_patches = standardized.shape[1] // self.patch_size
        trim = n_patches * self.patch_size
        trimmed = standardized[:, :trim]

        if self.overlap == 1:
            patched = trimmed.reshape(-1, n_patches, self.patch_size)
        else:
            stride = self.patch_size // self.overlap
            n_windows = (trim - self.patch_size) // stride + 1
            idx = (np.arange(n_windows)[:, None] * stride) + np.arange(self.patch_size)[None, :]
            patched = trimmed[:, idx]

        if self.derivative:
            grad = np.gradient(dense, axis=-1)[:, :trim]
            grad_patched = grad.reshape(-1, n_patches, self.patch_size)
            patched = np.concatenate([patched, grad_patched], axis=1)

        if self.masking:
            pad_mask = patched.sum(-1) == 0
        else:
            pad_mask = np.repeat(none_mask[:, None], patched.shape[1], axis=1)

        # None rows are always fully masked (data-level modality dropout,
        # reference patches.py:63-67 + 98-105).
        pad_mask = pad_mask | none_mask[:, None]

        keep_mask = (~pad_mask).astype(np.int32)
        return patched.astype(np.float32), keep_mask

    # -- shapes -----------------------------------------------------------
    def output_length(self, spectrum_length: int) -> int:
        if self.interpolation:
            spectrum_length = np.arange(650, 3900, 2).shape[0]
        n_patches = spectrum_length // self.patch_size
        if self.overlap != 1:
            stride = self.patch_size // self.overlap
            n_patches = (n_patches * self.patch_size - self.patch_size) // stride + 1
        if self.derivative:
            n_patches += spectrum_length // self.patch_size
        return n_patches

    # -- serialization ----------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "type": "1D_patches",
            "patch_size": self.patch_size,
            "masking": self.masking,
            "interpolation": self.interpolation,
            "overlap": self.overlap,
            "derivative": self.derivative,
            "encoding_type": self.encoding_type,
            "mean": self.mean,
            "std": self.std,
            "mean_deriv": self.mean_deriv,
            "std_deriv": self.std_deriv,
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "PatchPreprocessor":
        obj = cls(
            patch_size=state["patch_size"],
            masking=state["masking"],
            interpolation=state["interpolation"],
            overlap=state.get("overlap", 1),
            derivative=state.get("derivative", False),
            encoding_type=state.get("encoding_type", ""),
        )
        obj.mean = state["mean"]
        obj.std = state["std"]
        obj.mean_deriv = state.get("mean_deriv")
        obj.std_deriv = state.get("std_deriv")
        return obj
