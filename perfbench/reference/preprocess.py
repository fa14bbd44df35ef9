"""The recipe's input processing, worked out again for the reference: the
patch preprocessor's standardisation (mean and std of the nonzero values
of the spectra it is fitted on, reference patches.py) and the cut into
patches."""

from __future__ import annotations

import numpy as np


def standardized_patches(spectrum, fit_spectra: np.ndarray, patch: int) -> np.ndarray:
    fit = np.asarray(fit_spectra, dtype=np.float64)
    nonzero = fit[fit != 0]
    mean, std = nonzero.mean(), nonzero.std()
    values = (np.asarray(spectrum, dtype=np.float64) - mean) / std
    count = values.shape[-1] // patch
    return values[:count * patch].reshape(count, patch).astype(np.float32)
