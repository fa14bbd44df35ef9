from .carbon import CarbonPreprocessor
from .functional_group import FunctionalGroupPreprocessor
from .msms_number import MSMSNumberPreprocessor
from .msms_text import MSMSTextPreprocessor
from .multiplets import MultipletPreprocessor
from .normalization import NormalisePreprocessor
from .onehot import OneHotPreprocessor
from .patches import PatchPreprocessor
from .text_spectrum import (
    PeakPositionalEncodingPreprocessor,
    RunLengthEncodingPreprocessor,
    TextSpectrumPreprocessor,
)

# Registry keyed by modality `type` (reference: data/preprocessors.py:23-35).
PREPROCESSORS = {
    "carbon": CarbonPreprocessor,
    "functional_group": FunctionalGroupPreprocessor,
    "msms_number": MSMSNumberPreprocessor,
    "msms_text": MSMSTextPreprocessor,
    "multiplets": MultipletPreprocessor,
    "normalise": NormalisePreprocessor,
    "class_one_hot": OneHotPreprocessor,
    "1D_patches": PatchPreprocessor,
    "peak_positional_encoding": PeakPositionalEncodingPreprocessor,
    "run_length_encoding": RunLengthEncodingPreprocessor,
    "text_spectrum": TextSpectrumPreprocessor,
}

__all__ = ["PREPROCESSORS"] + [cls.__name__ for cls in PREPROCESSORS.values()]
