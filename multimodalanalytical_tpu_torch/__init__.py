"""PyTorch + CUDA port of ``multimodalanalytical_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference each part of this port is held
against. Module paths mirror it (``models/``, ``ops/``, ``generation/``,
``training/``, ``cli/``); parameter names follow its param tree (see
``models/weights.py``). This package imports ``torch`` and never ``jax``,
nor anything of the JAX package: it keeps its own copies of the
framework-free layers it needs (``configuration.py``, ``chem/``, ``data/``,
``config/``, ``evaluation/``).
"""

from .models.config import ModelConfig
from .models.seq2seq import Seq2SeqModel
from .training import DataLoader, Trainer

__all__ = ["DataLoader", "ModelConfig", "Seq2SeqModel", "Trainer"]
__version__ = "0.1.0"
