"""PyTorch + CUDA port of ``multimodalanalytical_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference each part of this port is held
against. Module paths mirror it (``models/``, ``ops/``, ``generation/``,
``cli/``); parameter names follow its param tree (see ``models/weights.py``).
This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
