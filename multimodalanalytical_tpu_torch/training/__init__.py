"""Training (counterpart of ``training/``): the optimizer, the loader and the trainer."""

from .loader import DataLoader
from .optim import build_optimizer
from .trainer import Trainer

__all__ = ["DataLoader", "Trainer", "build_optimizer"]
