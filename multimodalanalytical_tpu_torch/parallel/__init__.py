"""Data parallelism across processes (counterpart of ``parallel/``)."""

from .mesh import initialize_multihost
from .multihost import (
    barrier,
    is_main,
    process_count,
    process_index,
    rank_suffix,
    sum_across_processes,
)

__all__ = [
    "barrier",
    "initialize_multihost",
    "is_main",
    "process_count",
    "process_index",
    "rank_suffix",
    "sum_across_processes",
]
