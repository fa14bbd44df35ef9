"""Data and tensor parallelism across processes (counterpart of ``parallel/``).

``multihost`` joins and reduces over the process group (data parallelism),
``mesh`` lays the processes out as (data, model) and holds the
tensor-parallel rules, ``tensor`` the model group's collectives with their
gradients, ``dryrun`` one step and decode on a layout."""

from .mesh import initialize_multihost
from .multihost import (
    is_main,
    process_count,
    process_index,
    rank_suffix,
    sum_across_processes,
)

__all__ = [
    "initialize_multihost",
    "is_main",
    "process_count",
    "process_index",
    "rank_suffix",
    "sum_across_processes",
]
