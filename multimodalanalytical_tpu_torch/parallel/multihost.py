"""Multi-process data-parallel helpers (counterpart of ``parallel/multihost.py``).

The reference trains across devices with Lightning DDP (reference
trainer/trainer.py:58, cli/training.py:49-59): one process per device,
each with a rank-sharded loader, the gradients all-reduced underneath. The
JAX package spans processes with ``jax.distributed`` under one GSPMD
program; this package does it with ``torch.distributed``: data rank ``p``
feeds the ``p``-th contiguous row-block of every global batch
(``training/loader.py``), and the trainer sums the gradients with one
``all_reduce`` per step over the data group (``training/trainer.py``,
``parallel/mesh.py``). Every helper is the
identity when no process group is initialised, so a single-process run
takes the same code path.

The JAX module's ``local_rows`` and ``to_global`` have no counterpart
here: no global array is ever assembled, and each rank's outputs are
computed from exactly the rows it fed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def initialized() -> bool:
    """True when a ``torch.distributed`` process group is up."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def is_main() -> bool:
    """True on the process that owns checkpoint, metric and artifact writes."""
    return process_index() == 0


def rank_suffix() -> str:
    """Artifact filename suffix: per-rank files under multi-process runs
    (reference cli/training.py:230-251 writes per-rank pickles)."""
    if process_count() == 1:
        return ""
    return f"_rank{process_index()}"


def group_device() -> torch.device:
    """The device the group's collectives take tensors on: the current CUDA
    device under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sum_across_processes(values, mesh=None) -> np.ndarray:
    """Element-wise sum of a small array over all processes, or over
    ``mesh``'s data group (metric reduction): one ``all_reduce`` of a
    float64 tensor on the group's device, so every process sees the same
    totals and takes the same early-stop and checkpoint decisions. The
    array as float64 when single-process or with one data rank."""
    values = np.asarray(values, dtype=np.float64)
    if not initialized() or (mesh is not None and mesh.n_data == 1):
        return values
    total = torch.from_numpy(values.copy()).to(group_device())
    if mesh is None:
        dist.all_reduce(total)
    else:
        mesh.all_reduce_data_(total)
    return total.cpu().numpy()
