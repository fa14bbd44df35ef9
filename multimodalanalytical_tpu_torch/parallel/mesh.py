"""Process-group start-up (counterpart of ``parallel/mesh.py``).

The JAX module builds a GSPMD mesh over ('data', 'model') and shards the
batch over 'data'. Under data parallelism in ``torch.distributed`` its
``make_mesh``, ``replicated`` and ``shard_batch`` are the identity: each
process holds a full replica of the state, and the loader already hands it
its rows. What remains is joining the processes, as the reference does
from torchrun's environment (reference cli/training.py:49-59). The
tensor-parallel rules (``_TP_RULES``, ``param_shardings``) are not ported.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def initialize_multihost(device: torch.device) -> torch.device:
    """Join the process group that torchrun describes, when ``AFM_MULTIHOST``
    is set (``1``, ``true`` or ``yes``), as the JAX package gates
    ``jax.distributed.initialize``. Reads ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` (``MASTER_ADDR`` and ``MASTER_PORT`` through ``env://``).
    On ``cuda`` the process takes card ``LOCAL_RANK`` and joins over NCCL;
    on the CPU over gloo. Returns the device the caller runs on:
    ``cuda:LOCAL_RANK``, or ``device`` unchanged. A failure to join raises."""
    if os.environ.get("AFM_MULTIHOST", "").lower() not in ("1", "true", "yes"):
        return device
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    logger.info("Joined a %d-process %s group as rank %d on %s", world, backend, rank, device)
    return device
