"""Process groups and the tensor-parallel rules (counterpart of ``parallel/mesh.py``).

The JAX module builds a GSPMD mesh over ('data', 'model'): the batch is
sharded over 'data', and ``param_shardings`` shards the wide products over
'model' by its ``_TP_RULES`` (XLA then inserts the all-reduces). Here the
same layout is a :class:`Mesh` of ``torch.distributed`` process groups, in
Megatron's form:

* rank = data_index * n_model + model_index, as ``make_mesh`` reshapes the
  devices to (n_data, n_model);
* a **model** group holds the n_model consecutive ranks of one data index:
  they hold one replica of the model between them, each rank its share of
  the heads and of the FFN width, and their activations are summed in the
  forward (``parallel/tensor.py``);
* a **data** group holds the ranks of one model index across the data
  indices: they feed different rows and sum their gradients.

``_TP_RULES`` are the JAX rules as regexes over the port's dotted parameter
names. Where JAX shards a kernel by columns (P(None, 'model') on flax's
(in, out)), the port shards axis 0 of torch's (out, in) weight, and the
reverse for rows. The port's slices are head-aligned: a rank holds the q,
k and v columns of its H / n_model heads (the fused ``qkv_proj`` and
``kv_proj`` are sliced per block), where JAX splits the fused output axis
in contiguous chunks and lets GSPMD reshard; the math is the same. A module
whose heads, FFN width or vocabulary do not divide by n_model stays
replicated and runs whole on every rank, as JAX's divisibility check
replicates the leaf. Under pure data parallelism (n_model 1) every helper
here is the identity or the world group, so one process, and data
parallelism as the loaders and the trainer ran it, take the same path.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, NamedTuple, Optional

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


class Mesh(NamedTuple):
    """This process's place in an (n_data, n_model) layout. A group of
    ``None`` is the world group; with n_data (n_model) 1 the data (model)
    group is never used. Without a process group (or as a layout only, for
    :func:`param_shardings`) the groups are None and the indices 0."""

    n_data: int = 1
    n_model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def tensor_parallel(self) -> bool:
        return self.n_model > 1

    def all_reduce_data_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the data group, in place; returns it."""
        if self.n_data > 1:
            dist.all_reduce(tensor, group=self.data_group)
        return tensor

    def all_reduce_model_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the model group, in place; returns it."""
        if self.n_model > 1:
            dist.all_reduce(tensor, group=self.model_group)
        return tensor


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (n_data, n_model) layout of the process group (n_data defaults
    to world / n_model), with its model and data groups. Every process must
    call it, in the same order as any other ``new_group``. Without a
    process group it is the one-process mesh (1, 1)."""
    if not (dist.is_available() and dist.is_initialized()):
        if (n_data or 1) * n_model != 1:
            raise ValueError(f"a ({n_data}, {n_model}) mesh needs a process group")
        return Mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"mesh ({n_data}, {n_model}) does not cover {world} processes")
    data_index, model_index = divmod(rank, n_model)
    data_group = model_group = None      # the world group
    if n_data > 1 and n_model > 1:
        # new_group is collective: every rank creates every group, in order.
        for d in range(n_data):
            group = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == data_index:
                model_group = group
        for m in range(n_model):
            group = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == model_index:
                data_group = group
    return Mesh(n_data, n_model, data_index, model_index, data_group, model_group)


def default_mesh() -> Mesh:
    """Pure data parallelism over the process group (the one-process mesh
    without one): what a trainer takes for a model built without a mesh."""
    if dist.is_available() and dist.is_initialized():
        return Mesh(n_data=dist.get_world_size(), data_index=dist.get_rank())
    return Mesh()


# ----------------------------------------------------------- the TP rules
class Shard(NamedTuple):
    """How a parameter is split over the model group: along ``axis`` (of
    torch's (out, in) layout), each of its ``blocks`` equal blocks on that
    axis cut into n_model contiguous slices (3 for a fused q/k/v projection,
    2 for k/v), rank r holding slice r of every block."""

    axis: int
    blocks: int = 1


def local_slice(tensor: torch.Tensor, shard: Shard, n_model: int, index: int) -> torch.Tensor:
    """Rank ``index``'s slice of a full ``tensor`` (a copy)."""
    blocks = tensor.chunk(shard.blocks, dim=shard.axis)
    return torch.cat([b.chunk(n_model, dim=shard.axis)[index] for b in blocks],
                     dim=shard.axis).clone()


def gather_slices(local: torch.Tensor, shard: Shard, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every model rank's slice: each rank writes its
    slices into a zeroed full-size fp32 buffer, which is summed over the
    model group (exact: every element has one non-zero term, so every
    backend needs only ``all_reduce``). Every rank of the group must call it."""
    full_shape = list(local.shape)
    full_shape[shard.axis] *= mesh.n_model
    full = local.new_zeros(full_shape, dtype=torch.float32)
    width = local.shape[shard.axis] // shard.blocks     # one block's slice
    block = width * mesh.n_model
    for b, piece in enumerate(local.float().split(width, dim=shard.axis)):
        start = b * block + mesh.model_index * width
        full.narrow(shard.axis, start, width).copy_(piece)
    return mesh.all_reduce_model_(full).to(local.dtype)


# The JAX package's rules (its parallel/mesh.py), on dotted port names:
# (q|qkv|kv)_proj, linear1, gate and lm_head by output (axis 0 of the torch
# weight, and their biases), out_proj and linear2 by input (axis 1; their
# biases are replicated and added once after the sum). Everything else is
# replicated.
_TP_RULES = [
    (re.compile(r"(q_proj|qkv_proj|kv_proj)\.weight$"), 0),
    (re.compile(r"(q_proj|qkv_proj|kv_proj)\.bias$"), 0),
    (re.compile(r"out_proj\.weight$"), 1),
    (re.compile(r"(linear1|gate)\.weight$"), 0),
    (re.compile(r"(linear1|gate)\.bias$"), 0),
    (re.compile(r"linear2\.weight$"), 1),
    (re.compile(r"lm_head\.weight$"), 0),
    (re.compile(r"lm_head\.bias$"), 0),
]
_BLOCKS = {"qkv_proj": 3, "kv_proj": 2}


def _spec_for_path(name: str) -> Optional[Shard]:
    """The rule's split of parameter ``name``, before the divisibility check."""
    for pattern, axis in _TP_RULES:
        if pattern.search(name):
            module = name.split(".")[-2]
            return Shard(axis, _BLOCKS.get(module, 1) if axis == 0 else 1)
    return None


def shards_heads(num_heads: int, mesh: Optional[Mesh]) -> bool:
    """An attention module runs on H / n_model local heads: its heads divide."""
    return mesh is not None and mesh.n_model > 1 and num_heads % mesh.n_model == 0


def shards_width(width: int, mesh: Optional[Mesh]) -> bool:
    """An FFN or the lm_head is split: its FFN width or vocabulary divides."""
    return mesh is not None and mesh.n_model > 1 and width % mesh.n_model == 0


def param_shardings(model: torch.nn.Module, mesh: Mesh) -> Dict[str, Optional[Shard]]:
    """Per parameter name of ``model`` (built with this mesh, or a one-process
    model as a layout), its :class:`Shard` under ``mesh`` or None for
    replicated: ``_TP_RULES``, where the owning module splits (an attention
    module whose heads divide, an FFN whose width divides, an lm_head whose
    vocabulary divides)."""
    from ..models.transformer import FeedForward
    from ..ops.attention import MultiHeadAttention

    owners = {}
    for prefix, module in model.named_modules():
        if isinstance(module, MultiHeadAttention):
            owners[prefix] = shards_heads(module.total_heads, mesh)
        elif isinstance(module, FeedForward):
            owners[prefix] = shards_width(module.ffn_dim, mesh)
        elif prefix == "lm_head":
            owners[prefix] = shards_width(model.config.vocab_size, mesh)
    specs: Dict[str, Optional[Shard]] = {}
    for name, _ in model.named_parameters():
        spec = _spec_for_path(name)
        owner = name.rsplit(".", 2)[0] if name.count(".") >= 2 else name.split(".")[0]
        specs[name] = spec if spec is not None and owners.get(owner, False) else None
    return specs
