"""Carry JAX-package parameters into the port (counterpart of ``models/torch_mapping.py``).

The port names its parameters after the JAX param tree, so the mapping is
one mechanical rule: join the tree path with dots, transpose Dense kernels
and rename ``kernel``/``scale``/``embedding`` to ``weight``. For example
``params["encoder"]["layer_0"]["self_attn"]["qkv_proj"]["kernel"]`` becomes
``encoder.layer_0.self_attn.qkv_proj.weight`` (transposed). The one
3-D kernel, the align head's ``conv1`` (flax (k, in, out)), comes out of
the same transpose as (out, in, k): ``torch.nn.functional.conv1d``'s
layout. A reference checkpoint's state_dict reaches the port through
:func:`load_reference_state_dict`: the port's copy of the reference mapping
(``models/torch_mapping.py``) followed by :func:`load_flax_params`'s
checks, less the parameters that the reference holds and neither package
reads (:func:`without_unapplied_reference_params`).

Under tensor parallelism a model holds this rank's slices
(``parallel/mesh.py``): :func:`shard_state_dict` takes a full state dict
(from :func:`flax_to_state_dict`, a checkpoint or a one-process model) to
the slices of a model built on the mesh, and :func:`gather_state_dict`
gives back the full tensors, the same on every rank of the model group.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import gather_slices, local_slice, param_shardings
from .torch_mapping import lightning_state_dict_to_flax

_RENAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flatten a JAX param tree (nested mappings of arrays) to port names."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (key,))
                continue
            array = np.asarray(value)
            if key == "kernel":
                array = array.T
            name = ".".join(prefix + (_RENAMES.get(key, key),))
            if name in out:
                raise ValueError(f"two JAX parameters map to {name}")
            out[name] = array

    walk(params, ())
    return out


def load_flax_params(model: nn.Module, params: Mapping[str, Any]) -> None:
    """Fill ``model``'s parameters from the JAX package's param tree.

    ``params`` is the tree under ``variables["params"]`` (arrays of any
    numpy-convertible type). Every port parameter must receive exactly one
    JAX parameter of the same shape, and every JAX parameter must be used.
    """
    _load_named(model, flax_to_state_dict(params))


def without_unapplied_reference_params(model: nn.Module, state: Mapping[str, Any]
                                       ) -> Dict[str, Any]:
    """``state`` (port names) without the parameters a reference checkpoint
    holds and ``model`` never reads: a BART preset's target-modality
    embedding norm. The reference's shared embedding keeps a norm for every
    modality, and its BART decoder embeds the target without it
    (``decoder_modality_norm`` False), so neither the JAX param tree nor
    the port holds one."""
    if model.config.decoder_modality_norm:
        return dict(state)
    prefix = f"embedding.norm_{model.target_modality}."
    return {name: value for name, value in state.items() if not name.startswith(prefix)}


def _load_named(model: nn.Module, incoming: Mapping[str, np.ndarray]) -> None:
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(incoming))
    unused = sorted(set(incoming) - set(own))
    if missing or unused:
        raise ValueError(f"parameter names differ: missing {missing}, unused {unused}")
    with torch.no_grad():
        for name, param in own.items():
            array = incoming[name]
            if tuple(array.shape) != tuple(param.shape):
                raise ValueError(f"{name}: JAX shape {array.shape} != port shape "
                                 f"{tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.array(array, dtype=np.float32)))


def load_reference_state_dict(model: nn.Module, state_dict: Mapping[str, Any],
                              family: str = "auto") -> None:
    """Fill ``model`` from a reference PyTorch state_dict: a bare model's
    (``CustomModel``, or the BART / T5 graphs) or a Lightning ``HFWrapper``'s
    with its ``hf_model.`` prefix. Values may be tensors or arrays.
    ``family`` names the reference model family, or ``auto`` to detect it
    from the keys (``torch_mapping.detect_model_family``)."""
    arrays = {key: value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
              else np.asarray(value) for key, value in state_dict.items()}
    incoming = flax_to_state_dict(lightning_state_dict_to_flax(arrays, family=family))
    _load_named(model, without_unapplied_reference_params(model, incoming))


def _check_keys(own, incoming) -> None:
    missing = sorted(set(own) - set(incoming))
    unused = sorted(set(incoming) - set(own))
    if missing or unused:
        raise ValueError(f"state dict names differ: missing {missing}, unused {unused}")


def shard_state_dict(full: Mapping[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` ``full`` (tensors or arrays) as ``model``'s own
    state dict: this rank's slice of every parameter that ``model`` (built on
    its mesh) holds split, the rest as it is. Every key of ``model`` must be
    given once and every given key used."""
    own = model.state_dict()
    _check_keys(own, full)
    mesh = model.mesh
    specs = param_shardings(model, mesh) if mesh is not None else {}
    out: Dict[str, torch.Tensor] = {}
    for name, param in own.items():
        value = torch.as_tensor(np.asarray(full[name]) if not isinstance(full[name], torch.Tensor)
                                else full[name])
        spec = specs.get(name)
        if spec is not None:
            value = local_slice(value, spec, mesh.n_model, mesh.model_index)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(param.shape)}")
        out[name] = value.to(param.dtype)
    return out


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state dict with every split parameter gathered whole over
    its mesh's model group: what one process holds. Every rank of the group
    must call it."""
    mesh = model.mesh
    specs = param_shardings(model, mesh) if mesh is not None else {}
    return {name: gather_slices(value.detach(), specs[name], mesh)
            if specs.get(name) is not None else value
            for name, value in model.state_dict().items()}
