"""Checkpoints: top-K by a monitored metric, ``last`` and ``best`` (counterpart of ``training/checkpoint.py``).

The directory layout is the JAX package's: ``last/``, ``step_N/`` for the
top-K entries by the monitor (``mode`` max or min), ``best/`` (a copy of the
top entry) and ``index.json``. Each checkpoint directory holds one
``state.pt`` written by ``torch.save``: ``{"params": model state_dict,
"opt_state": optimizer state, "step": n}`` with every tensor on the CPU.

Under several processes only rank 0 writes (as the JAX manager saves
from process 0 only); every rank keeps the index in step, and waits at a
barrier after each save until the files are on disk, so that no rank reads
``last`` or ``best`` before they are.

Saves are synchronous. The JAX package's asynchronous saver, its latest-wins
queue and its wait timeout answer a slow device-to-host relay; what stays is
the trainer's policy that decides which states land on disk (cadence,
pinned best, the save at ``max_steps``).

:func:`restore_params` also reads a JAX param tree flattened to an ``.npz``
(keys joined with ``/``; see :func:`save_flax_npz`), converted by
``models/weights.py``'s naming rule: that is how a JAX-trained model reaches
this package, which never imports jax or orbax.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.weights import flax_to_state_dict, without_unapplied_reference_params
from ..parallel import multihost

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def to_cpu(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor detached and on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, directory: Path, monitor: str = "val_molecular_accuracy",
                 mode: str = "max", top_k: int = 5):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.top_k = top_k
        self._index_path = self.directory / "index.json"
        self._index: Dict[str, Any] = {"checkpoints": [], "last": None, "best": None}
        if self._index_path.exists():
            self._index = json.loads(self._index_path.read_text())

    def _save_tree(self, name: str, tree: Any) -> Path:
        """Write ``tree`` under ``.<name>.partial`` and move it into place in
        one rename: the directory on a first save, the state file over the
        previous one after that. A process killed mid-save leaves the
        previous checkpoint (or none), never a torn or missing one."""
        path = self.directory / name
        staging = self.directory / f".{name}.partial"
        staging.mkdir(parents=True, exist_ok=True)
        torch.save(to_cpu(tree), staging / STATE_FILE)
        if path.is_dir():
            os.replace(staging / STATE_FILE, path / STATE_FILE)
            staging.rmdir()
        else:
            staging.rename(path)
        return path

    def save(self, step: int, tree: Any, metrics: Dict[str, float]) -> None:
        """Save ``last`` plus a top-K entry when the monitored metric
        warrants. Every rank calls it; rank 0 writes (``tree`` is not read
        on the others) and all of them leave it together."""
        main = multihost.is_main()
        if main:
            self._save_tree("last", tree)
        self._index["last"] = {"step": step, "metrics": metrics}

        value = metrics.get(self.monitor)
        if value is not None:
            entries: List[Dict[str, Any]] = self._index["checkpoints"]
            name = f"step_{step}"
            better = sorted(
                entries + [{"name": name, "step": step, "value": float(value)}],
                key=lambda e: e["value"], reverse=(self.mode == "max"))
            keep, drop = better[: self.top_k], better[self.top_k:]
            if any(e["name"] == name for e in keep):
                if main:
                    self._save_tree(name, tree)
                    for e in drop:
                        stale = self.directory / e["name"]
                        if stale.exists():
                            shutil.rmtree(stale)
                self._index["checkpoints"] = keep
                best = keep[0]
                if self._index.get("best") != best:
                    self._index["best"] = dict(best)
                    best_path = self.directory / "best"
                    if main:
                        if best_path.exists():
                            shutil.rmtree(best_path)
                        shutil.copytree(self.directory / best["name"], best_path)
        if main:
            self._index_path.write_text(json.dumps(self._index, indent=1))
        multihost.barrier()

    def restore(self, name: str) -> Dict[str, Any]:
        """The saved tree of checkpoint ``name`` (tensors on the CPU)."""
        path = self.directory / name / STATE_FILE
        if not path.exists():
            raise FileNotFoundError(f"No checkpoint at {path.parent}")
        return torch.load(path, map_location="cpu", weights_only=True)

    @property
    def best_step(self) -> Optional[int]:
        best = self._index.get("best")
        return best["step"] if best else None


def _migrate_fused_projections(node: Any, name: str = "") -> Any:
    """Pre-fusion JAX params (separate q/k/v projections) to the fused
    layout, as the JAX ``_migrate_fused_projections``: self-attention fuses
    q/k/v into qkv_proj, cross-attention k/v into kv_proj."""
    if not isinstance(node, dict):
        return node
    out = {k: _migrate_fused_projections(v, k) for k, v in node.items()}

    def fuse(keys, target):
        parts = [out.pop(k) for k in keys]
        out[target] = {"kernel": np.concatenate([p["kernel"] for p in parts], axis=-1),
                       "bias": np.concatenate([p["bias"] for p in parts], axis=-1)}

    if {"k_proj", "v_proj"} <= set(out):
        if name == "cross_attn":
            fuse(("k_proj", "v_proj"), "kv_proj")
        elif "q_proj" in out:
            fuse(("q_proj", "k_proj", "v_proj"), "qkv_proj")
    return out


def save_flax_npz(path: Path, params: Mapping[str, Any]) -> Path:
    """Write a JAX param tree (nested mappings of arrays) as an ``.npz``
    whose keys are the tree paths joined with ``/``."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (key,))
            else:
                flat["/".join(prefix + (key,))] = np.asarray(value)

    walk(params, ())
    path = Path(path)
    np.savez(path, **flat)
    return path


def load_flax_npz(path: Path) -> Dict[str, Any]:
    """The nested JAX param tree of an ``.npz`` written by :func:`save_flax_npz`."""
    tree: Dict[str, Any] = {}
    with np.load(Path(path)) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return tree


def restore_params(path: Path) -> Dict[str, torch.Tensor]:
    """The model state_dict of a checkpoint: a directory saved by
    :class:`CheckpointManager` (or its ``state.pt``), or an ``.npz`` of a
    JAX param tree (pre-fusion projections are migrated)."""
    path = Path(path).resolve()
    if path.suffix == ".npz":
        params = _migrate_fused_projections(load_flax_npz(path))
        return {k: torch.from_numpy(np.array(v, dtype=np.float32))
                for k, v in flax_to_state_dict(params).items()}
    state_file = path / STATE_FILE if path.is_dir() else path
    if not state_file.exists():
        raise FileNotFoundError(f"No checkpoint at {path}")
    tree = torch.load(state_file, map_location="cpu", weights_only=True)
    return tree["params"] if "params" in tree else tree


def load_params(path: Path, model: torch.nn.Module) -> None:
    """``model``'s parameters from the checkpoint at ``path``
    (:func:`restore_params`), every name matched (``load_state_dict``,
    strict), less what a converted reference checkpoint holds and the model
    never reads (``models/weights.py:without_unapplied_reference_params``)."""
    model.load_state_dict(without_unapplied_reference_params(model, restore_params(path)))


def load_finetune_params(path: Path, model: torch.nn.Module, strip_align: bool
                         ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Params for finetuning, optionally without the align network's
    (reference cli/training.py:152-162, JAX ``load_finetune_params``).
    Returns (state_dict, number of dropped sub-trees); raises when the
    checkpoint and the model hold different numbers of parameters."""
    params = without_unapplied_reference_params(model, restore_params(path))
    own = model.state_dict()
    dropped = 0
    if strip_align and any(k.startswith("align_network.") for k in params):
        params = {k: v for k, v in params.items() if not k.startswith("align_network.")}
        dropped = 1
        # Graft the model's freshly initialised align params where it has them.
        params.update({k: v for k, v in own.items() if k.startswith("align_network.")})
    if len(params) != len(own):
        raise ValueError(f"Checkpoint/model param mismatch: {len(params)} vs {len(own)} leaves")
    return params, dropped
