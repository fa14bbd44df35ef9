"""Checkpoints: top-K by a monitored metric, ``last`` and ``best`` (counterpart of ``training/checkpoint.py``).

The directory layout is the JAX package's: ``last/``, ``step_N/`` for the
top-K entries by the monitor (``mode`` max or min), ``best/`` (a copy of the
top entry) and ``index.json``. Each checkpoint directory holds one
``state.pt`` written by ``torch.save``: ``{"params": model state_dict,
"opt_state": optimizer state, "step": n}`` with every tensor on the CPU.

Two routes write the same files through one writer (``_write``). ``save``
is synchronous. ``save_async`` (what ``Trainer.fit`` calls, as the JAX
trainer does) takes a device snapshot of the tree on the current stream,
enqueues its copies into pinned host memory on a side stream, and hands
the request to one persistent daemon thread through a latest-wins queue of
depth 1; the thread waits for the copies' event and writes, while the
train steps go on. The snapshot is what makes that safe: the optimizer
updates the parameters and moments in place, so copies read from them
beside the next step would publish later weights under an earlier step.
The pinned buffers are the manager's: a written request gives them back
and a replaced one hands them on, so at most two sets exist (one being
written, one queued) and only the first saves allocate; a CUDA graph
capture, which empties the allocators' caches, cannot drop them.
``wait(timeout_s)`` drains the queue, re-raises the first background error
and, on timeout, logs what is on disk and returns False.

Under several processes only rank 0 writes (as the JAX manager saves from
process 0 only). The index is kept where the writes run: on rank 0, by the
writer. The saving thread never calls a collective; ``save`` and ``wait``
end on every rank's main thread with one reduction that carries rank 0's
outcome (and whether it failed) and doubles as the barrier, after which
the other ranks reload ``index.json``. So no rank reads ``last`` or
``best`` before they are on disk, no rank's index names a step whose
write the queue dropped, and a save that failed on rank 0 raises on every
rank rather than leaving the others in the reduction.

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
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.weights import flax_to_state_dict, without_unapplied_reference_params
from ..parallel import multihost

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _map_tensors(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``tree`` with ``fn`` applied to every tensor leaf, depth first in
    mapping and sequence order; other leaves (the int step) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def to_cpu(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor detached and on the CPU."""
    return _map_tensors(tree, lambda t: t.detach().to("cpu", copy=True))


@dataclass
class Snapshot:
    """A checkpoint tree whose tensors are private copies (what
    :meth:`CheckpointManager.snapshot` returns), and the CUDA event that
    marks the end of their copies on ``device`` (both None for tensors on
    the CPU)."""

    tree: Any
    event: Optional[torch.cuda.Event] = None
    device: Optional[torch.device] = None


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
        # The saving thread, started at the first save_async, its queue of
        # depth 1 (the latest request wins: step, host tree, the event after
        # its copies, the tree's pinned buffers, metrics), the side stream of
        # the copies and the pinned buffer sets that no request holds.
        self._worker: Optional[threading.Thread] = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._cond = threading.Condition()
        self._pending: Optional[Tuple[int, Any, Optional[torch.cuda.Event],
                                      List[torch.Tensor], Dict[str, float]]] = None
        self._spare: List[List[torch.Tensor]] = []
        self._busy = False
        self._async_error: Optional[BaseException] = None

    def _save_tree(self, name: str, tree: Any) -> Path:
        """Write ``tree`` under ``.<name>.partial`` and move it into place in
        one rename: the directory on a first save, the state file over the
        previous one after that. A process killed mid-save leaves the
        previous checkpoint (or none), never a torn or missing one."""
        path = self.directory / name
        staging = self.directory / f".{name}.partial"
        staging.mkdir(parents=True, exist_ok=True)
        torch.save(tree, staging / STATE_FILE)
        if path.is_dir():
            os.replace(staging / STATE_FILE, path / STATE_FILE)
            staging.rmdir()
        else:
            staging.rename(path)
        return path

    def _write(self, step: int, tree: Any, metrics: Dict[str, float]) -> None:
        """Rank 0's writes of one save, a host ``tree``: ``last``, a top-K
        entry and ``best`` when the monitored metric warrants, then the
        index, which names only files already in place."""
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
                    if best_path.exists():
                        shutil.rmtree(best_path)
                    shutil.copytree(self.directory / best["name"], best_path)
        staging = self.directory / ".index.json.partial"
        staging.write_text(json.dumps(self._index, indent=1))
        os.replace(staging, self._index_path)

    def _agree(self, on_main: Callable[[], bool]) -> bool:
        """``on_main()`` on rank 0 and its outcome on every rank, by one
        reduction on each rank's main thread that carries whether it
        returned True and whether it raised, and serves as the barrier after
        rank 0's writes; the other ranks then reload the index rank 0
        wrote. What rank 0 raised is raised there after the reduction, and a
        RuntimeError on the other ranks, which would otherwise wait in the
        next reduction for a rank that has failed."""
        main = multihost.is_main()
        ok, error = True, None
        if main:
            try:
                ok = on_main()
            except Exception as exc:  # raised below, once every rank knows
                error = exc
        if multihost.initialized():
            ok, failed = multihost.sum_across_processes(
                [float(main and ok and error is None), float(main and error is not None)])
            ok = bool(ok)
            if not main:
                if self._index_path.exists():
                    self._index = json.loads(self._index_path.read_text())
                if failed:
                    raise RuntimeError(f"A checkpoint save failed on rank 0 ({self.directory}); "
                                       "its log has the error")
        if error is not None:
            raise error
        return ok

    def save(self, step: int, tree: Any, metrics: Dict[str, float]) -> None:
        """Save ``last`` plus a top-K entry when the monitored metric
        warrants, synchronously. Every rank calls it; rank 0 first drains
        the asynchronous queue (so no queued request lands after this one),
        then writes (``tree`` is not read on the others); all of them leave
        it together, and all of them raise if rank 0 failed."""
        def drain_and_write() -> bool:
            self._drain(None)
            host = tree.tree if isinstance(tree, Snapshot) else tree
            self._write(step, to_cpu(host), metrics)
            return True

        self._agree(drain_and_write)

    # ----------------------------------------------------------- async save
    def snapshot(self, tree: Any, fresh: Iterable[torch.Tensor] = ()) -> Snapshot:
        """A copy of every tensor leaf of ``tree`` on its device, made by
        one ``torch._foreach_copy_`` on the current stream, with the event
        recorded after it; other leaves keep their type. Tensors in
        ``fresh`` (by identity: made for this tree, such as those gathered
        over the model group) are private already and are not copied
        again. The trainer pins a rate-suppressed best this way."""
        keep = {id(t) for t in fresh}
        sources: List[torch.Tensor] = []
        _map_tensors(tree, lambda t: None if id(t) in keep else sources.append(t))
        copies = [torch.empty_like(t) for t in sources]
        if copies:
            with torch.no_grad():
                torch._foreach_copy_(copies, sources)
        it = iter(copies)
        tree = _map_tensors(tree, lambda t: t if id(t) in keep else next(it))
        device = next((t.device for t in copies if t.device.type == "cuda"), None)
        if device is None:
            return Snapshot(tree)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        return Snapshot(tree, event, device)

    def save_async(self, step: int, tree: Any, metrics: Dict[str, float],
                   fresh: Iterable[torch.Tensor] = ()) -> None:
        """Asynchronous ``save``: a device snapshot now (unless ``tree`` is
        a :class:`Snapshot` already; ``fresh`` as in :meth:`snapshot`) and
        its copies to the host enqueued behind it; the saving thread waits
        for them and writes. The queue has depth 1: a request made while a
        save runs replaces any queued one. Every rank may call it; only rank
        0 queues (the others' trees are not read). ``wait()`` drains the
        queue and raises what failed."""
        if not multihost.is_main():
            return
        snap = tree if isinstance(tree, Snapshot) else self.snapshot(tree, fresh)
        host, copied, buffers = self._start_host_copy(snap)
        with self._cond:
            self._pending = (step, host, copied, buffers, dict(metrics))
            if self._worker is None:
                self._worker = threading.Thread(target=self._drain_loop, daemon=True,
                                                name="checkpoint-save")
                self._worker.start()
            self._cond.notify_all()

    def _start_host_copy(self, snap: Snapshot
                         ) -> Tuple[Any, Optional[torch.cuda.Event], List[torch.Tensor]]:
        """The snapshot's tree with its CUDA tensors copied into pinned host
        buffers (:meth:`_host_buffers`), the event that marks the end of the
        copies and the buffers (the tree as it is, None and none when it is
        on the CPU: the snapshot is private already). The copies are
        enqueued without blocking on a side stream that waits for the
        snapshot's event, not for the whole device, so they run beside the
        next train step; ``record_stream`` keeps the caching allocator from
        handing the snapshot's memory out before they have read it. They
        are enqueued here, on the calling thread: one call per tensor on
        the saving thread, beside a train step's, took the interpreter lock
        back and forth at every call and slowed both (``PERF.md``,
        Findings)."""
        if snap.event is None:
            return snap.tree, None, []
        sources: List[torch.Tensor] = []
        _map_tensors(snap.tree, lambda t: sources.append(t) if t.device.type == "cuda" else None)
        buffers = self._host_buffers(sources)
        with torch.cuda.device(snap.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            stream = self._stream
            stream.wait_event(snap.event)
            with torch.cuda.stream(stream):
                for host, t in zip(buffers, sources):
                    t.record_stream(stream)
                    host.copy_(t, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(stream)
        it = iter(buffers)
        tree = _map_tensors(snap.tree, lambda t: next(it) if t.device.type == "cuda" else t)
        return tree, copied, buffers

    def _host_buffers(self, sources: List[torch.Tensor]) -> List[torch.Tensor]:
        """Pinned host buffers shaped as ``sources``: the queued request's,
        which the new one replaces (its copies ran on the same stream,
        before the new ones), or a set that a finished write gave back;
        else new ones."""
        layout = [(t.shape, t.dtype) for t in sources]

        def fits(buffers: List[torch.Tensor]) -> bool:
            return [(b.shape, b.dtype) for b in buffers] == layout

        with self._cond:
            if self._pending is not None and fits(self._pending[3]):
                buffers, self._pending = self._pending[3], None
                return buffers
            for i, spare in enumerate(self._spare):
                if fits(spare):
                    return self._spare.pop(i)
        return [torch.empty(shape, dtype=dtype, pin_memory=True) for shape, dtype in layout]

    def _drain_loop(self) -> None:
        while True:
            with self._cond:
                while self._pending is None:
                    self._cond.wait()
                step, tree, copied, buffers, metrics = self._pending
                self._pending = None
                self._busy = True
            error: Optional[BaseException] = None
            try:
                if copied is not None:
                    copied.synchronize()
                self._write(step, tree, metrics)
            except Exception as exc:  # re-raised on the main thread by wait()
                error = exc
                logger.exception("Asynchronous checkpoint save failed at step %d", step)
            del tree
            with self._cond:
                if buffers:   # for the next request: one set queued, one written at most
                    self._spare = (self._spare + [buffers])[-2:]
                del buffers
                self._busy = False
                if error is not None and self._async_error is None:
                    self._async_error = error
                self._cond.notify_all()

    def _drain(self, timeout_s: Optional[float]) -> bool:
        """Rank 0's drain: True once the queue is empty and no save runs;
        False if ``timeout_s`` passes first (the running save is abandoned:
        the thread is a daemon). Raises the first background error."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._cond:
            while self._pending is not None or self._busy:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    last = self._index.get("last") or {}
                    best = self._index.get("best") or {}
                    logger.error("Abandoning in-flight checkpoint save after %.0f s. On-disk "
                                 "state is still usable: last=step %s, best=step %s (%s).",
                                 timeout_s, last.get("step"), best.get("step"), self.directory)
                    if self._async_error is not None:
                        # Kept, so that a later wait() still raises it.
                        logger.error("A previous asynchronous save had already failed: %r",
                                     self._async_error)
                    return False
                self._cond.wait(timeout=remaining)
            if self._async_error is not None:
                error, self._async_error = self._async_error, None
                raise error
        return True

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        """Block until every queued save is on disk, on every rank (each
        calls it); re-raise the first background error. ``timeout_s``
        bounds rank 0's drain: on timeout the running save is abandoned,
        what survives on disk is logged, and every rank returns False.
        True on a clean drain."""
        return self._agree(lambda: self._drain(timeout_s))

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
