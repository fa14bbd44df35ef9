"""Build and bind the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens on first use and is cached under ``csrc/build/`` by a hash of the
sources, so a checkout needs no install step; it needs ``nvcc`` (on
``PATH`` or under ``$CUDA_HOME/bin``) and takes seconds, not minutes,
because no source includes PyTorch's headers.

Every entry point returns the ``cudaError_t`` of its launch;
:func:`check` raises on anything but success.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "mmt_beam_select_attention_update": [_I] + [_P] * 8 + [_I] * 7 + [_P, _I, _F, _P],
    "mmt_beam_select_attention": [_I] + [_P] * 6 + [_I] * 7 + [_P, _I, _F, _P],
    "mmt_beam_cross_plan": [_I] * 6 + [ctypes.POINTER(_I), ctypes.POINTER(ctypes.c_longlong)],
    "mmt_beam_cross_attention": [_I] + [_P] * 6 + [ctypes.c_longlong] + [_I] * 5 + [_F, _P],
    "mmt_geglu_ffn": [_P] * 10 + [_I] * 8 + [_P],
    "mmt_flash_attention_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "mmt_flash_attention_bwd": [_I] + [_P] * 11 + [_I] * 4 + [_F, _P],
    "mmt_fused_dropout": [_I, _P, _P, _P, ctypes.c_longlong, ctypes.c_uint, _F, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# The kernel wrappers, each with its ``launches`` count (see count_launches).
COUNTED: List[Callable] = []


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise KernelBuildError("nvcc not found on PATH or under $CUDA_HOME/bin")


def library_path() -> Path:
    """Compile the kernels if this exact source set has no library yet."""
    sources = sorted(CSRC.glob("*.cu"))
    hasher = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(CSRC.glob("*.cuh")):
        hasher.update(path.name.encode())
        hasher.update(path.read_bytes())
    so_path = BUILD_DIR / f"libmmt_kernels-{hasher.hexdigest()[:16]}.so"
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # Objects and the library are built under temporary names and the
    # library is renamed into place, so a concurrent process never loads a
    # half-written one.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objects = [Path(tmp_dir) / f"{src.stem}.o" for src in sources]
        compiles = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(sources, objects))
        ]
        failures = []
        for cmd, proc in compiles:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{' '.join(cmd)}\n{err}")
        if failures:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
        tmp_so = Path(tmp_dir) / so_path.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_so), *map(str, objects)]
        result = subprocess.run(cmd, capture_output=True, text=True)
        if result.returncode != 0:
            raise KernelBuildError(f"nvcc failed ({result.returncode}):\n{' '.join(cmd)}\n"
                                   f"{result.stderr}")
        os.replace(tmp_so, so_path)
    return so_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(library_path()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mmt_error_string.argtypes = [ctypes.c_int]
            lib.mmt_error_string.restype = ctypes.c_char_p
            lib.mmt_beam_select_workspace_bytes.argtypes = [_I] * 6
            lib.mmt_beam_select_workspace_bytes.restype = ctypes.c_longlong
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        message = library().mmt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {code} ({message})")


def stream() -> int:
    """PyTorch's current CUDA stream, as the pointer the launchers take."""
    return torch.cuda.current_stream().cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def require(cond: bool, what: str) -> None:
    """Wrapper argument check: the kernels take only what passes these."""
    if not cond:
        raise ValueError(what)


def count_launches(*wrappers: Callable) -> None:
    """Give each kernel wrapper a ``launches`` count, which it raises by one
    where it launches its kernel, and register it, so that a CUDA graph can
    record what its capture launched (:func:`launch_counts`) and add that at
    every replay."""
    for fn in wrappers:
        fn.launches = 0
        COUNTED.append(fn)


def launch_counts() -> Dict[Callable, int]:
    return {fn: fn.launches for fn in COUNTED}


# ------------------------------------------------------------ CUDA graphs
def graph_route(device: torch.device, cuda_graph: bool, model: torch.nn.Module, mesh=None,
                hook: Optional[Callable] = None) -> Optional[str]:
    """Whether a part of the program (a train step, an evaluation step, a
    decode) runs as replayed CUDA graphs: None where it does, otherwise why
    it runs eagerly. Graphs need ``cuda_graph``, a logits ``hook`` whose
    ``capturable`` attribute is not False (the exact formula hook makes one
    host call per step), a CUDA device and collectives a graph can hold:
    each group the part sums over runs none or runs over NCCL. A decode
    sums over the model group of ``model.mesh``; a train step also over the
    model and data groups of ``mesh``, the trainer's."""
    if not cuda_graph:
        return "cuda_graph=False"
    if not getattr(hook, "capturable", True):
        return "a logits hook that is not capturable"
    if device.type != "cuda":
        return f"{device.type} device"
    groups = []
    if model.mesh is not None and model.mesh.n_model > 1:
        groups.append(model.mesh.model_group)
    if mesh is not None and mesh.n_model > 1:
        groups.append(mesh.model_group)
    if mesh is not None and mesh.n_data > 1:
        groups.append(mesh.data_group)
    if not all(dist.get_backend(group) == "nccl" for group in groups):
        return "collectives a CUDA graph cannot hold (not NCCL)"
    return None


class Graph:
    """One captured body: the graph, its static inputs, what the body
    returned at capture (the outputs every replay writes), the kernel
    launches the capture recorded and the addresses of the weights it reads
    (None where its set checks none)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, inputs: Any, out: Any,
                 launches: Dict[Callable, int], weights: Optional[Tuple[int, ...]]):
        self.graph, self.inputs, self.out = graph, inputs, out
        self.launches, self.weights = launches, weights


class GraphSet:
    """CUDA graphs by key, as ``jax.jit`` keeps its programs by shape: one
    capture stream, one memory pool, the captured bodies. Sharing the pool
    is sound only because the set's graphs replay one after another on one
    stream and none reads what another left in it: static inputs and state
    lie outside it. ``generators`` are registered with every graph.
    ``weights``, if given, returns the addresses (:func:`addresses`) of the
    weights the graphs read: a graph captured on weights that have moved
    since (a parameter rebound, a ``.to()``) would read the old storage.
    Counts captures, recaptures, replays and the host seconds capturing
    (``capture_s``)."""

    def __init__(self, device: torch.device, generators: Sequence[torch.Generator] = (),
                 weights: Optional[Callable[[], Tuple[int, ...]]] = None):
        self.device = device
        self.generators = tuple(generators)
        self.weights = weights
        self.entries: Dict[Any, Graph] = {}
        # The keys whose body ran on the capture stream (:meth:`run`).
        self.warm: set = set()
        self.pool = None
        self.captures = self.recaptures = self.replays = 0
        self.capture_s = 0.0
        self._stream: Optional[torch.cuda.Stream] = None

    def _capture_stream(self) -> torch.cuda.Stream:
        """The set's side stream, ordered after the current stream's work."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        return self._stream

    def run(self, key: Any, fn: Callable[[], Any]) -> Any:
        """``fn()`` on the capture stream, which marks ``key`` warm, and its
        result; the current stream then waits for it. A body's lazy set-up
        (cuBLAS workspaces, kernel attributes, shared-memory limits) must
        happen here, before a capture, where nothing may set up."""
        stream = self._capture_stream()
        with torch.cuda.stream(stream):
            out = fn()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.warm.add(key)
        return out

    def capture(self, key: Any, fn: Callable[[], Any], inputs: Any = None,
                warm: bool = False) -> Graph:
        """``fn()`` captured under ``key`` into the set's pool, after one
        :meth:`run` of it when ``warm`` (otherwise it must have run there
        already); ``inputs``, the static inputs it reads, are kept with the
        graph. The device's cached free blocks (a warm-up's activations)
        are released first, for the pool. A capture launches nothing, so
        the launch counts it ticked are taken back and recorded, to be
        added at every :meth:`replay`. A capture that fails raises and
        keeps no graph under ``key``."""
        t0 = time.perf_counter()
        self._drop(key)
        if warm:
            self.run(key, fn)
        stream = self._capture_stream()
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        before = launch_counts()
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=self.pool)
                try:
                    out = fn()
                finally:
                    graph.capture_end()
            after = launch_counts()
        finally:
            for wrapper, count in before.items():
                wrapper.launches = count
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.pool = graph.pool()
        launches = {f: after[f] - before[f] for f in after if after[f] != before[f]}
        entry = self.entries[key] = Graph(graph, inputs, out, launches,
                                         None if self.weights is None else self.weights())
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return entry

    def get(self, key: Any) -> Optional[Graph]:
        """The graph captured under ``key``; None where there is none, or
        where its weights have moved, which drops it and counts a
        recapture."""
        entry = self.entries.get(key)
        if entry is not None and self.weights is not None and entry.weights != self.weights():
            self._drop(key)
            self.recaptures += 1
            return None
        return entry

    def _drop(self, key: Any) -> None:
        """Forget ``key``'s graph. The pool goes with the set's last graph:
        a pool that no graph holds any more is released, and a capture
        into it would fail."""
        self.entries.pop(key, None)
        if not self.entries:
            self.pool = None

    def replay(self, entry: Graph) -> None:
        """Replay ``entry``'s graph and add the kernel launches its capture
        recorded."""
        entry.graph.replay()
        for wrapper, count in entry.launches.items():
            wrapper.launches += count
        self.replays += 1

    def counts(self) -> Dict[str, Any]:
        return {"captures": self.captures, "recaptures": self.recaptures,
                "replays": self.replays, "capture_s": self.capture_s}

    def pool_bytes(self) -> int:
        """Device bytes held by the set's memory pool: what its graphs keep
        between replays."""
        if self.pool is None:
            return 0
        return sum(segment["total_size"] for segment in torch.cuda.memory_snapshot()
                   if tuple(segment["segment_pool_id"]) == tuple(self.pool))


def addresses(*modules: torch.nn.Module) -> Tuple[int, ...]:
    """The device addresses of the modules' parameters and buffers, which a
    CUDA graph reads. (Read from each submodule's own tables: half the host
    time of ``parameters()`` and ``buffers()``.)"""
    return tuple(t.data_ptr() for module in modules for sub in module.modules()
                 for t in (*sub._parameters.values(), *sub._buffers.values()) if t is not None)


# ------------------------------------------------------------ tensor trees
def to_device(tree: Any, device: torch.device) -> Any:
    """Arrays, and dicts of them at any depth, as tensors on ``device``."""
    if isinstance(tree, dict):
        return {key: to_device(value, device) for key, value in tree.items()}
    return torch.as_tensor(tree, device=device)


def static_like(tree: Any) -> Any:
    """Room for a tree of tensors (dicts and tuples of them at any depth):
    one empty tensor per leaf, of its shape, dtype and device."""
    if isinstance(tree, dict):
        return {key: static_like(value) for key, value in tree.items()}
    if isinstance(tree, tuple):
        return tuple(static_like(value) for value in tree)
    return torch.empty_like(tree)


def copy_from_host_(dst: torch.Tensor, src) -> torch.Tensor:
    """Copy ``src`` (an array, or a tensor on the host or on ``dst``'s
    device) into ``dst``, in place. Into a CUDA tensor the host data goes
    through pinned memory without blocking: the copy is ordered on the
    current stream, and the host does not wait for the device."""
    src = torch.as_tensor(src)
    if dst.is_cuda and src.device.type == "cpu":
        return dst.copy_(src.pin_memory(), non_blocking=True)
    return dst.copy_(src)


def copy_tree_(static: Any, tree: Any) -> None:
    """Copy ``tree`` (tensors or arrays) into the same-shaped room
    ``static`` (:func:`static_like`, :func:`to_device`), one
    :func:`copy_from_host_` per leaf."""
    if isinstance(static, dict):
        for key, value in static.items():
            copy_tree_(value, tree[key])
    elif isinstance(static, tuple):
        for value, leaf in zip(static, tree):
            copy_tree_(value, leaf)
    else:
        copy_from_host_(static, tree)


def signature(tree: Any) -> Any:
    """The structure, shapes and dtypes of a tree of tensors or arrays
    (dicts of them at any depth): a captured graph's key, as ``jax.jit``
    keys its programs by shape."""
    if isinstance(tree, dict):
        return tuple((key, signature(tree[key])) for key in sorted(tree))
    value = tree if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return tuple(value.shape), str(value.dtype)
