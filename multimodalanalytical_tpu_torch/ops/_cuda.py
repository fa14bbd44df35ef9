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
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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
def capture(fn: Callable[[], Any], stream: torch.cuda.Stream, pool=None,
            generators: Sequence[torch.Generator] = ()
            ) -> Tuple[torch.cuda.CUDAGraph, Dict[Callable, int], Any]:
    """``fn()`` captured as a CUDA graph on ``stream`` into the memory pool
    ``pool`` (None: a pool of the graph's own), each of ``generators``
    registered with it. ``fn`` must have run once already on ``stream``
    (lazy set-up, workspaces: nothing may allocate outside the pool or set
    up during capture). The device's cached free blocks are released first
    (a warm-up's activations), for the pool; the host's pinned cache stays
    warm. A capture launches nothing, so the launch counts it ticked are
    taken back and returned, to be added at every :func:`replay`. Returns
    (graph, launches, ``fn``'s result); a failed capture raises."""
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    torch.cuda.synchronize(stream.device)
    torch.cuda.empty_cache()
    before = launch_counts()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                out = fn()
            finally:
                graph.capture_end()
        after = launch_counts()
    finally:
        for wrapper, count in before.items():
            wrapper.launches = count
    return graph, {f: after[f] - before[f] for f in after if after[f] != before[f]}, out


def replay(graph: torch.cuda.CUDAGraph, launches: Dict[Callable, int]) -> None:
    """Replay ``graph`` and add the kernel launches its capture recorded."""
    graph.replay()
    for wrapper, count in launches.items():
        wrapper.launches += count


def pool_bytes(pool) -> int:
    """Device bytes held by a CUDA graph memory pool (``graph.pool()``; 0
    for None): what its graphs keep between replays."""
    if pool is None:
        return 0
    return sum(segment["total_size"] for segment in torch.cuda.memory_snapshot()
               if tuple(segment["segment_pool_id"]) == tuple(pool))


def addresses(*modules: torch.nn.Module) -> Tuple[int, ...]:
    """The device addresses of the modules' parameters and buffers, which a
    CUDA graph reads: a graph captured on weights whose addresses have
    changed since (a parameter rebound, a ``.to()``) would read the old
    storage. (Read from each submodule's own tables: half the host time of
    ``parameters()`` and ``buffers()``, which a graph's every replay pays.)"""
    return tuple(t.data_ptr() for module in modules for sub in module.modules()
                 for t in (*sub._parameters.values(), *sub._buffers.values()) if t is not None)


def static_like(tree: Any) -> Any:
    """Room for a tree of tensors (dicts of them at any depth): one empty
    tensor per leaf, of its shape, dtype and device."""
    if isinstance(tree, dict):
        return {key: static_like(value) for key, value in tree.items()}
    return torch.empty_like(tree)


def copy_tree_(static: Any, tree: Any) -> None:
    """Copy ``tree`` into the same-shaped :func:`static_like` room
    ``static``, one ``copy_`` per leaf."""
    if isinstance(static, dict):
        for key, value in static.items():
            copy_tree_(value, tree[key])
    else:
        static.copy_(tree)


def signature(tree: Any) -> Any:
    """The structure, shapes and dtypes of a tree of tensors or arrays
    (dicts of them at any depth): a captured graph's key, as ``jax.jit``
    keys its programs by shape."""
    if isinstance(tree, dict):
        return tuple((key, signature(tree[key])) for key in sorted(tree))
    value = tree if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return tuple(value.shape), str(value.dtype)
