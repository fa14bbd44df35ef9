"""One run of one cell: find its files by name, run its driver, read its metrics.

Everything a cell needs is found from its name: ``workloads/<cell>.json``
(the configuration's name, the driver and the traffic parameters),
``configs/<config>.json``, ``drivers/<driver>.py``, and for each metric that
``BENCHMARK.json`` declares for the cell (the end-to-end ones in an
untraced run, the per-layer ones in a traced run) ``metrics/<metric>.py``,
whose ``read(record)`` returns a number or None (nothing to read). One
quantity declared once per end-to-end metric it moves,
``<quantity>.<part>``, has one reader, ``metrics/<quantity>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multimodalanalytical_tpu")


class NoDevice(RuntimeError):
    pass


class ForbiddenImport(RuntimeError):
    pass


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's configuration and traffic, the run's
    arguments, the device and the process's start on the host clock."""

    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    fault: Optional[str] = None
    control: bool = False


def load_json(kind: str, name: str) -> Dict[str, Any]:
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The module that reads ``metric``: its own file, or its quantity's."""
    own = (ROOT / "metrics" / f"{metric}.py").exists()
    return load_module("metrics", metric if own else metric.split(".")[0])


def declared(cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics ``BENCHMARK.json`` declares for ``cell``: end-to-end in
    an untraced run, per-layer in a traced one."""
    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [e for e in entries if cell in e.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX package's."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"


def run(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
        require_device: bool = True, fault: Optional[str] = None,
        overrides: Optional[Dict[str, Dict[str, Any]]] = None, control: bool = False,
        log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True)
        ) -> Tuple[Dict[str, Any], Dict[str, Tuple[float, float]]]:
    """The result line's object and the compared numbers with their limits.
    ``require_device=False`` (tests) runs on the CPU; ``fault`` names a
    fault planted in the timed path (by the driver, or inside the program:
    ``common.planted``), and ``overrides`` replaces
    keys of the configuration's ``model`` and of the traffic (tests, at a
    size a CPU holds). ``control`` also reads the control's numbers (the
    reference in float8 in the program's place) into the record's
    ``control`` (tools and card tests)."""
    import torch

    from . import common

    workload = load_json("workloads", cell)
    config = load_json("configs", workload["config"])
    for part, values in (overrides or {}).items():
        (config if part == "model" else workload)[part].update(values)
    chips = workload.get("chips", 1)
    if require_device:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoDevice(f"{cell} needs {chips} CUDA device(s); "
                           f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
    else:
        device = "cpu"
    driver = load_module("drivers", workload["driver"])
    ctx = Context(config, workload["traffic"], int(seed), float(seconds), trace, device,
                  t_start, fault, control)
    with common.planted(fault):
        record = driver.run(ctx, log)
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"loaded after the window: {', '.join(found)}")
    if device == "cuda":
        log(f"card: {card()}")
    metrics = {}
    for entry in declared(cell, trace):
        value = reader(entry["name"]).read(record)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    for name, value in record.get("readings", {}).items():
        log(f"reading {name}: {value!r} (not compared)")
    checks = record["checks"]
    correct = all(math.isfinite(v) and v <= limit for v, limit in checks.values())
    info = {"platform": "gpu" if device == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name() if device == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": int(record["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(record["attempted"]),
              "failed": int(record["failed"]), "metrics": metrics, "device": info}
    if trace:
        summary = record["trace"]
        info["busy_s"], info["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    if control:
        result["control"] = record.get("control")
        result["readings"] = record.get("readings", {})
    result["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in checks.items()}
    return result, checks
