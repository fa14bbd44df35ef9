"""Pieces the drivers share: the clock, the check sample, freeing the program."""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..reference.check import beam_readings
from ..reference.model import Reference


def now() -> float:
    return time.perf_counter()


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def warm_up(traffic: Dict[str, Any], unit: Callable[[int], Any]) -> str:
    """Run the cell's own unit of work for the traffic's ``warm_s`` seconds
    of set-up, after its shapes are built and captured; returns a line on
    how the units' times moved. For the first seconds to tens of seconds
    after a process starts on the card, each kernel of a replayed graph
    waits longer for its launch (the decode's device time a batch reads
    ~6.5% higher at the same kernel time and clock); a window that opens
    after that measures what a process that keeps serving sees."""
    seconds = float(traffic.get("warm_s", 0.0))
    times: List[float] = []
    end = now() + seconds
    while now() < end:
        t0 = now()
        unit(len(times))
        times.append(now() - t0)
    if not times:
        return "no warm-up"
    first, last = times[:10], times[-10:]
    return (f"warm-up {seconds:.1f} s: {len(times)} units; s a unit: first "
            f"{float(np.median(first)):.5f}, last {float(np.median(last)):.5f}")


def memory_peak(device: str) -> int:
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def free(device: str) -> None:
    """Return the program's freed memory to the device before the reference runs."""
    gc.collect()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def planted(fault: Optional[str]):
    """The program's beam search with a fault planted for the length of a
    run: ``topk_not_best`` makes its choice of the 2K best of the K x V
    continuations (its only top-k over more than 4k entries) return those
    ranked K + 1 to 3K instead, in every row where all of those are
    reachable (not at the step that forces EOS): a selection that is not
    the top 2K, every score still its own token's. Other faults are the
    drivers'."""
    if fault != "topk_not_best":
        yield
        return
    from multimodalanalytical_tpu_torch.generation import beam_search

    top_k = beam_search._top_k

    def not_best(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if x.shape[-1] <= 4 * k:
            return top_k(x, k)
        values, indices = top_k(x, k + k // 2)
        reachable = values[..., -1:] > beam_search.NEG_INF / 2
        return (torch.where(reachable, values[..., k // 2:], values[..., :k]),
                torch.where(reachable, indices[..., k // 2:], indices[..., :k]))

    beam_search._top_k = not_best
    try:
        yield
    finally:
        beam_search._top_k = top_k


def sample(seed: int, population: int, count: int, stream: int = 7) -> List[int]:
    """``count`` distinct indices of ``population``, drawn from the seed."""
    rng = np.random.default_rng([int(seed), stream])
    return sorted(rng.choice(population, size=min(count, population), replace=False).tolist())


def host_weights(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The weights moved to the host while the program runs."""
    return {name: t.cpu() for name, t in weights.items()}


def to_device(tree: Any, device: str) -> Any:
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree), device=device)


@contextlib.contextmanager
def fp32_matmuls():
    """float32 products without TF32, for the reference."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def reference_checks(config: Dict[str, Any], weights: Dict[str, torch.Tensor], device: str,
                     cases: List[Dict[str, Any]], eos: int, int8_kv: bool,
                     control: bool = False) -> Dict[str, Tuple[float, Optional[float]]]:
    """The numbers a decoding cell reads over ``cases`` of encoder inputs,
    mask, returned sequences and scores (host arrays), each with the
    control's reading (the float8 reference in the program's place; None
    without ``control``, or where the number reads the program alone):

    * ``beam_score_gap``: the widest gap between a returned beam's score and
      the reference's score of the same beam;
    * ``beam_rank_gap``: the widest gap by which a returned token lies below
      what the top K could have kept (``check.beam_readings``);
    * ``beam_gap_mean``: per returned beam, its score's gap plus its widest
      rank gap, averaged over the beams: steady from seed to seed, where
      the widest gaps hang on one beam;
    * ``beam_order_gap``: the most by which a returned beam's score exceeds
      the score of the beam returned above it (0 where every row is sorted).

    Which of them a cell compares, and against what, its traffic's
    ``limits`` say; the others are read and logged.
    """
    per_beam: Dict[str, List[torch.Tensor]] = {"score": [], "rank": [], "order": [],
                                               "control_score": [], "control_rank": []}
    with fp32_matmuls():
        device_weights = {k: v.to(device) for k, v in weights.items()}
        ref = Reference(device_weights, config)
        low = Reference(device_weights, config, fp8=True) if control else None
        for case in cases:
            got = torch.as_tensor(np.asarray(case["scores"]), device=device)
            want = beam_readings(ref, to_device(case["inputs"], device),
                                 to_device(case["mask"], device),
                                 to_device(case["seqs"], device), eos, int8_kv, low)
            per_beam["score"].append((got - want["scores"]).abs().flatten())
            per_beam["rank"].append(want["rank_gap"].flatten())
            per_beam["order"].append((got[:, 1:] - got[:, :-1]).clamp(min=0.0).flatten())
            if control:
                per_beam["control_score"].append(
                    (want["control_scores"] - want["scores"]).abs().flatten())
                per_beam["control_rank"].append(want["control_rank_gap"].flatten())
    beams = {k: torch.cat(v).double() if v else None for k, v in per_beam.items()}
    beams = {k: (torch.nan_to_num(v, nan=float("inf")) if v is not None else None)
             for k, v in beams.items()}

    def widest(v: Optional[torch.Tensor]) -> Optional[float]:
        return None if v is None else (float(v.max()) if v.numel() else 0.0)

    def mean(score: Optional[torch.Tensor], rank: Optional[torch.Tensor]) -> Optional[float]:
        return None if score is None else float((score + rank).mean())

    return {"beam_score_gap": (widest(beams["score"]), widest(beams["control_score"])),
            "beam_rank_gap": (widest(beams["rank"]), widest(beams["control_rank"])),
            "beam_gap_mean": (mean(beams["score"], beams["rank"]),
                              mean(beams["control_score"], beams["control_rank"])),
            "beam_order_gap": (widest(beams["order"]), None)}


def compared(found: Dict[str, Tuple[float, Optional[float]]], limits: Dict[str, float]
             ) -> Dict[str, Any]:
    """The record's ``checks`` (each number the cell's ``limits`` name,
    beside its limit), ``readings`` (the numbers read and not compared) and
    ``control`` (the control's readings) from :func:`reference_checks`."""
    return {"checks": {name: (found[name][0], limit) for name, limit in limits.items()},
            "readings": {name: value for name, (value, _) in found.items() if name not in limits},
            "control": {name: c for name, (_, c) in found.items() if c is not None}}
