"""A bounded stretch of a run under ``torch.profiler``, reduced to numbers.

The stretch records CPU and CUDA activity. Its start and end are marked by
``record_function`` events, whose kineto timestamps also tie the host's
monotonic clock (the spans of :mod:`harness.spans`) to the trace's. From
the device events (kernels, copies, sets) inside the stretch it gives:
the union of their intervals (busy), the stretch's length (window), the
device time and count per operation name, and the idle gaps between busy
intervals, each labelled by the innermost benchmark span that covered its
midpoint on the host.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from .spans import Spans

START, END = "perfbench.stretch_start", "perfbench.stretch_end"
OPS_KEPT = 10
NAME_CHARS = 120


class Stretch:
    def __init__(self, spans: Optional[Spans] = None):
        self.spans = spans
        self.prof = None
        self.host_start_ns = 0

    def __enter__(self) -> "Stretch":
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.host_start_ns = time.perf_counter_ns()
        with torch.profiler.record_function(START):
            pass
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        with torch.profiler.record_function(END):
            pass
        self.prof.__exit__(*exc)

    def summary(self) -> Dict[str, Any]:
        events = self.prof.profiler.kineto_results.events()
        marks = {e.name(): e.start_ns() for e in events if e.name() in (START, END)}
        start, end = marks[START], marks[END]
        device = []
        for e in events:
            if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
                lo, hi = max(e.start_ns(), start), min(e.start_ns() + e.duration_ns(), end)
                if hi > lo:
                    device.append((lo, hi, e.name()))
        busy, gaps = _union(device, start, end)
        by_op: Dict[str, List[float]] = {}
        for lo, hi, name in device:
            entry = by_op.setdefault(name, [0.0, 0])
            entry[0] += (hi - lo) / 1e9
            entry[1] += 1
        offset = start - self.host_start_ns
        labelled = _label(gaps, self.spans, offset)
        top = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:OPS_KEPT]
        return {"window_s": (end - start) / 1e9, "busy_s": busy / 1e9, "ops": by_op,
                "breakdown": {"device_ops": [[name[:NAME_CHARS], s] for name, (s, _) in top],
                              "idle_gaps": labelled[:OPS_KEPT]}}


def _union(intervals: List[Tuple[int, int, str]], start: int, end: int
           ) -> Tuple[int, List[Tuple[int, int]]]:
    """Total covered ns and the uncovered gaps of [start, end]."""
    busy, gaps, cursor = 0, [], start
    for lo, hi, _ in sorted(intervals):
        if lo > cursor:
            gaps.append((cursor, lo))
        if hi > cursor:
            busy += hi - max(lo, cursor)
            cursor = hi
    if end > cursor:
        gaps.append((cursor, end))
    return busy, gaps


def _label(gaps: List[Tuple[int, int]], spans: Optional[Spans], offset: int) -> List[list]:
    """Idle seconds summed by the innermost span at each gap's midpoint
    ("host other" where no span was open), largest first, with the count."""
    first, last = (gaps[0][0], gaps[-1][1]) if gaps else (0, 0)
    items = [] if spans is None else [(s + offset, e + offset, n) for n, s, e in spans.items
                                      if e + offset > first and s + offset < last]
    totals: Dict[str, List[float]] = {}
    for lo, hi in gaps:
        mid = (lo + hi) // 2
        covering = [(e - s, n) for s, e, n in items if s <= mid < e]
        name = min(covering)[1] if covering else "host other"
        entry = totals.setdefault(name, [0.0, 0])
        entry[0] += (hi - lo) / 1e9
        entry[1] += 1
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])
    return [[f"{name} x{count}", seconds] for name, (seconds, count) in ranked]


def idle_share(record: Dict[str, Any]) -> Optional[float]:
    """100 x (1 - busy / window) of the record's traced stretch."""
    summary = record.get("trace")
    if not summary or not summary["window_s"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
