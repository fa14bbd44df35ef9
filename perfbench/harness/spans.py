"""Host spans the benchmark records around its calls into the program.

A span is (name, start ns, end ns) on the host's monotonic clock.
Spans are kept in memory and read once the run is over; a recorder that is
off records nothing, so untraced runs pay one attribute test per call.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, List, Tuple


class Spans:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.items: List[Tuple[str, int, int]] = []
        self._lock = threading.Lock()

    def record(self, name: str, start_ns: int, end_ns: int) -> None:
        with self._lock:
            self.items.append((name, start_ns, end_ns))

    def wrap(self, name: str, fn: Callable[..., Any]) -> Callable[..., Any]:
        """``fn`` with a span around each call while the recorder is on."""

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not self.enabled:
                return fn(*args, **kwargs)
            start = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.record(name, start, time.perf_counter_ns())

        return wrapped
