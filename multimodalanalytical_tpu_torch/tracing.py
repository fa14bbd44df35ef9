"""Spans of the port's own layers: the serving engine, the beam loop, the trainer.

A span is a name, the id of the unit of work it belongs to (the engine's
batch id for the engine's and the beam loop's spans of one batch, the
global step for the trainer's), the name of the span open around it on the
same thread (None at the top) and its start and end in ns of
``time.perf_counter_ns()``: the host's monotonic clock, which a profiler
trace can be tied to through one mark recorded on both. A span opened
without an id takes its parent's. Each thread nests its own spans (the
serving engine's worker apart from the caller's thread).

The recorder is off by default; a call site then costs a call and one
attribute test. When it is on, each span also opens
``torch.profiler.record_function(name)``, so any profiler trace of the
program shows the span beside the kernels, on the profiler's own clock.
A trace that records CUDA activity then also holds, per span, a device-side
annotation from its first kernel to its last (kineto's user annotations):
a sum of the device's busy time leaves those out.
Spans are kept in memory, the newest ``capacity`` of them, until a caller
takes them (:meth:`Recorder.take`); nothing is written to a file.
``RECORDER`` is the program's one recorder; :func:`span` opens a span on
it.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import List, NamedTuple, Optional

import torch

CAPACITY = 65536


class Span(NamedTuple):
    name: str
    id: Optional[int]
    parent: Optional[str]
    start_ns: int
    end_ns: int


class _Open:
    """A span while it is open: the context manager :meth:`Recorder.span`
    returns when the recorder is on."""

    __slots__ = ("recorder", "name", "id", "parent", "start_ns", "marker")

    def __init__(self, recorder: "Recorder", name: str, id: Optional[int]):
        self.recorder, self.name, self.id = recorder, name, id

    def __enter__(self) -> "_Open":
        stack = self.recorder._stack()
        self.parent, parent_id = stack[-1] if stack else (None, None)
        if self.id is None:
            self.id = parent_id
        stack.append((self.name, self.id))
        self.marker = torch.profiler.record_function(self.name)
        self.marker.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end_ns = time.perf_counter_ns()
        self.marker.__exit__(*exc)
        self.recorder._stack().pop()
        self.recorder._spans.append(Span(self.name, self.id, self.parent, self.start_ns,
                                         end_ns))


_OFF = contextlib.nullcontext()     # every span while the recorder is off


class Recorder:
    """Closed spans, the newest ``capacity`` of them, from every thread."""

    def __init__(self, capacity: int = CAPACITY):
        self.enabled = False
        self._spans: "collections.deque[Span]" = collections.deque(maxlen=capacity)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, id: Optional[int] = None):
        """A context manager that records ``name`` over its block while the
        recorder is on (``id``: the unit of work's; None takes the parent's)."""
        if not self.enabled:
            return _OFF
        return _Open(self, name, id)

    def take(self) -> List[Span]:
        """The spans closed since the last take, oldest end first; the
        recorder keeps none of them."""
        taken = []
        while True:
            try:
                taken.append(self._spans.popleft())
            except IndexError:
                return taken


RECORDER = Recorder()
span = RECORDER.span
