"""Host spans inside the port's hot path, by the host clock, kept in memory.

Off by default.  Off, `span(name)` returns one shared no-op context
manager: it reads no clock, allocates nothing and records nothing.
`enable()` turns recording on.  Each span then records its name, the
name of the span it opened inside (None at the top), its step id and its
start and end from `time.perf_counter_ns()`, until `drain()` hands the
records over and clears them.  A span opened with none open is a step:
it takes the next step id, and the spans opened inside it share that id.
Records come in the order the spans closed, so a step's children come
before the step.  One thread at a time records: the spans' nesting is
the process's.

The clock is the one that `time.perf_counter()` reads, so the records lie
on the same clock as a caller's own host timings (CLOCK_MONOTONIC on
Linux).  Nothing here synchronizes the device or records an event: a
span measures the host's time in the code it covers, including the time
spent enqueueing the kernels it launches.
"""

from __future__ import annotations

import contextlib
import itertools
from time import perf_counter_ns
from typing import NamedTuple


class Record(NamedTuple):
    name: str
    parent: str | None
    step: int
    start_ns: int
    end_ns: int


_NOOP = contextlib.nullcontext()
_on = False
_records: list[tuple] = []
_steps = itertools.count()
_open: list = []


class _Span:
    __slots__ = ("name", "parent", "step", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _open:
            self.parent, self.step = _open[-1].name, _open[-1].step
        else:
            self.parent, self.step = None, next(_steps)
        _open.append(self)
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = perf_counter_ns()
        _open.pop()
        # A plain tuple of atoms, which the collector stops tracking at its
        # first young collection: the records kept add nothing to the
        # count that sets off a full collection (~0.25 s with torch loaded).
        _records.append((self.name, self.parent, self.step, self.start_ns,
                         end))
        return False


def span(name: str):
    """A context manager that records the host time spent inside it while
    recording is on, and does nothing while it is off."""
    return _Span(name) if _on else _NOOP


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> list[Record]:
    """The records kept since the last drain, in the order their spans
    closed; the store is left empty."""
    global _records
    out, _records = _records, []
    return [Record(*r) for r in out]
