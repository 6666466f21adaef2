"""Spans and counters of the port's host loops, on the clock of the
profiler's host events.

A span names a stretch of host time at a layer boundary::

    with tracing.span("train.step", unit=step):
        ...

It records its name, its start and end from ``time.time_ns()`` (the Unix
epoch nanoseconds that ``torch.profiler`` stamps its host events with), the
id of the span open around it in the same thread, its unit (a step number,
a generator block; where none is given, the enclosing span's) and any
keyword attributes. A span's time is the host's wall time, implicit
synchronisations inside it included; spans whose names end in ``.wait``
are the host's explicit waits on the device. :func:`count` adds to a named
counter.

Recording is on only while a ``torch.profiler`` profile runs (torch's own
``_is_profiler_enabled`` flag) or inside :func:`recording`. Off, a span
costs one flag check and records nothing, and so does a counter. On under a
profiler, a span also enters ``record_function(name)``, so it shows in the
profiler's trace around the work it issued; its own start and end are taken
inside that annotation, so they leave out its cost. Spans and counters stay
in memory: :func:`snapshot` returns them, with the kernels' launch counts
(``ops.LAUNCHES``, counted always), :func:`reset` clears them, and nothing
is written on the hot path.

Each process keeps its own buffer, so every rank of
:func:`stylex_tpu_torch.parallel.launch` records its own; a snapshot
carries its rank.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List

import torch.autograd.profiler as _profiler

__all__ = ["span", "count", "recording", "is_recording", "snapshot", "reset"]


class _Recorder:
    """The process's spans and counters."""

    def __init__(self):
        self.spans: List[dict] = []
        self.counters: Dict[str, int] = {}
        self.explicit = 0  # open recording() contexts
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_REC = _Recorder()


def is_recording() -> bool:
    """Whether spans and counters record now."""
    return _REC.explicit > 0 or _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "unit", "attrs", "id", "parent", "start", "annotation", "stack")

    def __init__(self, name: str, unit, attrs: dict):
        self.name, self.unit, self.attrs = name, unit, attrs

    def __enter__(self):
        self.stack = _REC.stack()
        outer = self.stack[-1] if self.stack else None
        self.parent = outer.id if outer is not None else None
        if self.unit is None and outer is not None:
            self.unit = outer.unit
        self.id = next(_REC.ids)
        self.stack.append(self)
        self.annotation = None
        if _profiler._is_profiler_enabled:
            self.annotation = _profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.stack.pop()
        rec = {"id": self.id, "parent": self.parent, "name": self.name, "unit": self.unit,
               "start_ns": self.start, "end_ns": end}
        if self.attrs:
            rec["attrs"] = self.attrs
        _REC.spans.append(rec)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, unit=None, **attrs):
    """A context manager recording a span named ``name`` while recording is
    on (read as the span opens); else one that does nothing."""
    return _Span(name, unit, attrs) if is_recording() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if is_recording():
        _REC.counters[name] = _REC.counters.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans and counters inside the block, with or without a
    profiler."""
    _REC.explicit += 1
    try:
        yield
    finally:
        _REC.explicit -= 1


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def snapshot() -> dict:
    """``{"rank", "spans", "counters", "launches"}``: copies of the spans
    recorded (dicts of ``id``, ``parent``, ``name``, ``unit``, ``start_ns``,
    ``end_ns`` and, where given, ``attrs``, in the order they ended), the
    counters, and ``ops.LAUNCHES``."""
    from stylex_tpu_torch.ops import LAUNCHES

    return {"rank": _rank(), "spans": list(_REC.spans), "counters": dict(_REC.counters),
            "launches": dict(LAUNCHES)}


def reset() -> None:
    """Clear the spans and counters (not ``ops.LAUNCHES``)."""
    _REC.spans.clear()
    _REC.counters.clear()
