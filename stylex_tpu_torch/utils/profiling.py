"""Step timing and tracing.

* :class:`StepTimer`: seconds per ``Trainer.train()`` call over a rolling
  window, and the throughput they imply (steps/s, images/s), which
  ``train()`` returns beside the losses, as the JAX package's trainer does.
  On a GPU they come from the device's clock: CUDA events at the ends of
  the trainer's blocks of steps (:meth:`StepTimer.mark`); on the CPU, where
  a step has finished when it returns, from the host's.
* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``chrome://tracing``, Perfetto) of the region to
  ``log_dir``, the host's events and, where a GPU is present, the device's,
  and beside it the spans and counters of
  :mod:`stylex_tpu_torch.utils.tracing` recorded in the region. It does
  nothing when ``log_dir`` is falsy.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import deque
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

from stylex_tpu_torch.utils import tracing

__all__ = ["StepTimer", "trace"]


class StepTimer:
    """Seconds per ``Trainer.train()`` call (a block of steps) over the last
    ``window`` calls, and :meth:`stats`.

    On a GPU, :meth:`mark` takes the completed CUDA event
    (``enable_timing=True``) recorded after a block and adds the device
    time since the previous marked event. On the CPU, :meth:`add` or ``with timer:`` around a call add host seconds."""

    def __init__(self, window: int = 50):
        self.durations: deque = deque(maxlen=window)
        self._t0: Optional[float] = None
        self.last_event = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.add(time.perf_counter() - self._t0)
        return False

    def add(self, seconds: float) -> None:
        self.durations.append(seconds)

    def mark(self, event) -> None:
        """A completed event recorded after a block: adds the device time
        since the last event, where there is one; the first (an event
        recorded before a block) starts the clock."""
        if self.last_event is not None:
            self.add(self.last_event.elapsed_time(event) / 1e3)
        self.last_event = event

    def restart(self) -> None:
        """Forget the last event (after work between blocks that is not a
        step): the next block starts the clock again."""
        self.last_event = None

    @property
    def mean_step_s(self) -> float:
        return sum(self.durations) / len(self.durations) if self.durations else 0.0

    def stats(self, images_per_step: int = 0) -> Dict[str, float]:
        """``step_time_s`` and ``steps_per_sec`` (0 before the first step),
        and ``imgs_per_sec`` when ``images_per_step`` is given."""
        mean = self.mean_step_s
        out = {"step_time_s": mean, "steps_per_sec": (1.0 / mean) if mean else 0.0}
        if images_per_step and mean:
            out["imgs_per_sec"] = images_per_step / mean
        return out


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """``with trace('prof') as prof:`` profiles the region and writes
    ``<log_dir>/trace_<unix ms>.json`` and, recorded from an empty buffer
    (spans record themselves under the profiler), the region's spans and
    counters (:func:`~stylex_tpu_torch.utils.tracing.snapshot`) to
    ``<log_dir>/spans_<unix ms>.json``, or ``spans_<unix ms>.rank<r>.json``
    on a rank r > 0; yields the profiler (None when ``log_dir`` is falsy,
    and nothing is traced)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    tracing.reset()
    with profile(activities=activities) as prof:
        yield prof
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    stamp = int(time.time() * 1e3)
    prof.export_chrome_trace(str(out / f"trace_{stamp}.json"))
    spans = tracing.snapshot()
    rank = f".rank{spans['rank']}" if spans["rank"] else ""
    (out / f"spans_{stamp}{rank}.json").write_text(json.dumps(spans))
