"""Step timing and tracing.

* :class:`StepTimer`: wall-clock seconds per ``Trainer.train()`` call over
  a rolling window, and the throughput they imply (steps/s, images/s),
  which ``train()`` returns beside the losses, as the JAX package's
  trainer does.
* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``chrome://tracing``, Perfetto) of the region to
  ``log_dir``, the host's events and, where a GPU is present, the device's.
  It does nothing when ``log_dir`` is falsy.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

__all__ = ["StepTimer", "trace"]


class StepTimer:
    """``with timer:`` around each step; :meth:`stats` over the last
    ``window`` steps."""

    def __init__(self, window: int = 50):
        self.durations: deque = deque(maxlen=window)
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.durations.append(time.perf_counter() - self._t0)
        return False

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
    ``<log_dir>/trace_<unix ms>.json``; yields the profiler (None when
    ``log_dir`` is falsy, and nothing is traced)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"trace_{int(time.time() * 1e3)}.json"))
