"""The program's own spans, for the metric readers that read them: the
snapshot of ``stylex_tpu_torch.utils.tracing`` where the run loaded that
module, and the spans' names and lengths.

Nothing here imports the program. A run whose program has no such module
gives no snapshot, and the readers return None. The program records only
while a profiler runs, so the snapshot holds the traced steps or call.
"""

from __future__ import annotations

import sys
from typing import List, Optional

MODULE = "stylex_tpu_torch.utils.tracing"


def snapshot() -> Optional[dict]:
    """The program's spans and counters, or None where it has none."""
    module = sys.modules.get(MODULE)
    return None if module is None else module.snapshot()


def named(snap: dict, name: str) -> List[dict]:
    return [s for s in snap["spans"] if s["name"] == name]


def ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6
