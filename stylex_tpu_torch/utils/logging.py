"""Metric sinks: a CSV file and the reference's stdout status line."""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["MetricLogger"]


class MetricLogger:
    """Appends one row per step to ``csv_path``. Its columns are fixed by
    the file's header on resume, else by the first row's keys; a key outside
    them is dropped with one warning."""

    def __init__(self, csv_path: Optional[str] = None):
        self.csv_path = csv_path
        self._fields: Optional[List[str]] = None
        self._warned = False

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if not self.csv_path:
            return
        if self._fields is None:
            Path(self.csv_path).parent.mkdir(parents=True, exist_ok=True)
            if os.path.exists(self.csv_path):
                with open(self.csv_path, newline="") as f:
                    header = f.readline().strip()
                self._fields = header.split(",")[1:] if header else list(metrics)
            else:
                self._fields = list(metrics)
                with open(self.csv_path, "a", newline="") as f:
                    csv.writer(f).writerow(["step", *self._fields])
        unknown = [k for k in metrics if k not in self._fields]
        if unknown and not self._warned:
            print(f"[stylex_tpu_torch] metrics CSV drops keys not in its header: {unknown}")
            self._warned = True
        with open(self.csv_path, "a", newline="") as f:
            csv.writer(f).writerow(
                [step] + [f"{metrics[k]:.6g}" if k in metrics else "" for k in self._fields])

    def print_line(self, step: int, metrics: Dict[str, float]) -> str:
        """The ``G | D | GP | PL | Rec | KL`` status line."""
        parts = [f"step {step}"]
        for label, key in [("G", "g_loss"), ("D", "d_loss"), ("GP", "gp"), ("PL", "pl_mean"),
                           ("Rec", "rec_loss"), ("KL", "kl_loss")]:
            if key in metrics:
                parts.append(f"{label}: {metrics[key]:.4f}")
        line = " | ".join(parts)
        print(line, flush=True)
        return line
