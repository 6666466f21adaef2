"""Metric sinks: a CSV file, TensorBoard scalars and the reference's stdout
status line.

The TensorBoard sink writes ``loss/{G,D,rec,kl}`` under
``<tensorboard_dir>/<name>`` through ``torch.utils.tensorboard``, as the
JAX package's does. Where that module cannot be imported (it needs the
``tensorboard`` package), the sink is off and one line says so.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["MetricLogger", "tensorboard_writer"]


def tensorboard_writer(log_dir: str):
    """A ``SummaryWriter`` on ``log_dir``, or None, with one printed line,
    where ``torch.utils.tensorboard`` cannot be imported."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        print(f"[stylex_tpu_torch] TensorBoard sink off: torch.utils.tensorboard does not "
              f"import ({e}); {log_dir} is not written")
        return None
    return SummaryWriter(log_dir)


class MetricLogger:
    """Appends one row per step to ``csv_path``. Its columns are fixed by
    the file's header on resume, else by the first row's keys; a key outside
    them is dropped with one warning. With ``tensorboard_dir``, also the
    scalars ``loss/G``, ``loss/D``, ``loss/rec`` and ``loss/kl`` under
    ``<tensorboard_dir>/<name>``."""

    def __init__(self, csv_path: Optional[str] = None, tensorboard_dir: Optional[str] = None,
                 name: str = "default"):
        self.csv_path = csv_path
        self._fields: Optional[List[str]] = None
        self._warned = False
        self.tb = tensorboard_writer(os.path.join(tensorboard_dir, name)) if tensorboard_dir \
            else None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if self.tb is not None:
            for tag, key in (("loss/G", "g_loss"), ("loss/D", "d_loss"), ("loss/rec", "rec_loss"),
                             ("loss/kl", "kl_loss")):
                self.tb.add_scalar(tag, metrics.get(key, 0.0), step)
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

    def close(self) -> None:
        """Flush and close the TensorBoard file."""
        if self.tb is not None:
            self.tb.close()
            self.tb = None

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
