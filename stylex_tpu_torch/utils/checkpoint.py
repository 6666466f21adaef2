"""Checkpoint and resume of the whole train state.

``<models_dir>/<name>/model_<num>.pt`` beside the model's ``.config.json``,
as the reference lays them out. The file is a ``torch.save`` dict:
``'StylEx'`` holds the model's state dict under the reference's keys (live
nets and EMA copies), so the reference's loaders and the port's
:func:`~stylex_tpu_torch.models.convert.load_reference_checkpoint` read it;
``'g_opt'`` and ``'d_opt'`` the Adam states, ``'step'`` and ``'pl_mean'``
the counters. A file is written under a temporary name and renamed, so a
reader never sees half of one. Reading JAX msgpack checkpoints is not
ported yet.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint", "checkpoint_path"]

_CKPT_RE = re.compile(r"model_(\d+)\.pt$")


def checkpoint_path(models_dir: str, name: str, num: int) -> Path:
    return Path(models_dir) / name / f"model_{num}.pt"


def save_checkpoint(models_dir: str, name: str, num: int, state,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``state`` (a :class:`~stylex_tpu_torch.train.state.TrainState`)
    as checkpoint ``num``; returns its path."""
    path = checkpoint_path(models_dir, name, num)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "StylEx": state.model.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
        "step": int(state.step),
        "pl_mean": float(state.pl_mean),
        **(extra or {}),
    }
    tmp = path.with_suffix(".pt.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return str(path)


def load_checkpoint(path: str, state) -> None:
    """Restore checkpoint ``path`` into ``state`` in place (on the state's
    device)."""
    payload = torch.load(path, map_location=state.device, weights_only=True)
    state.model.load_state_dict(payload["StylEx"])
    state.g_opt.load_state_dict(payload["g_opt"])
    state.d_opt.load_state_dict(payload["d_opt"])
    state.step = int(payload["step"])
    state.pl_mean = torch.tensor(float(payload["pl_mean"]), device=state.device)


def latest_checkpoint(models_dir: str, name: str) -> Optional[Tuple[int, str]]:
    """The highest-numbered checkpoint as (num, path), or None."""
    d = Path(models_dir) / name
    if not d.exists():
        return None
    found = [(int(m.group(1)), str(f)) for f in d.iterdir() if (m := _CKPT_RE.search(f.name))]
    return max(found) if found else None
