"""Build on the host, then place on the device once.

``init_on_host(fn, *args, dtype=None, device=None)`` runs ``fn(*args)``
with the CPU as the default device, casts the result's float32 tensors to
``dtype`` there, and moves the result to ``device`` in one pass: the
random init runs where it is cheap and reproducible, and the host-to-device
copy moves the narrow representation. The result is an ``nn.Module``
(its float32 parameters and buffers cast) or a tree of tensors in dicts,
lists and tuples. ``device`` is resolved as every entry point resolves it
(:func:`stylex_tpu_torch.device.resolve_device`): the GPU unless ``'cpu'``.
"""

from __future__ import annotations

from typing import Callable

import torch

from stylex_tpu_torch.device import map_tensors, resolve_device

__all__ = ["init_on_host"]


def init_on_host(fn: Callable, *args, dtype=None, device=None):
    """``fn(*args)`` built on the CPU, float32 tensors cast to ``dtype``,
    then placed on ``device``."""
    device = resolve_device(device)
    with torch.device("cpu"):
        out = fn(*args)

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(dtype) if dtype is not None and t.dtype == torch.float32 else t

    if isinstance(out, torch.nn.Module):
        with torch.no_grad():
            for p in out.parameters():
                p.data = cast(p.data)
            for m in out.modules():
                for name, b in m.named_buffers(recurse=False):
                    setattr(m, name, cast(b))
        return out.to(device)
    return map_tensors(out, lambda t: cast(t).to(device))
