"""Where the package's compiled libraries are kept between runs.

The JAX package points XLA's persistent compilation cache at a directory
per backend and host. The port compiles nothing through a framework cache:
what it builds are its CUDA kernels (``csrc/*.cu`` by ``nvcc``) and the
host pixel pipeline (``native/pixel_ops.cpp`` by ``g++``), each a shared
library named by a hash of its source and flags, in one build directory
(:data:`stylex_tpu_torch.csrc.BUILD_DIR`, by default
``build/stylex_tpu_torch/`` at the root of the checkout). A library in it
is loaded as built; a missing one is built there first.

:func:`enable_persistent_cache` moves that directory to
``<path>/<backend>-<host signature>``, so that libraries outlive a
checkout and a machine never loads another's: the backend is ``cuda``
where a GPU is visible, else ``cpu``, and the signature hashes the host
CPU's model name and flags (or, where ``/proc/cpuinfo`` cannot be read,
platform facts; with no host identity at all it changes nothing). It is
not called by the package itself. ``STYLEX_TPU_NO_CACHE`` (any non-empty
value) opts out: the directory stays where it is.
"""

from __future__ import annotations

import hashlib
import os
import platform
from pathlib import Path
from typing import Optional

import torch

from stylex_tpu_torch import csrc

__all__ = ["enable_persistent_cache"]


def _host_signature() -> Optional[str]:
    """8 hex digits of the host CPU's identity, or None."""
    try:
        lines = []
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "model name")):
                    lines.append(line)
                    if len(lines) == 2:
                        break
        text = "".join(lines)
    except OSError:
        text = ""
    if not text:
        text = "|".join((platform.machine(), platform.processor(), " ".join(os.uname())))
        if not text.strip("| "):
            return None
    return hashlib.sha1(text.encode()).hexdigest()[:8]


def enable_persistent_cache(path: Optional[str] = None) -> bool:
    """Build into and load from ``<path>/<backend>-<host signature>``
    (``path`` defaults to the checkout's ``build/stylex_tpu_torch``).
    Returns whether the directory was set."""
    if os.environ.get("STYLEX_TPU_NO_CACHE"):
        return False
    sig = _host_signature()
    if sig is None:
        return False
    backend = "cuda" if torch.cuda.is_available() else "cpu"
    full = Path(path or csrc.DEFAULT_BUILD_DIR) / f"{backend}-{sig}"
    full.mkdir(parents=True, exist_ok=True)
    csrc.BUILD_DIR = full
    return True
