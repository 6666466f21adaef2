"""Which resample graph the generator and D/E take: fused or literal.

The polyphase fusions (``ops/upconv.py``, ``ops.blur.upsample2x_blur``,
``ops/downconv.py``) compute the literal graph's function to rounding with
other ops, so the choice is one of speed, made per workload as in the JAX
package: training takes the fused graph, the AttFind sweep the literal one
(which launches the upsample kernel at every block entry).

``STYLEX_TPU_NO_FUSED_UPCONV`` decides first: unset means the workload
default; ``0`` forces the fused graph everywhere; any other value forces
the literal graph everywhere. The workload default is a :mod:`contextvars`
flag, so one thread's sweep does not switch another thread's training.

Eager PyTorch reads the policy at call time: each fusion site asks
:func:`resample_fusion_enabled` on every forward. (The JAX package reads it
once, when a function is traced.)
"""

from __future__ import annotations

import contextlib
import contextvars
import os

__all__ = ["resample_fusion_enabled", "prefer_literal_resample"]

_ENV = "STYLEX_TPU_NO_FUSED_UPCONV"

# the workload default: False -> fused (training); prefer_literal_resample()
# sets it for the AttFind sweep
_PREFER_LITERAL = contextvars.ContextVar("stylex_prefer_literal_resample", default=False)


def resample_fusion_enabled() -> bool:
    """True when the fusion sites should take the fused graph now. An
    explicit ``STYLEX_TPU_NO_FUSED_UPCONV`` wins over the workload default:
    ``0`` forces fusion on, any other value off."""
    env = os.environ.get(_ENV)
    if env is not None:
        return env == "0"
    return not _PREFER_LITERAL.get()


@contextlib.contextmanager
def prefer_literal_resample():
    """Default the calls made inside to the literal resample graph. An
    explicit ``STYLEX_TPU_NO_FUSED_UPCONV`` still wins."""
    token = _PREFER_LITERAL.set(True)
    try:
        yield
    finally:
        _PREFER_LITERAL.reset(token)
