"""Plain PyTorch operations of the reference, with the precision of their
products chosen by a context.

Every convolution, linear layer and matrix product of the reference goes
through :func:`conv2d`, :func:`linear` or :func:`matmul`. Under
:func:`precision` their operands are rounded first, as lower-precision
hardware rounds them before it multiplies (accumulation stays float32):

* ``"float32"``: no rounding (the reference proper; TF32 is off);
* ``"tf32"``: the operands rounded to TF32's 10-bit mantissa.

The rounding passes gradients straight through, so a lower-precision
reference still trains. TF32 exists for the control that shows a
comparison fails at the precision below the configuration's
(:func:`control_for`).

This file imports nothing but torch.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

_MODE = contextvars.ContextVar("benchmark_reference_precision", default="float32")
MODES = ("float32", "tf32")
# the precision below each precision a configuration can state
BELOW = {"float32": "tf32"}


def control_for(compute_dtype: str) -> str:
    """The control's precision for a configuration computing in
    ``compute_dtype``: the nearest one below it."""
    if compute_dtype not in BELOW:
        raise ValueError(f"no control precision below {compute_dtype!r}")
    return BELOW[compute_dtype]


@contextlib.contextmanager
def precision(mode: str):
    """Round the operands of every product made inside to ``mode``."""
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r}")
    token = _MODE.set(mode)
    try:
        yield
    finally:
        _MODE.reset(token)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), kept in float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def q(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its values rounded to the current precision; the gradient
    passes straight through."""
    mode = _MODE.get()
    if mode == "float32" or not x.is_floating_point():
        return x
    with torch.no_grad():
        r = round_tf32(x)
    return x + (r.to(x.dtype) - x).detach()


def conv2d(x, weight, bias=None, stride=1, padding=0, groups=1):
    return F.conv2d(q(x), q(weight), bias, stride, padding, groups=groups)


def linear(x, weight, bias=None):
    return F.linear(q(x), q(weight), bias)


def matmul(a, b):
    return q(a) @ q(b)


def leaky_relu(x):
    return F.leaky_relu(x, 0.2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x, half-pixel centres, edge clamp."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def blur3(x: torch.Tensor) -> torch.Tensor:
    """[1, 2, 1] x [1, 2, 1] / 16 with reflect padding, per channel."""
    c = x.shape[1]
    k = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype, device=x.device)
    k = (k[:, None] * k[None, :]) / 16.0
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), k.expand(c, 1, 3, 3), groups=c)


def modulated_conv2d(x, weight, style, demod: bool = True, eps: float = 1e-8):
    """StyleGAN2's modulated conv: ``demod * conv(x * (style + 1), W)``, with
    ``demod = rsqrt(sum over (in, kh, kw) of (W * (style + 1))^2 + eps)``."""
    s = style + 1.0
    y = conv2d(x * s[:, :, None, None], weight, padding=(weight.shape[-1] - 1) // 2)
    if demod:
        w_sq = weight.square().sum(dim=(2, 3))  # (out, in)
        d = torch.rsqrt(matmul(s.square(), w_sq.t()) + eps)
        y = y * d[:, :, None, None]
    return y
