"""Modulated (style-conditioned) convolution, NCHW / OIHW.

The reference builds a per-sample weight ``W * (style + 1)``, folds the
batch into conv groups and runs one grouped convolution. The same operator
factorises into three stages, which is what the JAX package computes and
this port keeps:

    y[b] = demod[b] * conv(x[b] * (style[b] + 1), W)

Modulation scales input channels, so it commutes through the convolution;
demodulation is a per-(sample, out-channel) scalar

    demod[b, o] = rsqrt(sum_{i,kh,kw} (W[o,i,kh,kw] * (style[b,i] + 1))^2 + eps)

computed as ``(style+1)^2 @ sum_{kh,kw} W^2``. The convolution is one
:func:`ops.conv.conv2d` with the shared weight; no per-sample weights are
built.
"""

from __future__ import annotations

import torch

from stylex_tpu_torch.ops.conv import conv2d
from stylex_tpu_torch.ops.upconv import upsample2x_conv3x3_same

__all__ = ["demod_scale", "modulated_conv2d", "modulated_upsample_conv2d"]


def demod_scale(weight: torch.Tensor, style_plus_one: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """Per-(sample, out-channel) demodulation scale.

    Args:
      weight: (out_ch, in_ch, kh, kw) kernel.
      style_plus_one: (batch, in_ch) modulation scales (already offset by +1).

    Returns:
      (batch, out_ch) ``rsqrt(sum((W * s)^2) + eps)``.
    """
    w_sq = weight.square().sum(dim=(2, 3))  # (out, in)
    return torch.rsqrt(style_plus_one.square() @ w_sq.t() + eps)


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, style: torch.Tensor, *,
                     demod: bool = True, eps: float = 1e-8) -> torch.Tensor:
    """Style-modulated stride-1 'same' convolution with optional demodulation.

    Args:
      x: (batch, in_ch, H, W) input.
      weight: (out_ch, in_ch, k, k) kernel.
      style: (batch, in_ch) raw style vector; the +1 offset is applied here.
      demod: demodulate (True for the backbone convs, False for to-RGB).
    """
    s = style + 1.0
    x = x * s[:, :, None, None].to(x.dtype)
    k = weight.shape[-1]
    y = conv2d(x, weight.to(x.dtype), padding=(k - 1) // 2)
    if demod:
        d = demod_scale(weight, s, eps)
        y = y * d[:, :, None, None].to(y.dtype)
    return y


def modulated_upsample_conv2d(x: torch.Tensor, weight: torch.Tensor, style: torch.Tensor, *,
                              demod: bool = True, eps: float = 1e-8) -> torch.Tensor:
    """``modulated_conv2d(upsample2x_bilinear(x), weight, style)`` without
    the 4x-area intermediate: modulation scales input channels, so it
    commutes with the upsample; the upsample and the 3x3 conv are one
    coarse-grid conv (:mod:`ops.upconv`); demodulation uses the fine
    kernel, as in :func:`modulated_conv2d`. 3x3 kernels only.
    """
    s = style + 1.0
    x = x * s[:, :, None, None].to(x.dtype)
    y = upsample2x_conv3x3_same(x, weight)
    if demod:
        d = demod_scale(weight, s, eps)
        y = y * d[:, :, None, None].to(y.dtype)
    return y
