"""The blur and the stride-2 3x3 convolution of a D/E downsampling block as
one stride-2 convolution, NCHW / OIHW.

The block's downsample is ``blur3`` (reflect padding) followed by a 3x3
convolution with stride 2 and zero padding 1. Both are linear, so they
compose into one stride-2 convolution with the 5x5 kernel
``K[t] = sum_b W[b] B[t - b]`` (B = [1, 2, 1] / 4 per axis) over the
reflect-padded input: the full-resolution blurred map is never written.

The composed formula is exact for every output row and column but the
first, where the convolution's zero padding crosses the blur's border.
That row and that column are computed by the literal pair on a 3-wide
input strip, whose leading reflect padding is the full op's. The result
equals the literal pair to rounding.

The JAX package computes this op in XLA, outside any Pallas kernel; here
it is ``ops.conv.conv2d`` and tensor ops, and the strips blur through
:func:`ops.blur.blur3`, which launches the blur kernel on CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stylex_tpu_torch.ops.blur import blur3
from stylex_tpu_torch.ops.conv import conv2d

__all__ = ["compose_blur_conv_kernel", "blur_conv3x3_down2"]

# M[t, b] = B[t - b]: the full 1-D composition of a 3-tap kernel with the
# binomial blur B = [0.25, 0.5, 0.25]
_M = ((0.25, 0.0, 0.0), (0.5, 0.25, 0.0), (0.25, 0.5, 0.25), (0.0, 0.25, 0.5), (0.0, 0.0, 0.25))


def compose_blur_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """(out, in, 3, 3) kernel -> the (out, in, 5, 5) kernel of blur3
    followed by it."""
    m = w.new_tensor(_M)
    return torch.einsum("Ab,Cd,oibd->oiAC", m, m, w)


def _literal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return conv2d(blur3(x.contiguous()), w, stride=2, padding=1)


def blur_conv3x3_down2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv3x3(blur3(x), w, stride=2, padding=1)`` as one convolution.

    Args:
      x: (B, C, H, W) with H, W even and at least 4.
      w: (out_ch, C, 3, 3), the stored parameter (composed here, so
        checkpoints keep the 3x3 layout).

    Returns:
      (B, out_ch, H / 2, W / 2).
    """
    w = w.to(x.dtype)
    u = F.pad(x, (1, 1, 1, 1), mode="reflect")
    # one zero row and column in front align output o with u[2o-1 .. 2o+3];
    # the o = 0 row and column it gets wrong are replaced below
    up = F.pad(u, (1, 0, 1, 0))
    z = conv2d(up, compose_blur_conv_kernel(w), stride=2)
    row0 = _literal(x[:, :, 0:3], w)[:, :, 0:1]
    col0 = _literal(x[:, :, :, 0:3], w)[:, :, :, 0:1]
    body = torch.cat([col0[:, :, 1:], z[:, :, 1:, 1:]], dim=3)
    return torch.cat([row0, body], dim=2)
