"""Bilinear 2x upsample and a 3x3 'same' convolution as one coarse-grid
convolution (polyphase), NCHW / OIHW.

The generator's block entry is ``conv3x3(upsample2x_bilinear(x))``. Both
are linear, so for each of the four output phases (py, px) the half-pixel
bilinear taps compose with the 3x3 kernel into another 3x3 kernel on the
coarse grid. One convolution with ``4 * out_ch`` outputs computes all four
phases, and a depth-to-space shuffle gives the fine grid: the same
operations as the literal pair, and no 4x-area intermediate.

The interior formula assumes clamp-free taps and in-range neighbours,
which holds for fine rows and columns 2 .. 2N-3. The two outer fine rows
and columns on each side are computed by the literal composition on
3-wide coarse strips, whose clamp and zero padding at that side are the
full op's. So the result equals ``conv3x3_same(upsample2x_bilinear(x))``
everywhere, to rounding.

The strips upsample through :func:`ops.blur.upsample2x_bilinear`, which
launches the hand-written kernel on CUDA tensors: one launch per strip,
where the JAX package's elementwise formulation of the same upsample
(slices, concatenations, a stack and a reshape per axis) would be about
ten eager launches. The JAX package computes this op in XLA, outside any
Pallas kernel; here it is ``ops.conv.conv2d`` and tensor ops.
"""

from __future__ import annotations

import torch

from stylex_tpu_torch.ops.blur import upsample2x_bilinear
from stylex_tpu_torch.ops.conv import conv2d

__all__ = ["compose_upsample2x_kernel", "upsample2x_conv3x3_same"]

# M[phase][u, a]: the weight with which fine-kernel tap u reaches coarse
# neighbour x[i + a - 1] for output phase 0 (fine 2i) or 1 (fine 2i + 1):
#   y[2i] = x[i-1]/4 + 3x[i]/4,  y[2i+1] = 3x[i]/4 + x[i+1]/4
_M = (
    ((0.75, 0.25, 0.0), (0.25, 0.75, 0.0), (0.0, 0.75, 0.25)),
    ((0.25, 0.75, 0.0), (0.0, 0.75, 0.25), (0.0, 0.25, 0.75)),
)


def compose_upsample2x_kernel(w: torch.Tensor) -> torch.Tensor:
    """(out, in, 3, 3) fine-grid kernel -> (4 * out, in, 3, 3) coarse-grid
    kernel, output channels in (py, px, out) order."""
    phases = []
    for py in (0, 1):
        for px in (0, 1):
            m_y = w.new_tensor(_M[py])
            m_x = w.new_tensor(_M[px])
            phases.append(torch.einsum("ua,vb,oiuv->oiab", m_y, m_x, w))
    return torch.cat(phases, dim=0)


def _reference_composition(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The literal op: bilinear 2x (half-pixel, edge clamp), then the conv."""
    return conv2d(upsample2x_bilinear(x.contiguous()), w.to(x.dtype), padding=1)


def upsample2x_conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv3x3_same(upsample2x_bilinear(x), w)`` without the fine-grid
    intermediate.

    Args:
      x: (batch, in_ch, H, W).
      w: (out_ch, in_ch, 3, 3) fine-grid kernel; the coarse kernel is
        derived here, linearly, so gradients reach ``w`` itself.

    Returns:
      (batch, out_ch, 2H, 2W). Below 3x3 input it is the literal pair.
    """
    b, _, h, wd = x.shape
    if h < 3 or wd < 3:
        return _reference_composition(x, w)
    cout = w.shape[0]
    z = conv2d(x, compose_upsample2x_kernel(w).to(x.dtype), padding=1)  # (b, 4*cout, h, wd)
    z = z.reshape(b, 2, 2, cout, h, wd).permute(0, 3, 4, 1, 5, 2)  # (b, cout, h, py, wd, px)
    z = z.reshape(b, cout, 2 * h, 2 * wd)

    # the exact two outer fine rows, then columns, from 3-wide strips
    z[:, :, :2] = _reference_composition(x[:, :, :3], w)[:, :, :2]
    z[:, :, -2:] = _reference_composition(x[:, :, -3:], w)[:, :, -2:]
    z[:, :, :, :2] = _reference_composition(x[:, :, :, :3], w)[:, :, :, :2]
    z[:, :, :, -2:] = _reference_composition(x[:, :, :, -3:], w)[:, :, :, -2:]
    return z
