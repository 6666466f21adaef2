"""2-D convolution of the trainable nets (NCHW / OIHW).

cuDNN's float32 algorithms (Winograd, FFT) compute weight gradients to
about 2e-5 of their magnitude at StylEx's 3x3 stride-1 shapes and to 1e-3
at a 5x5 one, where a direct sum keeps under 1e-6 (against float64, with
TF32 off, on an H100 80GB HBM3 with cuDNN 9.2: ``chip_smoke.py`` phase 6).
A train step amplifies that: its encoder and G gradients drifted to ~4e-4
x max|g| from a float64 witness, against ~1e-4 for the CPU. So a float32
convolution on a CUDA tensor that autograd records runs as im2col and one
batched matmul per group (cuBLAS, IEEE float32): every derivative of it,
of any order, is a matmul or a gather/scatter. Everything else (no
gradient, bfloat16, the CPU) calls ``F.conv2d``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv2d", "conv2d_gemm"]

# the im2col path for float32 CUDA convolutions under autograd; off, they
# go to cuDNN too (chip_smoke.py turns it off to measure cuDNN's drift)
GEMM_FLOAT32 = True


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d_gemm(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1,
                padding=0, groups: int = 1) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, padding, groups=groups)`` as
    im2col (zero pad, strided window views, one copy) and one matmul per
    image and group."""
    n, c, _, _ = x.shape
    o, _, kh, kw = weight.shape
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph))
    win = x.unfold(2, kh, sh).unfold(3, kw, sw)  # (n, c, oh, ow, kh, kw) view
    oh, ow = win.shape[2], win.shape[3]
    cols = win.permute(0, 1, 4, 5, 2, 3)
    if groups == 1:
        # (o, K) @ (n, K, L). The grouped form below costs an ungrouped conv
        # more: its 4-D broadcast adds a batch reduction to the weight
        # gradient (~5 ms of a 95 ms float32 train step on an H100)
        y = weight.reshape(o, -1) @ cols.reshape(n, c * kh * kw, oh * ow)
    else:
        cols = cols.reshape(n, groups, c // groups * kh * kw, oh * ow)
        y = weight.reshape(groups, o // groups, -1) @ cols  # (n, groups, o / groups, L)
    y = y.reshape(n, o, oh * ow)
    if bias is not None:
        y = y + bias[:, None]
    return y.reshape(n, o, oh, ow)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1,
           padding=0, groups: int = 1) -> torch.Tensor:
    """``F.conv2d``, through :func:`conv2d_gemm` for float32 CUDA tensors
    while autograd records."""
    if GEMM_FLOAT32 and x.is_cuda and x.dtype == torch.float32 and torch.is_grad_enabled():
        return conv2d_gemm(x, weight, bias, stride, padding, groups)
    return F.conv2d(x, weight, bias, stride, padding, groups=groups)
