"""Building-block layers with the reference's initialisation.

The reference initialises every ``nn.Conv2d``/``nn.Linear`` weight with
kaiming-normal (fan-in, leaky-relu gain with slope 0, so std
``sqrt(2 / fan_in)``) while biases keep torch's default
``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``; ``EqualLinear`` keeps a unit-normal
weight and a zero bias, both scaled by ``lr_mul`` at call time. Every
``reset_parameters`` here takes an optional ``torch.Generator`` so that a
model built from a seed is the same on every run.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stylex_tpu_torch.ops.conv import conv2d

__all__ = [
    "leaky_relu",
    "kaiming_normal_leaky_",
    "bias_uniform_",
    "Linear",
    "Conv2d",
    "EqualLinear",
    "ChanNorm",
    "LinearAttention",
    "AttnAndFF",
]


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """The reference's ``leaky_relu(0.2)``."""
    return F.leaky_relu(x, negative_slope)


@torch.no_grad()
def kaiming_normal_leaky_(weight: torch.Tensor, generator: Optional[torch.Generator] = None):
    """torch ``kaiming_normal_(a=0, mode='fan_in', nonlinearity='leaky_relu')``."""
    fan_in = weight[0].numel()
    return weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


@torch.no_grad()
def bias_uniform_(bias: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None):
    """torch's default Linear/Conv bias init."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return bias.uniform_(-bound, bound, generator=generator)


class Linear(nn.Linear):
    """``nn.Linear`` with the reference's init."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        kaiming_normal_leaky_(self.weight, generator)
        if self.bias is not None:
            bias_uniform_(self.bias, self.in_features, generator)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with the reference's init, through :func:`ops.conv.conv2d`
    (dilation 1)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride, self.padding, self.groups)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        kaiming_normal_leaky_(self.weight, generator)
        if self.bias is not None:
            bias_uniform_(self.bias, self.weight[0].numel(), generator)


class EqualLinear(nn.Module):
    """Equalized-learning-rate linear: weight ~ N(0, 1), bias zero, both
    scaled by ``lr_mul`` in the forward pass."""

    def __init__(self, in_dim: int, out_dim: int, lr_mul: float = 1.0, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if bias else None
        self.lr_mul = lr_mul
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.normal_(0.0, 1.0, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias * self.lr_mul
        return F.linear(x, self.weight * self.lr_mul, bias)


# ------------------------------------------------------------ attention
# The reference's ``attn_and_ff`` block, with its module nesting (and so its
# state-dict keys): Sequential(Residual(PreNorm(LinearAttention)),
# Residual(PreNorm(Sequential(conv 1x1, leaky relu, conv 1x1)))).


class ChanNorm(nn.Module):
    """Normalises over channels with the biased variance:
    ``(x - mean) / (std + eps) * g + b``."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))
        self.b = nn.Parameter(torch.zeros(1, dim, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(x, dim=1, unbiased=False, keepdim=True)
        return (x - mean) / (var.sqrt() + self.eps) * self.g + self.b


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = ChanNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x) + x


class DepthWiseConv2d(nn.Module):
    """A depthwise conv (groups = channels), then a 1x1 conv."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int, padding: int = 0,
                 bias: bool = True):
        super().__init__()
        self.net = nn.Sequential(
            Conv2d(dim_in, dim_in, kernel_size, padding=padding, groups=dim_in, bias=bias),
            Conv2d(dim_in, dim_out, 1, bias=bias),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class LinearAttention(nn.Module):
    """Linear attention over the positions of a feature map: q is
    softmaxed over features and k over positions, so the context ``k^T v``
    is (dim_head x dim_head) per head whatever the map's size. The two
    products are ``torch.matmul``; GELU is exact."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        self.heads, self.scale = heads, dim_head ** -0.5
        inner = dim_head * heads
        self.to_q = Conv2d(dim, inner, 1, bias=False)
        self.to_kv = DepthWiseConv2d(dim, inner * 2, 3, padding=1, bias=False)
        self.to_out = Conv2d(inner, dim, 1)

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        b, _, h, w = fmap.shape
        q = self.to_q(fmap)
        k, v = self.to_kv(fmap).chunk(2, dim=1)

        def to_heads(t):  # (b, heads * d, h, w) -> (b, heads, h * w, d)
            return t.reshape(b, self.heads, -1, h * w).transpose(-1, -2)

        q, k, v = map(to_heads, (q, k, v))
        q = q.softmax(dim=-1) * self.scale
        k = k.softmax(dim=-2)
        out = q @ (k.transpose(-1, -2) @ v)  # (b, heads, h * w, d)
        out = out.transpose(-1, -2).reshape(b, -1, h, w)
        return self.to_out(F.gelu(out))


class AttnAndFF(nn.Sequential):
    """Residual pre-norm linear attention, then a residual pre-norm 1x1-conv
    feed-forward (width 2 * dim, leaky ReLU 0.2)."""

    def __init__(self, dim: int):
        super().__init__(
            Residual(PreNorm(dim, LinearAttention(dim))),
            Residual(PreNorm(dim, nn.Sequential(
                Conv2d(dim, dim * 2, 1), nn.LeakyReLU(0.2), Conv2d(dim * 2, dim, 1)))),
        )
