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
    (groups and dilation 1)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride, self.padding)

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
