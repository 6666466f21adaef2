"""Small debug encoders, selected by ``ModelConfig.encoder_class`` through
:data:`encoder_registry`, as in the JAX package's ``debug_encoders.py``.

Each is a stack of 3x3 convs with padding 1 and a linear layer to a
512-wide encoding, NCHW, flattened in torch's (C, H, W) order. The linear
layer's width follows the image size given at construction.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stylex_tpu_torch.models.layers import Conv2d, Linear, leaky_relu

__all__ = ["DebugEncoder", "PhillipEncoder", "PhillipEncoder64", "encoder_registry"]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class _ConvEncoder(nn.Module):
    """Convs ``conv{first}``, ``conv{first+1}``, ... of ``plan`` ((channels,
    stride) each), each followed by the activation, then the linear layer
    ``fc_name``."""

    plan: Sequence[Tuple[int, int]] = ()
    first = 0
    fc_name = "fc"

    def __init__(self, image_size: int, in_channels: int = 3, latent_dim: int = 512):
        super().__init__()
        c_in, size = in_channels, image_size
        for i, (c, stride) in enumerate(self.plan):
            setattr(self, f"conv{self.first + i}", Conv2d(c_in, c, 3, stride=stride, padding=1))
            c_in, size = c, (size - 1) // stride + 1
        setattr(self, self.fc_name, Linear(c_in * size * size, latent_dim))

    def activation(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x)

    def forward(self, x: torch.Tensor, probabilities: Optional[torch.Tensor] = None):
        for i in range(len(self.plan)):
            x = self.activation(getattr(self, f"conv{self.first + i}")(x))
        return getattr(self, self.fc_name)(x.flatten(1))


class DebugEncoder(_ConvEncoder):
    """ImageNet normalisation, three stride-2 convs of 32 channels with
    leaky ReLU, a linear layer and a last leaky ReLU."""

    plan = ((32, 2),) * 3
    first = 1
    fc_name = "linear1"

    def activation(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x)

    def forward(self, x: torch.Tensor, probabilities: Optional[torch.Tensor] = None):
        mean = x.new_tensor(_IMAGENET_MEAN).view(1, 3, 1, 1)
        std = x.new_tensor(_IMAGENET_STD).view(1, 3, 1, 1)
        return leaky_relu(super().forward((x - mean) / std))


class PhillipEncoder(_ConvEncoder):
    """A CIFAR-style conv encoder with exact GELU."""

    plan = ((32, 2), (32, 1), (64, 2), (64, 1), (64, 2))


class PhillipEncoder64(_ConvEncoder):
    """The deeper variant for 64px inputs."""

    plan = ((32, 2), (32, 2), (64, 1), (128, 2), (128, 1), (128, 2))


encoder_registry = {
    "DebugEncoder": DebugEncoder,
    "PhillipEncoder": PhillipEncoder,
    "PhillipEncoder64": PhillipEncoder64,
}
