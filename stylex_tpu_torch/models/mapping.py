"""StyleVectorizer: the mapping network z -> w.

L2-normalise the latent, then ``depth`` x [EqualLinear(lr_mul), leaky_relu(0.2)].
State-dict keys are the reference's ``net.{2i}.weight``/``net.{2i}.bias``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stylex_tpu_torch.models.layers import EqualLinear

__all__ = ["StyleVectorizer"]


class StyleVectorizer(nn.Module):
    def __init__(self, emb: int, depth: int = 8, lr_mul: float = 0.1):
        super().__init__()
        layers = []
        for _ in range(depth):
            layers += [EqualLinear(emb, emb, lr_mul), nn.LeakyReLU(0.2)]
        self.net = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.net(F.normalize(z, dim=1))
