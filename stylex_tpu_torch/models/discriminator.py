"""Discriminator / encoder: the shared D/E trunk, NCHW.

One module serves three heads:

* ``mode='disc'``: unconditional critic, fc -> 1 (OLD architecture);
* ``mode='cond_disc'``: projection critic, fc -> num_classes, then the
  probability-weighted sum (NEW architecture);
* ``mode='encoder'``: the encoder E, fc -> encoder_dim, the first dims of w.

Each downsampling block blurs (``blur3``) and then runs a stride-2 3x3 conv
with padding 1, as the reference does. With fusion on (``ops.fusion``) a
block of at most 128 channels on an even map of at least 4x4 runs the two
as one stride-2 5x5 conv (``ops.downconv``); the wider blocks keep the blur
kernel. Optional linear attention (``attn_layers``) and vector quantization
(``fq_layers``, EMA codebooks in buffers) follow block ``ind`` when
``ind + 1`` is listed. The fc reads the final 2x2 map flattened in torch's
(C, 2, 2) order.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from stylex_tpu_torch.models.layers import AttnAndFF, Conv2d, Linear
from stylex_tpu_torch.ops.blur import blur3
from stylex_tpu_torch.ops.downconv import blur_conv3x3_down2
from stylex_tpu_torch.ops.fusion import resample_fusion_enabled
from stylex_tpu_torch.ops.vq import VectorQuantize

__all__ = ["Blur", "DiscriminatorBlock", "DiscriminatorE", "discriminator_filters"]

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def discriminator_filters(image_size: int, network_capacity: int = 16, fmap_max: int = 512):
    """Channel plan ``[3, cap*4, cap*8, ...]`` capped at ``fmap_max``."""
    num_layers = int(math.log2(image_size) - 1)
    filters = [(network_capacity * 4) * (2 ** i) for i in range(num_layers + 1)]
    return [3] + [min(f, fmap_max) for f in filters]


class Blur(nn.Module):
    """The binomial blur as a module; it holds no state (the reference's
    tap buffer is dropped on load)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return blur3(x)


class DiscriminatorBlock(nn.Module):
    """Residual conv block with blur-antialiased downsampling."""

    def __init__(self, input_channels: int, filters: int, downsample: bool = True):
        super().__init__()
        self.conv_res = Conv2d(input_channels, filters, 1, stride=2 if downsample else 1)
        self.net = nn.Sequential(
            Conv2d(input_channels, filters, 3, padding=1),
            nn.LeakyReLU(0.2),
            Conv2d(filters, filters, 3, padding=1),
            nn.LeakyReLU(0.2),
        )
        self.downsample = (
            nn.Sequential(Blur(), Conv2d(filters, filters, 3, padding=1, stride=2))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.conv_res(x)
        x = self.net(x)
        if self.downsample is not None:
            x = self._downsample(x)
        return (x + res) * _INV_SQRT2

    def _downsample(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        conv = self.downsample[1]
        # the fused conv does (25 - 9) / 9 more multiply-adds than the pair
        # for the full-resolution round trip it saves: the JAX package fuses
        # the blocks of at most 128 channels, and so does the port
        if (h >= 4 and w >= 4 and h % 2 == 0 and w % 2 == 0 and conv.out_channels <= 128
                and resample_fusion_enabled()):
            return blur_conv3x3_down2(x, conv.weight) + conv.bias.to(x.dtype)[:, None, None]
        return self.downsample(x)


class DiscriminatorE(nn.Module):
    def __init__(self, image_size: int, network_capacity: int = 16, attn_layers=(),
                 transparent: bool = False, mode: str = "disc", encoder_dim: int = 512,
                 num_classes: int = 2, fmap_max: int = 512, fq_layers=(),
                 fq_dict_size: int = 256):
        super().__init__()
        if mode not in ("disc", "cond_disc", "encoder"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        filters = discriminator_filters(image_size, network_capacity, fmap_max)
        if transparent:
            filters[0] = 4
        pairs = list(zip(filters[:-1], filters[1:]))
        self.blocks = nn.ModuleList([
            DiscriminatorBlock(c_in, c_out, downsample=ind != len(pairs) - 1)
            for ind, (c_in, c_out) in enumerate(pairs)
        ])
        # after block ind where ind + 1 is listed (None elsewhere: no keys)
        self.attn_blocks = nn.ModuleList([
            AttnAndFF(c_out) if ind + 1 in tuple(attn_layers) else None
            for ind, (_, c_out) in enumerate(pairs)
        ])
        self.quantize_blocks = nn.ModuleList([
            VectorQuantize(c_out, fq_dict_size) if ind + 1 in tuple(fq_layers) else None
            for ind, (_, c_out) in enumerate(pairs)
        ])
        chan_last = filters[-1]
        self.final_conv = Conv2d(chan_last, chan_last, 3, padding=1)
        out_dim = {"disc": 1, "cond_disc": num_classes, "encoder": encoder_dim}[mode]
        self.fc = Linear(2 * 2 * chan_last, out_dim)

    def forward(self, x: torch.Tensor, probabilities: Optional[torch.Tensor] = None, *,
                return_features: bool = False, return_q_loss: bool = False,
                update_vq: bool = False, vq_reduce=None):
        """(B, 3, S, S) images in [0, 1] -> (B,) critic scores for
        'disc'/'cond_disc' (the latter weighted by ``probabilities``), or
        (B, encoder_dim) for 'encoder'.

        ``return_features``: the flattened trunk features (B, C*2*2)
        instead of the head's output (the contrastive regulariser's input).
        ``return_q_loss``: also return the sum of the quantize layers'
        commitment losses (0 without ``fq_layers``). ``update_vq``: apply
        the codebooks' EMA update from this batch, its statistics summed by
        ``vq_reduce`` (the ranks' sum, where each holds a slice).
        """
        q_loss = x.new_zeros(())
        for block, attn, vq in zip(self.blocks, self.attn_blocks, self.quantize_blocks):
            x = block(x)
            if attn is not None:
                x = attn(x)
            if vq is not None:
                x, loss = vq(x, update=update_vq, reduce=vq_reduce)
                q_loss = q_loss + loss
        out = self.final_conv(x).flatten(1)  # (B, C*2*2), torch's order
        if not return_features:
            out = self.fc(out)
            if self.mode == "cond_disc":
                out = (out * probabilities).sum(dim=-1)
            elif self.mode == "disc":
                out = out[:, 0]
        return (out, q_loss) if return_q_loss else out
