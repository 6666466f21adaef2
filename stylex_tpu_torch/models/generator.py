"""StylEx generator: StyleGAN2 synthesis with an explicit StyleSpace input.

The same network as the JAX package's generator, in NCHW with the
reference's state-dict keys. Its resample graph follows ``ops.fusion``:

* every block except the first enters through a 2x bilinear upsample: on
  the literal graph ``upsample2x_bilinear`` (a kernel launch on the GPU),
  on the fused graph one polyphase coarse-grid conv
  (``modulated_upsample_conv2d``);
* the RGB skip runs ``upsample2x_blur``: the two kernels on the literal
  graph, one polyphase pass on the fused one;
* optional linear attention before block ``ind`` when
  ``num_layers - ind`` is in ``attn_layers``, and with ``no_const`` a 4x4
  transposed conv of the mean style in place of the learned constant;
* ``remat`` recomputes each block's forward in the backward pass
  (``torch.utils.checkpoint``), trading compute for activation memory;
* ``style_delta`` is added to each block's style activations, in place of
  the reference's AttFind trick of mutating ``to_style{1,2}.bias``;
* the style coordinates (each block's ``style1`` and ``style2``,
  concatenated) are always returned.

Quirks kept for parity with reference checkpoints:

* the per-pixel noise map is spatially transposed before it is added
  (the reference's ``permute(0, 3, 2, 1)`` of the (B, H, W, C) map);
* each block takes the top-left corner of one shared full-size noise image;
* ``to_noise1/2`` start at zero.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from torch.utils.checkpoint import checkpoint

from stylex_tpu_torch.models.layers import (
    AttnAndFF,
    Conv2d,
    Linear,
    kaiming_normal_leaky_,
    leaky_relu,
)
from stylex_tpu_torch.ops.blur import upsample2x_bilinear, upsample2x_blur
from stylex_tpu_torch.ops.fusion import resample_fusion_enabled
from stylex_tpu_torch.ops.modconv import modulated_conv2d, modulated_upsample_conv2d

__all__ = [
    "Generator",
    "GeneratorBlock",
    "RGBBlock",
    "generator_filters",
    "style_coord_dims",
    "num_style_coords",
    "sindex_to_block_and_offset",
]

State = Tuple[torch.Tensor, Optional[torch.Tensor]]


def generator_filters(image_size: int, network_capacity: int = 16, fmap_max: int = 512) -> List[int]:
    """Per-block channel plan ``[init_channels, f1, ..., fn]``, n = log2(size) - 1."""
    num_layers = int(math.log2(image_size) - 1)
    filters = [network_capacity * (2 ** (i + 1)) for i in range(num_layers)][::-1]
    filters = [min(f, fmap_max) for f in filters]
    return [filters[0], *filters]


def style_coord_dims(image_size: int, network_capacity: int = 16,
                     fmap_max: int = 512) -> List[Tuple[int, int]]:
    """Per-block (input_channels, filters); a block's StyleSpace slice has
    ``input_channels + filters`` coordinates."""
    f = generator_filters(image_size, network_capacity, fmap_max)
    return list(zip(f[:-1], f[1:]))


def num_style_coords(image_size: int, network_capacity: int = 16, fmap_max: int = 512) -> int:
    """Total StyleSpace size (2464 at the 64px default config)."""
    return sum(i + o for i, o in style_coord_dims(image_size, network_capacity, fmap_max))


def sindex_to_block_and_offset(sindex: int, image_size: int, network_capacity: int = 16,
                               fmap_max: int = 512) -> Tuple[int, int]:
    """Flat StyleSpace index -> (block index, offset in the block). Offsets
    below the block's input channels land in ``style1``, the rest in ``style2``."""
    remaining = sindex
    for block_idx, (i, o) in enumerate(style_coord_dims(image_size, network_capacity, fmap_max)):
        if remaining < i + o:
            return block_idx, remaining
        remaining -= i + o
    raise IndexError(f"style index {sindex} out of range")


class Conv2DMod(nn.Module):
    """Holds a modulated conv's (out, in, k, k) weight under the reference's
    ``conv.weight`` key."""

    def __init__(self, in_chan: int, out_chan: int, kernel: int, demod: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_chan, in_chan, kernel, kernel))
        self.demod = demod
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        kaiming_normal_leaky_(self.weight, generator)

    def forward(self, x: torch.Tensor, style: torch.Tensor, upsample: bool = False) -> torch.Tensor:
        """The modulated conv of ``x``, or with ``upsample`` of the 2x
        bilinear upsample of ``x``, fused into one coarse-grid conv."""
        fn = modulated_upsample_conv2d if upsample else modulated_conv2d
        return fn(x, self.weight, style, demod=self.demod)


class NoiseLinear(Linear):
    """``Linear(1, C)`` that maps the noise image to per-channel noise;
    zero-initialised as in the reference."""

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.zero_()
        self.bias.zero_()


class InitialBlockConv(nn.ConvTranspose2d):
    """The ``no_const`` stem: a bias-free 4x4 transposed conv of the mean
    style (B, latent) as a 1x1 map -> (B, C, 4, 4). On a 1x1 input it is one
    matmul, ``out[b, o, i, j] = sum_c s[b, c] W[c, o, i, j]``, which is how
    it runs. Weight (latent, C, 4, 4) under the reference's key."""

    def __init__(self, latent_dim: int, channels: int):
        super().__init__(latent_dim, channels, 4, bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        # kaiming-normal with fan_in = latent * 4 * 4, as the JAX package's
        # (4, 4, latent, C) kernel
        fan_in = self.weight.shape[0] * 16
        self.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)

    def forward(self, style: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(style.dtype)
        return (style @ w.reshape(w.shape[0], -1)).reshape(-1, *w.shape[1:])


class RGBBlock(nn.Module):
    """Per-block to-RGB skip path."""

    def __init__(self, latent_dim: int, input_channel: int, upsample: bool, rgba: bool = False):
        super().__init__()
        self.to_style = Linear(latent_dim, input_channel)
        self.conv = Conv2DMod(input_channel, 4 if rgba else 3, 1, demod=False)
        self.upsample = upsample

    def forward(self, x, prev_rgb, istyle):
        x = self.conv(x, self.to_style(istyle))
        if prev_rgb is not None:
            x = x + prev_rgb
        if self.upsample:
            x = upsample2x_blur(x)
        return x


class GeneratorBlock(nn.Module):
    """One synthesis block; ``delta1``/``delta2`` are additive perturbations
    of the style activations."""

    def __init__(self, latent_dim: int, input_channels: int, filters: int,
                 upsample: bool = True, upsample_rgb: bool = True, rgba: bool = False):
        super().__init__()
        self.upsample = upsample
        self.to_style1 = Linear(latent_dim, input_channels)
        self.to_noise1 = NoiseLinear(1, filters)
        self.conv1 = Conv2DMod(input_channels, filters, 3)
        self.to_style2 = Linear(latent_dim, filters)
        self.to_noise2 = NoiseLinear(1, filters)
        self.conv2 = Conv2DMod(filters, filters, 3)
        self.to_rgb = RGBBlock(latent_dim, filters, upsample_rgb, rgba)

    def forward(self, x, prev_rgb, istyle, inoise, delta1=None, delta2=None):
        # the upsample is folded into conv1 on the fused graph
        fuse_up = self.upsample and resample_fusion_enabled()
        if self.upsample and not fuse_up:
            x = upsample2x_bilinear(x)
        h, w = x.shape[-2:]
        if fuse_up:
            h, w = 2 * h, 2 * w
        inoise = inoise[:, :h, :w, :]
        # (B, h, w, C) -> (B, C, w, h): the reference's spatial transpose
        noise1 = self.to_noise1(inoise).permute(0, 3, 2, 1)
        noise2 = self.to_noise2(inoise).permute(0, 3, 2, 1)

        style1 = self.to_style1(istyle)
        if delta1 is not None:
            style1 = style1 + delta1
        x = leaky_relu(self.conv1(x, style1, upsample=fuse_up) + noise1)

        style2 = self.to_style2(istyle)
        if delta2 is not None:
            style2 = style2 + delta2
        style_coords = torch.cat([style1, style2], dim=-1)
        x = leaky_relu(self.conv2(x, style2) + noise2)

        rgb = self.to_rgb(x, prev_rgb, istyle)
        return x, rgb, style_coords


class Generator(nn.Module):
    """Full synthesis network."""

    def __init__(self, image_size: int, latent_dim: int, network_capacity: int = 16,
                 transparent: bool = False, attn_layers=(), no_const: bool = False,
                 fmap_max: int = 512, remat: bool = False):
        super().__init__()
        self.image_size = image_size
        self.num_layers = int(math.log2(image_size) - 1)
        self.block_dims = style_coord_dims(image_size, network_capacity, fmap_max)
        self.total_style_coords = sum(i + o for i, o in self.block_dims)
        self.no_const, self.remat = no_const, remat
        init_channels = self.block_dims[0][0]
        if no_const:
            self.to_initial_block = InitialBlockConv(latent_dim, init_channels)
        else:
            self.initial_block = nn.Parameter(torch.randn(1, init_channels, 4, 4))
        self.initial_conv = Conv2d(init_channels, init_channels, 3, padding=1)
        # attention before block ind where num_layers - ind is listed (None
        # elsewhere: no keys in the state dict)
        self.attns = nn.ModuleList([
            AttnAndFF(in_chan) if self.num_layers - ind in tuple(attn_layers) else None
            for ind, (in_chan, _) in enumerate(self.block_dims)
        ])
        self.blocks = nn.ModuleList([
            GeneratorBlock(
                latent_dim, in_chan, out_chan,
                upsample=ind != 0,
                upsample_rgb=ind != (self.num_layers - 1),
                rgba=transparent,
            )
            for ind, (in_chan, out_chan) in enumerate(self.block_dims)
        ])

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if not self.no_const:
            self.initial_block.normal_(0.0, 1.0, generator=generator)

    def forward(self, styles: torch.Tensor, input_noise: torch.Tensor,
                style_delta: Optional[torch.Tensor] = None, start_block: int = 0,
                initial_state: Optional[State] = None, capture_states: bool = False):
        """Synthesise images, optionally resuming from a cached block state.

        A StyleSpace perturbation at block k changes nothing upstream of
        block k, so a sweep can cache each image's block-entry states once
        and re-run only blocks k.. per perturbation.

        Args:
          styles: (B, num_layers, latent_dim) per-layer w.
          input_noise: (B or 1, S, S, 1) uniform noise image; batch 1
            broadcasts over the batch.
          style_delta: optional (B, total_style_coords) additive StyleSpace
            perturbation (full width even when resuming).
          start_block: index of the first block to run.
          initial_state: the (x, rgb) entry state of ``start_block``;
            required when ``start_block > 0``, and at 0 it replaces the stem.
          capture_states: also return every block's (x, rgb) entry state.

        Returns:
          (rgb, style_coords[, states]): the (B, 3, S, S) image, the
          (B, total_style_coords) coordinates (blocks before ``start_block``
          zero-filled) and, when capturing, the list of entry states.
        """
        batch = styles.shape[0]
        if initial_state is not None:
            x, rgb = initial_state
        elif start_block == 0:
            if self.no_const:
                x = self.initial_conv(self.to_initial_block(styles.mean(dim=1)))
            else:
                # the stem conv commutes with the batch broadcast of the
                # learned constant: conv once at batch 1, broadcast the output
                seed = self.initial_conv(self.initial_block.to(styles.dtype))
                x = seed.expand(batch, -1, -1, -1)
            rgb = None
        else:
            raise ValueError("start_block > 0 requires initial_state=(x, rgb)")

        remat = self.remat and torch.is_grad_enabled()
        coords, states = [], []
        offset = 0
        for ind, (block, (in_chan, out_chan)) in enumerate(zip(self.blocks, self.block_dims)):
            size = in_chan + out_chan
            if ind < start_block:
                coords.append(styles.new_zeros(batch, size))
                offset += size
                continue
            if capture_states:
                states.append((x, rgb))
            if self.attns[ind] is not None:
                x = self.attns[ind](x)
            d1 = d2 = None
            if style_delta is not None:
                d1 = style_delta[:, offset:offset + in_chan]
                d2 = style_delta[:, offset + in_chan:offset + size]
            offset += size
            args = (x, rgb, styles[:, ind], input_noise, d1, d2)
            if remat:
                x, rgb, block_coords = checkpoint(block, *args, use_reentrant=False)
            else:
                x, rgb, block_coords = block(*args)
            coords.append(block_coords)

        out = (rgb, torch.cat(coords, dim=-1))
        if capture_states:
            out += (states,)
        return out
