"""The plain reference networks: StylEx's mapping, generator and D/E trunk,
the frozen classifiers (ResNet-18, MobileNetV2) and LPIPS, float32.

Written from the published description (Lang et al. 2021; StyleGAN2 with
an encoder and the classifier's logits in w) and the reference
implementation's layer plan, with the state-dict keys of the reference's
checkpoints, so one weights dict loads into both the reference and the
program under test. The generator runs the literal resample graph:
bilinear 2x at every block entry but the first, and bilinear 2x then the
binomial blur on the RGB skip. Every product goes through :mod:`.ops`, so a
lower precision can be put in place for the controls.

This file imports nothing but torch and its sibling :mod:`.ops`.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import ops

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


class Conv(nn.Module):
    """A conv's ``weight`` (O, I, k, k) and optional ``bias``."""

    def __init__(self, c_in, c_out, k, stride=1, padding=0, groups=1, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x):
        return ops.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.groups)


class Lin(nn.Module):
    def __init__(self, c_in, c_out, bias=True, lr_mul: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.lr_mul = lr_mul

    def forward(self, x):
        b = None if self.bias is None else self.bias * self.lr_mul
        return ops.linear(x, self.weight * self.lr_mul, b)


class WeightOnly(nn.Module):
    """A modulated conv's weight under the key ``weight``."""

    def __init__(self, c_in, c_out, k):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k, k))


# ------------------------------------------------------------------ StylEx


def generator_filters(image_size: int, capacity: int, fmap_max: int) -> List[int]:
    n = int(math.log2(image_size) - 1)
    f = [min(capacity * (2 ** (i + 1)), fmap_max) for i in range(n)][::-1]
    return [f[0], *f]


def block_dims(image_size: int, capacity: int, fmap_max: int) -> List[Tuple[int, int]]:
    """Per generator block (input channels, filters); the block has
    ``input + filters`` StyleSpace coordinates."""
    f = generator_filters(image_size, capacity, fmap_max)
    return list(zip(f[:-1], f[1:]))


class Mapping(nn.Module):
    """z -> w: L2-normalise, then ``depth`` equalised linears with leaky ReLU."""

    def __init__(self, dim: int, depth: int = 8, lr_mul: float = 0.1):
        super().__init__()
        layers = []
        for _ in range(depth):
            layers += [Lin(dim, dim, lr_mul=lr_mul), nn.LeakyReLU(0.2)]
        self.net = nn.Sequential(*layers)

    def forward(self, z):
        return self.net(F.normalize(z, dim=1))


class RGBBlock(nn.Module):
    def __init__(self, latent: int, channels: int, upsample: bool):
        super().__init__()
        self.to_style = Lin(latent, channels)
        self.conv = WeightOnly(channels, 3, 1)
        self.upsample = upsample

    def forward(self, x, prev_rgb, w):
        x = ops.modulated_conv2d(x, self.conv.weight, self.to_style(w), demod=False)
        if prev_rgb is not None:
            x = x + prev_rgb
        return ops.blur3(ops.upsample2x(x)) if self.upsample else x


class GeneratorBlock(nn.Module):
    def __init__(self, latent: int, c_in: int, c_out: int, upsample: bool, upsample_rgb: bool):
        super().__init__()
        self.upsample = upsample
        self.to_style1 = Lin(latent, c_in)
        self.to_noise1 = Lin(1, c_out)
        self.conv1 = WeightOnly(c_in, c_out, 3)
        self.to_style2 = Lin(latent, c_out)
        self.to_noise2 = Lin(1, c_out)
        self.conv2 = WeightOnly(c_out, c_out, 3)
        self.to_rgb = RGBBlock(latent, c_out, upsample_rgb)

    def forward(self, x, prev_rgb, w, noise, delta1=None, delta2=None):
        if self.upsample:
            x = ops.upsample2x(x)
        h, wd = x.shape[-2:]
        noise = noise[:, :h, :wd, :]
        # (B, h, w, C) -> (B, C, w, h): the reference implementation's transpose
        n1 = self.to_noise1(noise).permute(0, 3, 2, 1)
        n2 = self.to_noise2(noise).permute(0, 3, 2, 1)
        s1 = self.to_style1(w)
        if delta1 is not None:
            s1 = s1 + delta1
        x = ops.leaky_relu(ops.modulated_conv2d(x, self.conv1.weight, s1) + n1)
        s2 = self.to_style2(w)
        if delta2 is not None:
            s2 = s2 + delta2
        x = ops.leaky_relu(ops.modulated_conv2d(x, self.conv2.weight, s2) + n2)
        return x, self.to_rgb(x, prev_rgb, w), torch.cat([s1, s2], dim=-1)


class Generator(nn.Module):
    def __init__(self, image_size: int, latent: int, capacity: int, fmap_max: int):
        super().__init__()
        self.dims = block_dims(image_size, capacity, fmap_max)
        self.num_layers = len(self.dims)
        c0 = self.dims[0][0]
        self.initial_block = nn.Parameter(torch.zeros(1, c0, 4, 4))
        self.initial_conv = Conv(c0, c0, 3, padding=1)
        n = self.num_layers
        self.blocks = nn.ModuleList([
            GeneratorBlock(latent, ci, co, upsample=i != 0, upsample_rgb=i != n - 1)
            for i, (ci, co) in enumerate(self.dims)])

    def forward(self, styles, noise, style_delta: Optional[torch.Tensor] = None,
                start_block: int = 0, stop_block: Optional[int] = None, state=None):
        """(B, L, latent) styles and a (B or 1, S, S, 1) noise image ->
        ((B, 3, S, S) image, (B, coords) style coordinates). ``start_block``
        / ``state`` resume from a block's entry state, ``stop_block``
        returns the entry state of that block instead (the FLOP counters
        use both; the comparison runs whole forwards)."""
        b = styles.shape[0]
        if state is None:
            x = self.initial_conv(self.initial_block).expand(b, -1, -1, -1)
            rgb = None
        else:
            x, rgb = state
        coords, offset = [], 0
        for i, (block, (ci, co)) in enumerate(zip(self.blocks, self.dims)):
            if stop_block is not None and i == stop_block:
                return x, rgb
            if i < start_block:
                coords.append(styles.new_zeros(b, ci + co))
                offset += ci + co
                continue
            d1 = d2 = None
            if style_delta is not None:
                d1 = style_delta[:, offset:offset + ci]
                d2 = style_delta[:, offset + ci:offset + ci + co]
            offset += ci + co
            x, rgb, c = block(x, rgb, styles[:, i], noise, d1, d2)
            coords.append(c)
        return rgb, torch.cat(coords, dim=-1)


def disc_filters(image_size: int, capacity: int, fmap_max: int) -> List[int]:
    n = int(math.log2(image_size) - 1)
    return [3] + [min(capacity * 4 * 2 ** i, fmap_max) for i in range(n + 1)]


class DiscBlock(nn.Module):
    def __init__(self, c_in, c_out, downsample: bool):
        super().__init__()
        self.conv_res = Conv(c_in, c_out, 1, stride=2 if downsample else 1)
        self.net = nn.Sequential(Conv(c_in, c_out, 3, padding=1), nn.LeakyReLU(0.2),
                                 Conv(c_out, c_out, 3, padding=1), nn.LeakyReLU(0.2))
        # the blur (no weights) at index 0, the 3x3 stride-2 conv at 1
        self.downsample = (nn.Sequential(nn.Identity(), Conv(c_out, c_out, 3, 2, 1))
                           if downsample else None)

    def forward(self, x):
        res = self.conv_res(x)
        x = self.net(x)
        if self.downsample is not None:
            x = self.downsample[1](ops.blur3(x))
        return (x + res) * _INV_SQRT2


class DiscriminatorE(nn.Module):
    """D (``disc``: one score; ``cond_disc``: class scores weighted by the
    probabilities) or the encoder E (``encoder``: the first dims of w)."""

    def __init__(self, image_size, capacity, fmap_max, mode, encoder_dim=512, num_classes=2):
        super().__init__()
        f = disc_filters(image_size, capacity, fmap_max)
        pairs = list(zip(f[:-1], f[1:]))
        self.blocks = nn.ModuleList([DiscBlock(a, b, i != len(pairs) - 1)
                                     for i, (a, b) in enumerate(pairs)])
        self.final_conv = Conv(f[-1], f[-1], 3, padding=1)
        self.mode = mode
        out = {"disc": 1, "cond_disc": num_classes, "encoder": encoder_dim}[mode]
        self.fc = Lin(4 * f[-1], out)

    def forward(self, x, probabilities=None):
        for block in self.blocks:
            x = block(x)
        out = self.fc(self.final_conv(x).flatten(1))
        if self.mode == "cond_disc":
            return (out * probabilities).sum(dim=-1)
        if self.mode == "disc":
            return out[:, 0]
        return out


class StylEx(nn.Module):
    """encoder, S, G, D and the EMA copies SE, GE, under the checkpoint's keys."""

    def __init__(self, c: dict):
        super().__init__()
        new = c["arch"] == "new"
        size, cap, fmax = c["image_size"], c["network_capacity"], c["fmap_max"]
        mapping = c["latent_dim"] - c["num_classes"] if new else c["latent_dim"]
        self.cfg = c
        self.encoder = DiscriminatorE(size, cap, fmax, "encoder", c["encoder_dim"],
                                      c["num_classes"])
        self.S = Mapping(mapping, c["style_depth"], c["lr_mlp"])
        self.G = Generator(size, c["latent_dim"], cap, fmax)
        self.D = DiscriminatorE(size, cap, fmax, "cond_disc" if new else "disc",
                                c["encoder_dim"], c["num_classes"])
        self.SE = Mapping(mapping, c["style_depth"], c["lr_mlp"])
        self.GE = Generator(size, c["latent_dim"], cap, fmax)

    @property
    def num_layers(self) -> int:
        return self.G.num_layers


def make_w(c: dict, enc: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """w = [E(x); logits] (OLD) or [E(x); softmax(logits)] (NEW)."""
    cond = torch.softmax(logits, dim=-1) if c["arch"] == "new" else logits
    return torch.cat([enc, cond], dim=-1)


# -------------------------------------------------------------- classifiers


class BN(nn.Module):
    """Batch norm with its running statistics (eval mode)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))
        self.eps = eps

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.running_mean[:, None, None]
        return (x - shift) * mul[:, None, None] + self.bias[:, None, None]


def _conv_bn(c_in, c_out, k, stride=1, padding=0, groups=1, relu6=False):
    layers = [Conv(c_in, c_out, k, stride, padding, groups, bias=False), BN(c_out)]
    if relu6:
        layers.append(nn.ReLU6())
    return nn.Sequential(*layers)


class BasicBlock(nn.Module):
    def __init__(self, c_in, c_out, stride=1):
        super().__init__()
        self.conv1 = Conv(c_in, c_out, 3, stride, 1, bias=False)
        self.bn1 = BN(c_out)
        self.conv2 = Conv(c_out, c_out, 3, 1, 1, bias=False)
        self.bn2 = BN(c_out)
        self.downsample = _conv_bn(c_in, c_out, 1, stride) if stride != 1 or c_in != c_out \
            else None

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class ResNet18(nn.Module):
    def __init__(self, num_classes=2):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BN(64)
        c = 64
        for i, (f, s) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
            setattr(self, f"layer{i + 1}", nn.Sequential(BasicBlock(c, f, s), BasicBlock(f, f)))
            c = f
        self.fc = Lin(512, num_classes)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return self.fc(x.mean(dim=(2, 3)))


class InvertedResidual(nn.Module):
    def __init__(self, c_in, c_out, stride, t):
        super().__init__()
        hidden = c_in * t
        self.use_res = stride == 1 and c_in == c_out
        layers = [_conv_bn(c_in, hidden, 1, relu6=True)] if t != 1 else []
        layers += [_conv_bn(hidden, hidden, 3, stride, 1, groups=hidden, relu6=True),
                   Conv(hidden, c_out, 1, bias=False), BN(c_out)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


MBV2_PLAN = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
             (6, 160, 3, 2), (6, 320, 1, 1)]


class MobileNetV2(nn.Module):
    def __init__(self, num_classes=2):
        super().__init__()
        feats = [_conv_bn(3, 32, 3, 2, 1, relu6=True)]
        c = 32
        for t, f, n, s in MBV2_PLAN:
            for i in range(n):
                feats.append(InvertedResidual(c, f, s if i == 0 else 1, t))
                c = f
        feats.append(_conv_bn(c, 1280, 1, relu6=True))
        self.features = nn.Sequential(*feats)
        self.classifier = nn.Sequential(nn.Identity(), Lin(1280, num_classes))

    def forward(self, x):
        return self.classifier(self.features(x).mean(dim=(2, 3)))


_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class Classifier(nn.Module):
    """A frozen classifier with the reference adapters' preprocessing:
    ResNet-18 resizes bilinearly to 224, MobileNetV2 with nearest to the
    model's size when it differs; then ImageNet normalisation."""

    def __init__(self, kind: str, image_size: int, num_classes: int = 2):
        super().__init__()
        self.kind, self.image_size = kind, image_size
        self.net = ResNet18(num_classes) if kind == "resnet" else MobileNetV2(num_classes)

    def forward(self, images):
        x = images
        h, w = x.shape[-2:]
        if self.kind == "resnet" and (h, w) != (224, 224):
            x = F.interpolate(x, size=(224, 224), mode="bilinear", align_corners=False)
        elif self.kind != "resnet" and (h, w) != (self.image_size, self.image_size):
            x = F.interpolate(x, size=(self.image_size, self.image_size), mode="nearest")
        mean = torch.tensor(_MEAN, dtype=x.dtype, device=x.device)[:, None, None]
        std = torch.tensor(_STD, dtype=x.dtype, device=x.device)[:, None, None]
        return self.net((x - mean) / std)


# -------------------------------------------------------------------- LPIPS

LPIPS_CFG = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def lpips_shapes():
    """name -> shape of the LPIPS-alex parameters, ``conv{i}.weight``,
    ``conv{i}.bias`` and the per-channel tap weights ``lin{i}``."""
    out, c = {}, 3
    for i, (o, k, _, _) in enumerate(LPIPS_CFG):
        out[f"conv{i}.weight"] = (o, c, k, k)
        out[f"conv{i}.bias"] = (o,)
        out[f"lin{i}"] = (o,)
        c = o
    return out


def lpips_distance(p: dict, x, y):
    """(B,) LPIPS between batches in [-1, 1]; ``p`` maps :func:`lpips_shapes`'
    names to tensors."""
    h, w = x.shape[-2:]
    if h < 32 or w < 32:
        size = (max(h, 32), max(w, 32))
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=False)
        y = F.interpolate(y, size=size, mode="bilinear", align_corners=False)
    shift = torch.tensor(_SHIFT, device=x.device)[:, None, None]
    scale = torch.tensor(_SCALE, device=x.device)[:, None, None]
    b = x.shape[0]
    t = torch.cat([(x - shift) / scale, (y - shift) / scale])
    total = 0.0
    for i, (_, _, stride, pad) in enumerate(LPIPS_CFG):
        t = F.relu(ops.conv2d(t, p[f"conv{i}.weight"], p[f"conv{i}.bias"], stride, pad))
        tn = t / torch.sqrt(t.square().sum(dim=1, keepdim=True) + 1e-10)
        diff = (tn[:b] - tn[b:]).square() * p[f"lin{i}"][:, None, None]
        total = total + diff.sum(1).mean((1, 2))
        if i in (0, 1):
            t = F.max_pool2d(t, 3, 2)
    return total
