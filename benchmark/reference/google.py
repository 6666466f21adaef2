"""The plain reference of Google's published 256-px StylEx generator and of
AttFind from its dlatents, float32.

The generator is a StyleGAN2 skip generator (Karras et al. 2020,
arXiv:1912.04958) as Lang et al. 2021 (arXiv:2104.13369) released it:
channels ``min(fmap_base / 2^(r-1), fmap_max)`` at resolution 2^r, a 514-d
dlatent (512 dims and 2 class dims) that feeds every layer, a learned 4 x 4
constant, one 3x3 conv at 4 px, then at each higher resolution a 2x
upsample, two 3x3 convs and a to-RGB whose output is added to the
upsampled image of the resolution below. Each conv's style is its own
affine of the dlatent, ``s = w @ K + b``, and the concatenation of the
conv styles is the StyleSpace that AttFind perturbs. Modulation and
demodulation are written as StyleGAN2 describes them: a per-sample weight
``W'[b] = W * s[b]`` (input channels scaled), divided by
``sqrt(sum over (in, kh, kw) of W'^2 + 1e-8)`` in the convs (not in the
to-RGBs), and one grouped convolution over the batch.

Departures from the published description:

* the 2x upsample is ``F.interpolate`` bilinear with half-pixel centres,
  of the features before the first conv and of the RGB skip; StyleGAN2's
  code upsamples with a transposed conv and a [1, 3, 3, 1] FIR filter;
* no per-pixel noise inputs, no sqrt(2) gain after the leaky ReLU (0.2)
  and no equalised-learning-rate scales: the weights are used as stored,
  as the program uses the release's converted weights;
* the style affine's output is the scale itself (its bias starts at 1 in
  a trained model), with no +1 added;
* the image is clipped to [-1, 1] and mapped to [0, 1] for the classifier,
  which stands in for the release's classifier.

AttFind from dlatents: phase 1 gives each dlatent's StyleSpace
coordinates, its base image and the classifier's logits of it; a
perturbation (dlatent, coordinate, direction) adds ``(extreme - current) *
shift_size`` to that coordinate, the extreme being the minimum or maximum
of the coordinate over a pool of dlatents, and runs the whole generator
and the classifier again; its effect is the change of the logits. The
program may resume the generator at the perturbed resolution; the
reference always runs it whole.

This file imports nothing but torch and its siblings.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from . import ops


def channels(c: dict) -> Dict[int, int]:
    """Channels per resolution of a configuration's ``model`` dict."""
    res, out = 4, {}
    while res <= c["image_size"]:
        out[res] = min(c["fmap_base"] // (res // 2), c["fmap_max"])
        res *= 2
    return out


def conv_specs(c: dict) -> List[Tuple[int, int, int]]:
    """(resolution, in, out) of every 3x3 conv, in synthesis order."""
    ch = channels(c)
    specs, prev = [(4, ch[4], ch[4])], ch[4]
    for res in sorted(ch)[1:]:
        specs += [(res, prev, ch[res]), (res, ch[res], ch[res])]
        prev = ch[res]
    return specs


def block_sizes(c: dict) -> List[int]:
    """StyleSpace coordinates per resolution: the style widths (each conv's
    input channels) of its convs."""
    per: Dict[int, int] = {}
    for res, cin, _ in conv_specs(c):
        per[res] = per.get(res, 0) + cin
    return [per[r] for r in sorted(per)]


class StyledConv(nn.Module):
    """A conv's weight (O, I, k, k) and bias, and its style affine, under the
    keys of the program's converted generator."""

    def __init__(self, cin: int, cout: int, k: int, dlatent_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.style_kernel = nn.Parameter(torch.zeros(dlatent_dim, cin))
        self.style_bias = nn.Parameter(torch.zeros(1, cin))

    def style(self, w: torch.Tensor) -> torch.Tensor:
        return ops.matmul(w, self.style_kernel) + self.style_bias


def modulated_conv(x: torch.Tensor, weight: torch.Tensor, s: torch.Tensor,
                   demod: bool) -> torch.Tensor:
    """StyleGAN2's modulated conv with per-sample weights: ``W * s[b]``,
    demodulated, as one convolution grouped over the batch."""
    b, cin, h, w = x.shape
    cout, _, k, _ = weight.shape
    wb = weight[None] * s[:, None, :, None, None]  # (B, O, I, k, k)
    if demod:
        wb = wb * torch.rsqrt(wb.square().sum(dim=(2, 3, 4), keepdim=True) + 1e-8)
    y = ops.conv2d(x.reshape(1, b * cin, h, w), wb.reshape(b * cout, cin, k, k),
                   padding=(k - 1) // 2, groups=b)
    return y.reshape(b, cout, h, w)


class Generator(nn.Module):
    """The generator of a configuration's ``model`` dict (``image_size``,
    ``dlatent_dim``, ``fmap_base``, ``fmap_max``)."""

    def __init__(self, c: dict):
        super().__init__()
        ch = channels(c)
        d = c["dlatent_dim"]
        self.resolutions = sorted(ch)
        self.const = nn.Parameter(torch.zeros(1, ch[4], 4, 4))
        self.convs = nn.ModuleList(StyledConv(i, o, 3, d) for _, i, o in conv_specs(c))
        self.torgbs = nn.ModuleList(StyledConv(ch[r], 3, 1, d) for r in self.resolutions)

    def style_vectors(self, w: torch.Tensor) -> torch.Tensor:
        """(B, dlatent_dim) -> (B, C) StyleSpace coordinates."""
        return torch.cat([conv.style(w) for conv in self.convs], dim=-1)

    def forward(self, w: torch.Tensor, style_delta: Optional[torch.Tensor] = None,
                start_block: int = 0, state=None, stop_block: Optional[int] = None):
        """(B, dlatent_dim) dlatents -> (B, 3, S, S) image, not clipped.
        ``style_delta`` (B, C) adds to the coordinates. With ``stop_block``
        k, the (x, rgb) that enters resolution k (for counting resumed
        work); ``start_block`` with ``state`` runs from such an entry."""
        x, rgb = state if state is not None else (
            self.const.expand(w.shape[0], -1, -1, -1), None)
        i, offset = 0, 0
        for b, _ in enumerate(self.resolutions):
            convs = range(i, i + (1 if b == 0 else 2))
            i = convs[-1] + 1
            if b < start_block:
                offset += sum(self.convs[j].weight.shape[1] for j in convs)
                continue
            if b == stop_block:
                return x, rgb
            for j in convs:
                conv = self.convs[j]
                s = conv.style(w)
                if style_delta is not None:
                    s = s + style_delta[:, offset:offset + s.shape[1]]
                offset += s.shape[1]
                if b > 0 and j == convs[0]:
                    x = ops.upsample2x(x)
                x = modulated_conv(x, conv.weight, s, demod=True)
                x = ops.leaky_relu(x + conv.bias[None, :, None, None])
            t = self.torgbs[b]
            y = modulated_conv(x, t.weight, t.style(w), demod=False) + t.bias[None, :, None, None]
            rgb = y if rgb is None else ops.upsample2x(rgb) + y
        return rgb


def to_unit(img: torch.Tensor) -> torch.Tensor:
    """A generated image clipped to [-1, 1], mapped to [0, 1]."""
    return (img.clamp(-1.0, 1.0) + 1.0) / 2.0


@torch.no_grad()
def style_range(gen: Generator, pool: torch.Tensor, batch: int = 256):
    """(C,) minima and maxima of every coordinate over a pool of dlatents."""
    coords = torch.cat([gen.style_vectors(pool[s:s + batch])
                        for s in range(0, pool.shape[0], batch)])
    return coords.min(0).values, coords.max(0).values


@torch.no_grad()
def phase1(gen: Generator, classifier, w: torch.Tensor):
    """(N, dlatent_dim) -> coords (N, C), base image (N, 3, S, S) in [0, 1],
    base logits (N, K)."""
    img = to_unit(gen(w))
    return gen.style_vectors(w), img, classifier(img)


@torch.no_grad()
def effects(gen: Generator, classifier, w, coords, base, minima, maxima, img, coord, is_max,
            shift_size: float = 1.0, batch: int = 64) -> torch.Tensor:
    """Logit changes (P, K) of the perturbations ``(img[i], coord[i],
    is_max[i])`` of the dlatents ``w`` whose phase-1 outputs are ``coords``
    and ``base``, with the extremes ``minima`` and ``maxima``."""
    out = []
    for s in range(0, img.shape[0], batch):
        i, k, mx = img[s:s + batch], coord[s:s + batch], is_max[s:s + batch]
        shift = (torch.where(mx, maxima[k], minima[k]) - coords[i, k]) * shift_size
        delta = torch.zeros(i.shape[0], coords.shape[1], device=w.device)
        delta[torch.arange(i.shape[0], device=w.device), k] = shift
        out.append(classifier(to_unit(gen(w[i], delta))) - base[i])
    return torch.cat(out)
