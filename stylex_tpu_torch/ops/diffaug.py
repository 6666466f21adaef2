"""DiffAugment: differentiable GAN augmentations, NCHW, with explicit draws.

The same augmentations as the JAX package's ``ops/diffaug.py``
(brightness, saturation, contrast and their light variants, translation,
cutout, offset, and the whole-batch horizontal flip of the pre-D wrapper).
Every augmentation takes its random draws as tensors: :func:`draw_augment`
makes them from a ``torch.Generator``, and a test can pass in the draws of
the JAX package's keys instead.

The pre-D wrapper decides per micro-batch whether to augment and whether
to flip. Here those two decisions are given per sample (repeated within a
micro-batch), so a batch of several micro-batches is augmented in one
vectorised pass.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = [
    "AUGMENT_TYPES",
    "AugmentDraws",
    "draw_augment",
    "rand_brightness",
    "rand_saturation",
    "rand_contrast",
    "rand_translation",
    "rand_cutout",
    "rand_offset",
    "random_hflip",
    "diff_augment",
    "augment_for_discriminator",
]

AUGMENT_TYPES = {
    "brightness": (("brightness", 1.0),),
    "lightbrightness": (("brightness", 0.65),),
    "contrast": (("contrast", 0.5),),
    "lightcontrast": (("contrast", 0.25),),
    "saturation": (("saturation", 1.0),),
    "lightsaturation": (("saturation", 0.5),),
    "color": (("brightness", 1.0), ("saturation", 1.0), ("contrast", 0.5)),
    "lightcolor": (("brightness", 0.65), ("saturation", 0.5), ("contrast", 0.5)),
    "offset": (("offset", (1.0, 1.0, 1.0)),),
    "offset_h": (("offset", (1.0, 1.0, 0.0)),),
    "offset_v": (("offset", (1.0, 0.0, 1.0)),),
    "translation": (("translation", 0.125),),
    "cutout": (("cutout", 0.5),),
}


class AugmentDraws(NamedTuple):
    """Draws for :func:`augment_for_discriminator` over N samples.

    gate, flip: (N,) bool, whether each sample is augmented and flipped.
    ops: one tuple of tensors per augmentation of the pipeline, in order:
      brightness/saturation/contrast: ((N,) uniform [0, 1),);
      translation: ((N,) row shift, (N,) column shift);
      cutout: ((N,) centre row, (N,) centre column);
      offset: ((N,) column roll or None, (N,) row roll or None).
    """

    gate: torch.Tensor
    flip: torch.Tensor
    ops: Tuple[tuple, ...]


def _per_sample(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.to(x.dtype).view(-1, 1, 1, 1)


def rand_brightness(x, u, scale):
    return x + (_per_sample(u, x) - 0.5) * scale


def rand_saturation(x, u, scale):
    x_mean = x.mean(dim=1, keepdim=True)
    factor = (_per_sample(u, x) - 0.5) * 2.0 * scale + 1.0
    return (x - x_mean) * factor + x_mean


def rand_contrast(x, u, scale):
    x_mean = x.mean(dim=(1, 2, 3), keepdim=True)
    factor = (_per_sample(u, x) - 0.5) * 2.0 * scale + 1.0
    return (x - x_mean) * factor + x_mean


def rand_translation(x, th, tw):
    """Integer shift with zero fill: pad by one, then a clamped gather."""
    n, _, h, w = x.shape
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    rows = (torch.arange(h, device=x.device)[None, :, None] + th.view(-1, 1, 1) + 1).clamp(0, h + 1)
    cols = (torch.arange(w, device=x.device)[None, None, :] + tw.view(-1, 1, 1) + 1).clamp(0, w + 1)
    bidx = torch.arange(n, device=x.device)[:, None, None]
    # (N, h, w, C) -> NCHW, contiguous: a channels-last stride would carry
    # through the convs to the blur kernel, which takes NCHW only
    return xp[bidx, :, rows, cols].permute(0, 3, 1, 2).contiguous()


def _cut_size(size: int, ratio: float) -> int:
    return int(size * ratio + 0.5)


def rand_cutout(x, oy, ox, ratio=0.5):
    """Zero a square of ``ratio`` of the size centred at (oy, ox), clamped to
    the image."""
    _, _, h, w = x.shape
    ch, cw = _cut_size(h, ratio), _cut_size(w, ratio)
    oy, ox = oy.view(-1, 1, 1), ox.view(-1, 1, 1)
    y0 = (oy - ch // 2).clamp(0, h - 1)
    y1 = (oy - ch // 2 + ch - 1).clamp(0, h - 1)
    x0 = (ox - cw // 2).clamp(0, w - 1)
    x1 = (ox - cw // 2 + cw - 1).clamp(0, w - 1)
    rows = torch.arange(h, device=x.device)[None, :, None]
    cols = torch.arange(w, device=x.device)[None, None, :]
    in_cut = (rows >= y0) & (rows <= y1) & (cols >= x0) & (cols <= x1)
    return x * (1.0 - in_cut.to(x.dtype))[:, None]


def _roll_per_sample(x, shift, dim):
    n = x.shape[dim]
    idx = (torch.arange(n, device=x.device)[None, :] - shift[:, None]) % n
    shape = [x.shape[0]] + [n if d == dim else 1 for d in range(1, x.dim())]
    return torch.gather(x, dim, idx.view(shape).expand(x.shape))


def rand_offset(x, vh: Optional[torch.Tensor], vv: Optional[torch.Tensor]):
    """Per-sample circular roll: columns by ``vh``, then rows by ``vv``."""
    if vh is not None:
        x = _roll_per_sample(x, vh, 3)
    if vv is not None:
        x = _roll_per_sample(x, vv, 2)
    return x


def random_hflip(x, flip):
    return torch.where(flip.view(-1, 1, 1, 1), x.flip(3), x)


def diff_augment(x: torch.Tensor, ops: Sequence[tuple], types: Sequence[str]) -> torch.Tensor:
    """Apply the augmentation pipeline of ``types`` in order."""
    steps = [s for t in types for s in AUGMENT_TYPES[t]]
    if len(steps) != len(ops):
        raise ValueError(f"{len(ops)} draws for {len(steps)} augmentations")
    for (name, arg), draw in zip(steps, ops):
        if name == "brightness":
            x = rand_brightness(x, draw[0], arg)
        elif name == "saturation":
            x = rand_saturation(x, draw[0], arg)
        elif name == "contrast":
            x = rand_contrast(x, draw[0], arg)
        elif name == "translation":
            x = rand_translation(x, *draw)
        elif name == "cutout":
            x = rand_cutout(x, *draw, ratio=arg)
        else:
            x = rand_offset(x, *draw)
    return x


def augment_for_discriminator(x: torch.Tensor, draws: Optional[AugmentDraws],
                              types: Sequence[str]) -> torch.Tensor:
    """The pre-D pipeline: where ``gate``, flip where ``flip`` and run
    DiffAugment; elsewhere the input as it is. ``draws=None`` (no
    augmentation configured) returns ``x``."""
    if draws is None:
        return x
    augmented = diff_augment(random_hflip(x, draws.flip), draws.ops, types)
    return torch.where(draws.gate.view(-1, 1, 1, 1), augmented, x)


def draw_augment(generator: torch.Generator, groups: int, group_size: int, image_size: int,
                 prob: float, types: Sequence[str]) -> Optional[AugmentDraws]:
    """Draws for ``groups`` micro-batches of ``group_size`` square images,
    on ``generator``'s device; ``None`` when no augmentation is configured.
    The gate (probability ``prob``) and the flip (1/2) are drawn per
    micro-batch."""
    if prob == 0.0 or not types:
        return None
    n, size, dev = groups * group_size, image_size, generator.device

    def randint(lo, hi):
        return torch.randint(lo, hi, (n,), generator=generator, device=dev)

    ops = []
    for t in types:
        for name, arg in AUGMENT_TYPES[t]:
            if name in ("brightness", "saturation", "contrast"):
                ops.append((torch.rand(n, generator=generator, device=dev),))
            elif name == "translation":
                s = _cut_size(size, arg)
                ops.append((randint(-s, s + 1), randint(-s, s + 1)))
            elif name == "cutout":
                c = _cut_size(size, arg)
                ops.append((randint(0, size + (1 - c % 2)), randint(0, size + (1 - c % 2))))
            else:
                ratio, ratio_h, ratio_v = arg
                max_h, max_v = int(size * ratio * ratio_h), int(size * ratio * ratio_v)
                ops.append((randint(0, max_h + 1) * 2 - max_h if max_h > 0 else None,
                            randint(0, max_v + 1) * 2 - max_v if max_v > 0 else None))
    gate = torch.rand(groups, generator=generator, device=dev) < prob
    flip = torch.rand(groups, generator=generator, device=dev) < 0.5
    return AugmentDraws(gate.repeat_interleave(group_size), flip.repeat_interleave(group_size),
                        tuple(ops))
