"""Folder image dataset with the reference's preprocessing.

PIL decode, then: convert RGB(A) -> resize-to-minimum -> resize the short
side to ``image_size`` (bilinear) -> RandomApply(aug_prob,
RandomResizedCrop(scale 0.5-1.0, ratio 0.98-1.02), else CenterCrop) ->
[0, 1] float32 NHWC -> greyscale expansion. PIL is imported only when an
image is read.

Without augmentation, an RGB image takes the C++ pipeline
(:mod:`stylex_tpu_torch.native`) where it is built: the resize, the crop
and the float conversion in one pass, written into ``out`` when given (a
batch row), equal to the PIL path bit for bit. RGBA images stay on the PIL
path, whose resize premultiplies alpha; so does every image where the
pipeline is not built (no ``g++``).
"""

from __future__ import annotations

import math
import random as pyrandom
from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = ["FolderDataset", "list_images", "load_and_transform", "expand_greyscale"]

EXTS = ("jpg", "jpeg", "png")


def list_images(folder: str) -> List[Path]:
    paths = [p for ext in EXTS for p in Path(folder).glob(f"**/*.{ext}")]
    if not paths:
        raise ValueError(f"No images were found in {folder} for training")
    return sorted(paths)


def expand_greyscale(arr: np.ndarray, transparent: bool = False) -> np.ndarray:
    """1- or 2-channel -> 3- (or 4-) channel."""
    target = 4 if transparent else 3
    c = arr.shape[-1]
    if c == target:
        return arr
    if c == 1:
        color, alpha = np.repeat(arr, 3, axis=-1), None
    elif c == 2:
        color, alpha = np.repeat(arr[..., :1], 3, axis=-1), arr[..., 1:]
    else:
        raise ValueError(f"image with invalid number of channels given {c}")
    if transparent:
        if alpha is None:
            alpha = np.ones_like(arr[..., :1])
        return np.concatenate([color, alpha], axis=-1)
    return color


def _short_side_dims(w: int, h: int, size: int):
    if w < h:
        return size, max(1, round(h * size / w))
    return max(1, round(w * size / h)), size


def _resize_short_side(img, size: int):
    from PIL import Image

    w, h = img.size
    if min(w, h) == size:
        return img
    return img.resize(_short_side_dims(w, h, size), Image.BILINEAR)


def _center_crop(img, size: int):
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def _random_resized_crop(img, size: int, rng: pyrandom.Random,
                         scale=(0.5, 1.0), ratio=(0.98, 1.02)):
    """torchvision RandomResizedCrop sampling (10 tries, then centre crop)."""
    from PIL import Image

    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            return img.resize((size, size), Image.BILINEAR, box=(left, top, left + cw, top + ch))
    return _center_crop(_resize_short_side(img, size), size)


def load_and_transform(path, image_size: int, transparent: bool = False,
                       aug_prob: float = 0.0, rng: Optional[pyrandom.Random] = None,
                       out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode one image to (image_size, image_size, C) float32 in [0, 1],
    into ``out`` when given."""
    from PIL import Image

    from stylex_tpu_torch import native

    rng = rng or pyrandom
    img = Image.open(path).convert("RGBA" if transparent else "RGB")
    use_aug = aug_prob > 0 and rng.random() < aug_prob
    if not use_aug and not transparent and native.available():
        nw, nh = _short_side_dims(*img.size, image_size)
        return native.resize_crop_normalize(np.asarray(img), (nh, nw),
                                            (image_size, image_size), out=out)
    if max(img.size) < image_size:
        img = _resize_short_side(img, image_size)
    img = _resize_short_side(img, image_size)
    img = _random_resized_crop(img, image_size, rng) if use_aug else _center_crop(img, image_size)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    arr = expand_greyscale(arr, transparent)
    if out is not None:
        out[...] = arr
        return out
    return arr


class FolderDataset:
    """Recursive jpg/jpeg/png dataset."""

    def __init__(self, folder: str, image_size: int, transparent: bool = False,
                 aug_prob: float = 0.0, seed: int = 0):
        self.paths = list_images(folder)
        self.image_size = image_size
        self.transparent = transparent
        self.aug_prob = aug_prob
        self._rng = pyrandom.Random(seed)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> np.ndarray:
        return load_and_transform(
            self.paths[index], self.image_size, self.transparent, self.aug_prob, self._rng
        )
