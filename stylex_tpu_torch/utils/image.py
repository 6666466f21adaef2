"""Image grids saved as PNG (host side)."""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

__all__ = ["to_uint8", "make_grid", "save_image_grid"]


def to_uint8(images: np.ndarray) -> np.ndarray:
    """(B, H, W, C) floats in [0, 1] -> uint8, clamped."""
    return (np.clip(np.asarray(images), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """Tile (B, H, W, C) into one image, ``nrow`` images per row."""
    images = np.asarray(images)
    b, h, w, c = images.shape
    rows = math.ceil(b / nrow)
    grid = np.zeros((rows * (h + pad) + pad, nrow * (w + pad) + pad, c), images.dtype)
    for i in range(b):
        r, col = divmod(i, nrow)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return grid


def save_image_grid(images, path: str, nrow: int = 8) -> str:
    """Save (B, H, W, C) images in [0, 1] as one PNG grid."""
    from PIL import Image

    grid = make_grid(to_uint8(images), nrow=nrow)
    if grid.shape[-1] == 1:
        grid = grid[..., 0]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(grid).save(path)
    return path
