"""MNIST one-vs-all and the synthetic image set.

:class:`MNIST1vA` reads the raw IDX files (``train-images-idx3-ubyte``,
``train-labels-idx1-ubyte``, or ``t10k-*``, each optionally ``.gz``) from a
local folder; nothing is downloaded. Targets are ``label == digit``
(default 8); images are resized 28 -> 32 by half-pixel bilinear
interpolation and repeated to 3 channels, as the JAX package's reader does.
:func:`stylex_tpu_torch.data.loader.balanced_class_weights` gives the
class-rebalanced sampling weights.

:class:`SyntheticImageDataset` gives deterministic structured images for
tests and smoke runs where no data is on disk.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

__all__ = ["MNIST1vA", "load_idx_images", "load_idx_labels", "SyntheticImageDataset"]


def _open_maybe_gz(path: Path):
    if path.exists():
        return open(path, "rb")
    gz = path.with_name(path.name + ".gz")
    if gz.exists():
        return gzip.open(gz, "rb")
    raise FileNotFoundError(f"{path}(.gz) not found: put the MNIST IDX files there")


def load_idx_images(path: Path) -> np.ndarray:
    """(N, rows, cols) uint8 from an IDX3 file (magic 2051)."""
    with _open_maybe_gz(Path(path)) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad IDX image magic {magic}")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols)


def load_idx_labels(path: Path) -> np.ndarray:
    """(N,) uint8 from an IDX1 file (magic 2049)."""
    with _open_maybe_gz(Path(path)) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad IDX label magic {magic}")
        return np.frombuffer(f.read(n), np.uint8)


def _bilinear_28_to_32(img: np.ndarray) -> np.ndarray:
    """Half-pixel bilinear 28 -> 32 with edge clamping, in float64 as the
    JAX package's reader computes it."""
    src = np.arange(32)
    pos = (src + 0.5) * 28 / 32 - 0.5
    i0 = np.clip(np.floor(pos).astype(int), 0, 27)
    i1 = np.clip(i0 + 1, 0, 27)
    wy = np.clip(pos - i0, 0, 1)[:, None]
    wx = np.clip(pos - i0, 0, 1)[None, :]
    return (img[np.ix_(i0, i0)] * (1 - wy) * (1 - wx) + img[np.ix_(i1, i0)] * wy * (1 - wx)
            + img[np.ix_(i0, i1)] * (1 - wy) * wx + img[np.ix_(i1, i1)] * wy * wx)


class MNIST1vA:
    """Binary MNIST: class 1 is ``digit``; (32, 32, 3) float32 images in
    [0, 1]."""

    image_size = 32

    def __init__(self, folder: str = "./", digit: int = 8, train: bool = True):
        prefix = "train" if train else "t10k"
        folder_p = Path(folder)
        self.images = load_idx_images(folder_p / f"{prefix}-images-idx3-ubyte")
        labels = load_idx_labels(folder_p / f"{prefix}-labels-idx1-ubyte")
        self.targets = (labels == digit).astype(np.int64)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int) -> np.ndarray:
        out = _bilinear_28_to_32(self.images[index].astype(np.float32) / 255.0)
        return np.repeat(out[..., None], 3, axis=-1).astype(np.float32)

    def label(self, index: int) -> int:
        return int(self.targets[index])


class SyntheticImageDataset:
    """Image ``i`` is a 4x4 random grid upscaled to ``image_size`` plus 10%
    uniform noise, from ``RandomState(seed * 100003 + i)``: the same images
    as the JAX package's dataset of the same name."""

    def __init__(self, n: int, image_size: int, channels: int = 3, seed: int = 0):
        self.n = n
        self.image_size = image_size
        self.channels = channels
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed * 100003 + index)
        base = rng.rand(4, 4, self.channels).astype(np.float32)
        reps = self.image_size // 4
        img = np.kron(base, np.ones((reps, reps, 1), np.float32))
        return np.clip(img + rng.rand(*img.shape).astype(np.float32) * 0.1, 0.0, 1.0)
