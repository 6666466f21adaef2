"""Synthetic image dataset: deterministic structured images for tests and
smoke runs where no data is on disk. (The MNIST one-vs-all reader of the
JAX package's ``data/mnist.py`` is not ported yet.)"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticImageDataset"]


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
