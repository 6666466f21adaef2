"""FID: the Fréchet distance between feature statistics of two image streams.

Batches of (B, H, W, 3) images in [0, 1] (NHWC numpy, as the records and
the loader hold them) go through a feature function on the device; the
running sums of the features and of their outer products accumulate on the
host in float64; the 2048x2048 matrix square root runs on the host in
scipy. This is the JAX package's pipeline (``stylex_tpu/eval/fid.py``).

A feature function takes a (B, 3, H, W) float tensor in [0, 1] on any
device and returns (B, D) features; it carries a ``tag`` that names it, by
which cached statistics are keyed. Two are built in:

* InceptionV3 pool3 (2048-d, :mod:`stylex_tpu_torch.models.inception`),
  the FID standard, when ``STYLEX_TPU_INCEPTION`` names a weights file;
* otherwise a seeded random AlexNet trunk, global-average-pooled conv5
  (256-d): self-consistent for tracking a training run, not comparable with
  published FID numbers. Its weights are the port's own draw, not the JAX
  package's, so its tag differs from the JAX package's.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from stylex_tpu_torch.device import resolve_device

__all__ = [
    "FeatureStats",
    "frechet_distance",
    "fid_from_image_batches",
    "alexnet_features_fn",
    "resolve_feature_fn",
    "compute_feature_stats",
    "resize_bilinear",
]

FeatureFn = Callable[[torch.Tensor], torch.Tensor]

ALEXNET_TAG = "alexnet_seeded_torch"
INCEPTION_TAG = "inception_v3_pool3"


class FeatureStats:
    """Streaming mean and covariance.

    The sums accumulate on the host in float64: the ``outer - n mu mu^T``
    cancellation in :meth:`finalize` loses digits in float32 over thousands
    of samples, and pytorch_fid accumulates in float64 too."""

    def __init__(self, dim: int):
        self.n = 0
        self.sum = np.zeros((dim,), np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats) -> None:
        if torch.is_tensor(feats):
            feats = feats.detach().cpu().numpy()
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.sum += f.sum(axis=0)
        self.outer += f.T @ f

    def finalize(self):
        mu = self.sum / self.n
        cov = (self.outer - self.n * np.outer(mu, mu)) / max(self.n - 1, 1)
        return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """``||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))``.

    A covariance of fewer samples than dimensions is rank deficient (its
    Cholesky factorisation fails): then ``eps`` is added to both diagonals
    before the square root, since sqrtm of a singular product can come out
    finite and wrong. While the root is not finite, the jitter grows 100x
    and the root is taken again, up to 1e2; past that the distance is inf.
    scipy's LinAlgWarning for the near-singular product is silenced: the
    finiteness check is the guard."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    cov1, cov2 = np.atleast_2d(cov1), np.atleast_2d(cov2)
    diff = mu1 - mu2

    def sqrtm(m):
        out = linalg.sqrtm(m)  # a (matrix, error) tuple before scipy 1.16
        return out[0] if isinstance(out, tuple) else out

    def rank_deficient(c):
        try:
            linalg.cholesky(c, lower=True)
            return False
        except linalg.LinAlgError:
            return True

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", linalg.LinAlgWarning)
        jitter = eps
        if rank_deficient(cov1) or rank_deficient(cov2):
            offset = np.eye(cov1.shape[0]) * jitter
            covmean = sqrtm((cov1 + offset) @ (cov2 + offset))
            jitter *= 100.0
        else:
            covmean = sqrtm(cov1 @ cov2)
        while not np.isfinite(covmean).all() and jitter < 1e2:
            offset = np.eye(cov1.shape[0]) * jitter
            covmean = sqrtm((cov1 + offset) @ (cov2 + offset))
            jitter *= 100.0
    if not np.isfinite(covmean).all():
        return float("inf")
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(covmean))


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of a 1-d bilinear resize, as
    ``jax.image.resize`` computes them: the triangle kernel at half-pixel
    sample points, widened by the scale when shrinking, each output's
    weights renormalised over the input taps. The sample points are
    computed in float64 and rounded: compiled, XLA evaluates JAX's
    ``(i + 0.5) * inv_scale - 0.5`` to about that precision, and the
    float32 expression as written strays by ~1e-5 at 320 -> 299."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = ((np.arange(n_out) + 0.5) * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size) by ``jax.image.resize(...,
    'bilinear')``'s algorithm: separable weight matrices (half-pixel
    centres; taps outside the image dropped and the rest renormalised,
    which equals edge clamping; the kernel widened when a side shrinks, the
    default ``antialias=True``), contracted in one einsum. A side already
    at ``size`` is left alone. (``F.interpolate``, antialiased, strays from
    it by ~1e-5 at 320 -> 299.)"""
    h, w = x.shape[-2:]
    if h != size:
        x = torch.einsum("bchw,hH->bcHw", x, torch.from_numpy(_resize_weights(h, size))
                         .to(x.device, x.dtype))
    if w != size:
        x = torch.einsum("bchw,wW->bchW", x, torch.from_numpy(_resize_weights(w, size))
                         .to(x.device, x.dtype))
    return x


def alexnet_features_fn(seed: int = 0, params=None, device=None) -> FeatureFn:
    """The offline fallback extractor: the LPIPS AlexNet trunk on images
    resized to ``max(64, H)`` and scaled to [-1, 1], global-average-pooled
    conv5 (256-d). ``params`` is an LPIPS tree (as
    :func:`stylex_tpu_torch.models.convert.lpips_params_from_jax` gives
    one); by default the port's seeded tree, on ``device`` (the GPU unless
    ``'cpu'``)."""
    from stylex_tpu_torch.models.lpips import _alexnet_features, init_lpips_params, lpips_params_to

    device = resolve_device(device)
    params = (init_lpips_params(seed, device=device) if params is None
              else lpips_params_to(params, device))

    @torch.no_grad()
    def features(images: torch.Tensor) -> torch.Tensor:
        x = images.to(device, torch.float32)
        x = resize_bilinear(x, max(64, x.shape[-2]))
        return _alexnet_features(params, x * 2.0 - 1.0)[-1].mean(dim=(2, 3))

    return features


def resolve_feature_fn(feature_fn: Optional[FeatureFn] = None, device=None) -> FeatureFn:
    """``feature_fn`` with a ``tag``; by default InceptionV3 pool3 when
    ``STYLEX_TPU_INCEPTION`` is set, else the seeded AlexNet, on ``device``.

    Statistics from different extractors are never comparable, so a
    function without a tag gets one from its name and ``id()``: two
    instances of one function never share a cache key. A set but missing or
    malformed ``STYLEX_TPU_INCEPTION`` raises."""
    if feature_fn is not None:
        if not hasattr(feature_fn, "tag"):
            tag = (getattr(feature_fn, "__qualname__", None)
                   or getattr(feature_fn, "__name__", "custom")) + f"-{id(feature_fn):x}"
            try:
                feature_fn.tag = tag
            except AttributeError:  # a bound method takes no attributes
                inner = feature_fn

                def feature_fn(x, _inner=inner):
                    return _inner(x)

                feature_fn.tag = tag
        return feature_fn
    from stylex_tpu_torch.models.inception import default_pool3_features

    feature_fn = default_pool3_features(device)
    if feature_fn is not None:
        feature_fn.tag = INCEPTION_TAG
        return feature_fn
    feature_fn = alexnet_features_fn(device=device)
    feature_fn.tag = ALEXNET_TAG
    return feature_fn


def compute_feature_stats(batches: Iterable[np.ndarray], feature_fn: FeatureFn):
    """(mu, cov) of the features of a stream of (B, H, W, 3) batches in
    [0, 1]."""
    stats = None
    for batch in batches:
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(batch, np.float32)
                                                  .transpose(0, 3, 1, 2)))
        feats = feature_fn(x)
        if stats is None:
            stats = FeatureStats(feats.shape[-1])
        stats.update(feats.float())
    if stats is None:
        raise ValueError("compute_feature_stats: the batch stream is empty")
    return stats.finalize()


def fid_from_image_batches(real_batches: Iterable[np.ndarray],
                           fake_batches: Iterable[np.ndarray],
                           feature_fn: Optional[FeatureFn] = None, device=None) -> float:
    """FID between two streams of (B, H, W, 3) batches in [0, 1], with
    :func:`resolve_feature_fn`'s extractor."""
    feature_fn = resolve_feature_fn(feature_fn, device)
    mu1, c1 = compute_feature_stats(real_batches, feature_fn)
    mu2, c2 = compute_feature_stats(fake_batches, feature_fn)
    return frechet_distance(mu1, c1, mu2, c2)
