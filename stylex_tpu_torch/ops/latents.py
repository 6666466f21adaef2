"""Latent-space helpers: noise sampling, style broadcast and mixing,
truncation, slerp, and the LPIPS input rescale.

Randomness comes from an explicit ``torch.Generator``. It gives other
numbers than ``jax.random`` from the same seed, so tests draw their inputs
with numpy and hand them to both packages.
"""

from __future__ import annotations

import torch

__all__ = [
    "latent_noise",
    "image_noise",
    "mixing_cutoff",
    "expand_styles",
    "mixed_w_styles",
    "truncate_w",
    "slerp",
    "lpips_normalize",
    "evaluate_in_chunks",
]


def evaluate_in_chunks(max_batch_size: int, fn, *args):
    """``fn`` over chunks of at most ``max_batch_size`` rows of its tensor
    arguments, the outputs concatenated along the batch axis (the
    reference's ``evaluate_in_chunks``)."""
    n = args[0].shape[0]
    outs = [fn(*[a[s:s + max_batch_size] for a in args]) for s in range(0, n, max_batch_size)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def latent_noise(generator: torch.Generator, n: int, latent_dim: int,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """z ~ N(0, I), the prior input to the mapping network."""
    return torch.randn(n, latent_dim, generator=generator, dtype=dtype, device=device)


def image_noise(generator: torch.Generator, n: int, im_size: int,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-pixel uniform [0, 1) noise image, (n, S, S, 1) as the generator
    takes it."""
    return torch.rand(n, im_size, im_size, 1, generator=generator, dtype=dtype, device=device)


def mixing_cutoff(generator: torch.Generator, num_layers: int, device=None) -> torch.Tensor:
    """Random style-mixing cutoff layer in [0, num_layers), a 0-d int64."""
    return torch.randint(0, num_layers, (), generator=generator, device=device)


def expand_styles(w: torch.Tensor, num_layers: int) -> torch.Tensor:
    """(B, latent) -> (B, num_layers, latent): one w for every layer."""
    return w[:, None, :].expand(w.shape[0], num_layers, w.shape[-1])


def mixed_w_styles(w1: torch.Tensor, w2: torch.Tensor, cutoff,
                   num_layers: int) -> torch.Tensor:
    """Layers below ``cutoff`` take ``w1``, the rest take ``w2``."""
    layer_ids = torch.arange(num_layers, device=w1.device)[None, :, None]
    take_first = (layer_ids < cutoff).to(w1.dtype)
    return expand_styles(w1, num_layers) * take_first + expand_styles(w2, num_layers) * (1.0 - take_first)


def truncate_w(w: torch.Tensor, w_mean: torch.Tensor, psi: float) -> torch.Tensor:
    """Truncation trick: ``psi * (w - mean) + mean``."""
    return psi * (w - w_mean) + w_mean


def slerp(val, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation between latent batches."""
    low_norm = low / torch.linalg.norm(low, dim=1, keepdim=True)
    high_norm = high / torch.linalg.norm(high, dim=1, keepdim=True)
    omega = torch.arccos(torch.clamp((low_norm * high_norm).sum(dim=1), -1.0, 1.0))
    so = torch.sin(omega)
    a = (torch.sin((1.0 - val) * omega) / so)[:, None]
    b = (torch.sin(val * omega) / so)[:, None]
    return a * low + b * high


def lpips_normalize(images: torch.Tensor) -> torch.Tensor:
    """Min-max rescale each image of a batch to [-1, 1] before the LPIPS net."""
    flat = images.reshape(images.shape[0], -1)
    _max = flat.amax(dim=1)[:, None, None, None]
    _min = flat.amin(dim=1)[:, None, None, None]
    return (images - _min) / (_max - _min) * 2.0 - 1.0
