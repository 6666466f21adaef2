"""Contrastive D regularisation (``cl_reg``): SimCLR on the D trunk's
features.

Two augmented views of the same images (a whole-batch horizontal flip with
probability 1/2, then DiffAugment translation and cutout) should have
matching features: NT-Xent over the L2-normalised flattened trunk
features, the other view of each image the positive, every other sample of
both views a negative. The views' random draws come in as
:class:`~stylex_tpu_torch.ops.diffaug.AugmentDraws` (gate always on), so a
test can pass in the JAX package's draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from stylex_tpu_torch.ops.diffaug import AugmentDraws, augment_for_discriminator, draw_augment

__all__ = ["VIEW_TYPES", "nt_xent_loss", "draw_views", "contrastive_views", "contrastive_d_loss"]

VIEW_TYPES = ("translation", "cutout")

Views = Tuple[AugmentDraws, AugmentDraws]


def nt_xent_loss(h1: torch.Tensor, h2: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """Normalised-temperature cross entropy between two (B, D) view batches."""
    z = torch.cat([h1 / h1.norm(dim=-1, keepdim=True), h2 / h2.norm(dim=-1, keepdim=True)])
    b = h1.shape[0]
    sim = (z @ z.t()) / temperature
    sim = sim - 1e9 * torch.eye(2 * b, dtype=sim.dtype, device=sim.device)  # no self-pairs
    targets = torch.cat([torch.arange(b, 2 * b), torch.arange(b)]).to(sim.device)
    return -F.log_softmax(sim, dim=-1).gather(1, targets[:, None]).mean()


def draw_views(generator: torch.Generator, groups: int, group_size: int,
               image_size: int) -> Views:
    """The draws of two views of ``groups`` micro-batches of
    ``group_size`` images: flips per micro-batch, DiffAugment per image."""
    return tuple(draw_augment(generator, groups, group_size, image_size, 1.0, VIEW_TYPES)
                 for _ in range(2))


def contrastive_views(images: torch.Tensor, views: Views) -> Tuple[torch.Tensor, torch.Tensor]:
    return tuple(augment_for_discriminator(images, v, VIEW_TYPES) for v in views)


def contrastive_d_loss(feature_fn: Callable[[torch.Tensor], torch.Tensor], images: torch.Tensor,
                       views: Views, groups: int = 1, temperature: float = 0.1,
                       gather: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                       ) -> torch.Tensor:
    """NT-Xent over the features of two views of ``images``, within each of
    ``groups`` equal consecutive groups (micro-batches), averaged. One
    ``feature_fn`` pass takes both views of every group. ``gather`` maps
    this rank's (groups, b, D) features to the whole micro-batches' (groups,
    B, D) where the images are one rank's slice of each group."""
    v1, v2 = contrastive_views(images, views)
    feats = feature_fn(torch.cat([v1, v2]))
    f1, f2 = feats.chunk(2)
    f1, f2 = f1.reshape(groups, -1, f1.shape[-1]), f2.reshape(groups, -1, f2.shape[-1])
    if gather is not None:
        f1, f2 = gather(f1), gather(f2)
    return torch.stack([nt_xent_loss(f1[i], f2[i], temperature) for i in range(groups)]).mean()
