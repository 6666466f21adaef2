"""StylEx training objectives, NCHW.

* hinge D and G losses, with the reference's sign convention (D pushes real
  scores negative and fake ones positive; G minimises the fake mean), so
  discriminator thresholds carry over;
* the dual contrastive D loss;
* reconstruction = 0.1 LPIPS + 0.1 L1(E(x^), E(x)) + L1(x^, x);
* the classifier KL(p_real || p_fake), batchmean;
* the R1-style gradient penalty 10 (||d sum D(x) / dx|| - 1)^2 and the
  path-length penalty, both second-order: their first derivative is taken
  with ``create_graph=True`` so that the loss's gradient reaches the
  weights through it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from stylex_tpu_torch.models.lpips import lpips_distance
from stylex_tpu_torch.ops.latents import lpips_normalize

__all__ = [
    "d_hinge_loss",
    "g_hinge_loss",
    "dual_contrastive_loss",
    "reconstruction_loss",
    "classifier_kl_loss",
    "gradient_penalty",
    "path_length_penalty",
    "path_lengths",
]


def d_hinge_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """``mean(relu(1 + real) + relu(1 - fake))``."""
    return (F.relu(1.0 + real_scores) + F.relu(1.0 - fake_scores)).mean()


def g_hinge_loss(fake_scores: torch.Tensor) -> torch.Tensor:
    """``fake.mean()``."""
    return fake_scores.mean()


def dual_contrastive_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """Bidirectional contrastive loss: each real score against all fake ones
    (cross-entropy, target 0), and each negated fake against the negated
    reals."""

    def half(t1, t2):
        t1 = t1.reshape(-1, 1)
        logits = torch.cat([t1, t2.reshape(1, -1).expand(t1.shape[0], -1)], dim=-1)
        return (-F.log_softmax(logits, dim=-1)[:, 0]).mean()

    return half(real_scores, fake_scores) + half(-fake_scores, -real_scores)


def reconstruction_loss(lpips_params, encoder_batch: torch.Tensor, generated_images: torch.Tensor,
                        generated_images_w: torch.Tensor, encoder_w: torch.Tensor) -> torch.Tensor:
    """0.1 LPIPS(x, x^) + 0.1 mean|E(x^) - E(x)| + mean|x^ - x|, images in
    [0, 1], min-max rescaled to [-1, 1] for LPIPS."""
    percep = lpips_distance(lpips_params, lpips_normalize(encoder_batch),
                            lpips_normalize(generated_images)).mean()
    w_l1 = (encoder_w - generated_images_w).abs().mean()
    img_l1 = (encoder_batch - generated_images).abs().mean()
    return 0.1 * percep + 0.1 * w_l1 + 1.0 * img_l1


def classifier_kl_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """KL(p_real || p_fake) summed and divided by the batch size
    (``KLDivLoss(reduction='batchmean', log_target=True)``)."""
    log_p_real = F.log_softmax(real_logits, dim=-1)
    log_p_fake = F.log_softmax(fake_logits, dim=-1)
    return (log_p_real.exp() * (log_p_real - log_p_fake)).sum() / real_logits.shape[0]


def gradient_penalty(score_fn: Callable[[torch.Tensor], torch.Tensor], images: torch.Tensor,
                     weight: float = 10.0) -> torch.Tensor:
    """``weight * mean((||d sum(score_fn(x)) / dx||_2 - 1)^2)`` per sample."""
    images = images.detach().requires_grad_(True)
    scores = score_fn(images)
    scores = scores.to(torch.promote_types(scores.dtype, torch.float32))
    (grads,) = torch.autograd.grad(scores.sum(), images, create_graph=True)
    norms = grads.reshape(grads.shape[0], -1).norm(dim=1)
    return weight * (norms - 1.0).square().mean()


def path_length_penalty(generate_fn: Callable[[torch.Tensor], torch.Tensor],
                        w_styles: torch.Tensor, pl_noise: torch.Tensor,
                        pl_mean: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Path-length regularisation.

    Args:
      generate_fn: w_styles -> (B, C, H, W) images.
      w_styles: (B, num_layers, latent), on the graph of the weights that
        map to it, or a leaf.
      pl_noise: unit normal (B, C, H, W) projection noise; it is divided by
        sqrt(H * W) here.
      pl_mean: running mean of the path lengths.

    Returns:
      (penalty, mean path length of the batch).
    """
    if not w_styles.requires_grad:
        w_styles = w_styles.detach().requires_grad_(True)
    lengths = path_lengths(generate_fn, w_styles, pl_noise)
    return (lengths - pl_mean).square().mean(), lengths.mean()


def path_lengths(generate_fn, w_styles: torch.Tensor, pl_noise: torch.Tensor) -> torch.Tensor:
    """(B,) ``sqrt(mean_layers(sum_latent(g^2)))`` of the gradient ``g`` of
    the noise-projected image with respect to ``w_styles``."""
    images = generate_fn(w_styles)
    num_pixels = images.shape[2] * images.shape[3]
    proj = (images * (pl_noise.to(images.dtype) / num_pixels ** 0.5)).sum()
    (grads,) = torch.autograd.grad(proj, w_styles, create_graph=True)
    return grads.square().sum(dim=2).mean(dim=1).sqrt()
