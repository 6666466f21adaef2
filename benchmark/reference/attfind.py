"""The plain reference of AttFind extraction's arithmetic, float32.

Phase 1 of one image batch: w = [E(x); classifier logits], the image and
its StyleSpace coordinates from G, the D score and the base logits of the
generated image. A perturbation (image, coordinate, direction) adds
``(extreme - current) * shift_size`` to that one coordinate (the extreme is
the minimum or maximum of the coordinate over the call's images) and runs
the whole generator and the classifier again; its effect is the change of
the logits. The program may resume the generator at the perturbed block;
the reference always runs it whole.

This file imports nothing but torch and its siblings.
"""

from __future__ import annotations

import torch

from . import nets


@torch.no_grad()
def phase1(model, classifier, images: torch.Tensor, noise: torch.Tensor):
    """(N, 3, S, S) images -> w (N, latent), coords (N, C), D score (N,),
    base logits (N, K)."""
    c = model.cfg
    w = nets.make_w(c, model.encoder(images), classifier(images))
    styles = w[:, None].expand(-1, model.num_layers, -1)
    gen, coords = model.G(styles, noise)
    logits = classifier(gen)
    probs = torch.softmax(logits, -1) if c["arch"] == "new" else None
    return w, coords, model.D(gen, probs), logits


@torch.no_grad()
def effects(model, classifier, w, coords, base, noise, img, coord, is_max,
            shift_size: float = 1.0, batch: int = 256) -> torch.Tensor:
    """Logit changes (P, K) of the perturbations ``(img[i], coord[i],
    is_max[i])`` of the images whose phase-1 outputs are ``w``, ``coords``
    and ``base``."""
    lo, hi = coords.min(0).values, coords.max(0).values
    out = []
    for s in range(0, img.shape[0], batch):
        i, k, mx = img[s:s + batch], coord[s:s + batch], is_max[s:s + batch]
        shift = (torch.where(mx, hi[k], lo[k]) - coords[i, k]) * shift_size
        delta = torch.zeros(i.shape[0], coords.shape[1], device=w.device)
        delta[torch.arange(i.shape[0], device=w.device), k] = shift
        styles = w[i][:, None].expand(-1, model.num_layers, -1)
        gen, _ = model.G(styles, noise, style_delta=delta)
        out.append(classifier(gen) - base[i])
    return torch.cat(out)
