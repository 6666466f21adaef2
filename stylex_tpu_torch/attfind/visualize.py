"""Counterfactual panels of AttFind's styles.

Single-coordinate counterfactuals, side-by-side base and perturbed panels
with the classifier's probability as a caption, and the choice of images
per style by recorded effect or by distance to the extreme in StyleSpace:
the reference notebook's rendering cells, as the JAX package's
``attfind/visualize.py`` has them. Every panel is one batched generator
forward with an explicit ``style_delta``, then the classifier's softmax,
under ``torch.no_grad()`` on the model's device and in its dtype.

Generation takes the default (fused) resample graph, as the JAX package's
panels do; only the extraction's sweep runs inside
``prefer_literal_resample``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from stylex_tpu_torch.attfind.extraction import AttFindRecords
from stylex_tpu_torch.models.stylex import StylEx
from stylex_tpu_torch.ops.latents import expand_styles
from stylex_tpu_torch.utils.image import to_uint8

__all__ = [
    "generate_change_image_given_dlatent",
    "generate_images_given_dlatent",
    "visualize_style",
    "visualize_style_by_distance_in_s",
]

Classify = Callable[[torch.Tensor], torch.Tensor]


@torch.no_grad()
def _gen(model: StylEx, classifier_fn: Classify, w, noise, delta=None):
    """(B, latent) w, (1, S, S, 1) shared noise and an optional (B, C)
    StyleSpace delta (numpy) -> ((B, S, S, 3) images clipped to [0, 1],
    (B, num_classes) softmax probabilities), both float32 numpy."""
    param = next(model.parameters())

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(param.device, param.dtype)

    delta = None if delta is None else dev(delta)
    imgs, _ = model.generate(expand_styles(dev(w), model.num_layers), dev(noise),
                             style_delta=delta)
    probs = torch.softmax(classifier_fn(imgs).float(), dim=-1)
    imgs = imgs.float().clamp(0.0, 1.0).permute(0, 2, 3, 1)
    return imgs.cpu().numpy(), probs.cpu().numpy()


def _shift(records: AttFindRecords, sindex: int, direction: int, coord, shift_size: float):
    extreme = records.minima[sindex] if direction == 0 else records.maxima[sindex]
    return (extreme - coord) * shift_size


def generate_change_image_given_dlatent(
    model: StylEx, classifier_fn: Classify, dlatent: np.ndarray, noise: np.ndarray,
    records: AttFindRecords, sindex: int, direction: int, shift_size: float = 1.0,
    class_index: int = 0, image_index: Optional[int] = None,
):
    """One image with coordinate ``sindex`` pushed toward its minimum
    (``direction`` 0) or maximum (1) from the image's recorded coordinate
    (the mean over images when ``image_index`` is None). Returns
    ((S, S, 3) image, probability of ``class_index``)."""
    coord = (records.style_coordinates[image_index, sindex] if image_index is not None
             else float(np.mean(records.style_coordinates[:, sindex])))
    delta = np.zeros((1, records.style_change.shape[2]), np.float32)
    delta[0, sindex] = _shift(records, sindex, direction, coord, shift_size)
    img, probs = _gen(model, classifier_fn, np.asarray(dlatent)[None], noise, delta)
    return img[0], float(probs[0, class_index])


def generate_images_given_dlatent(
    model: StylEx, classifier_fn: Classify, dlatent, noise, records: AttFindRecords,
    sindex: int, direction: int, shift_size: float = 1.0, class_index: int = 0,
    image_index: Optional[int] = None, draw_probs: bool = True, return_probs: bool = False,
):
    """A (H, 2W, 3) uint8 panel: the base image beside its counterfactual,
    with ``"p_base -> p_change"`` captioned below when ``draw_probs``; with
    ``return_probs`` also the two probabilities."""
    base_img, base_probs = _gen(model, classifier_fn, np.asarray(dlatent)[None], noise)
    pert_img, pert_prob = generate_change_image_given_dlatent(
        model, classifier_fn, dlatent, noise, records, sindex, direction, shift_size,
        class_index, image_index)
    panel = to_uint8(np.concatenate([base_img[0], pert_img], axis=1)[None])[0]
    base_prob = float(base_probs[0, class_index])
    if draw_probs:
        panel = _caption(panel, f"{base_prob:.2f} -> {pert_prob:.2f}")
    if return_probs:
        return panel, base_prob, pert_prob
    return panel


def _caption(img: np.ndarray, text: str) -> np.ndarray:
    """``img`` over a 12-pixel black bar holding ``text`` in white."""
    from PIL import Image, ImageDraw

    pil = Image.fromarray(img)
    bar = Image.new("RGB", (pil.width, 12), (0, 0, 0))
    ImageDraw.Draw(bar).text((2, 1), text, fill=(255, 255, 255))
    out = Image.new("RGB", (pil.width, pil.height + 12))
    out.paste(pil, (0, 0))
    out.paste(bar, (0, pil.height))
    return np.asarray(out)


def visualize_style(
    model: StylEx, classifier_fn: Classify, records: AttFindRecords, sindex: int,
    direction: int, shift_size: float = 1.0, class_index: int = 0,
    effect_threshold: float = 0.1, max_images: int = 10, min_images: int = 3,
    seed: Optional[int] = None, allow_both_directions_change: bool = False,
) -> Optional[np.ndarray]:
    """Panels, stacked, of the images whose recorded effect of this style
    exceeds ``effect_threshold``; None when fewer than ``min_images`` pass.

    The candidates are shuffled (by ``RandomState(seed)``, or numpy's
    global generator when ``seed`` is None), at most ``max_images * 10`` of
    them are tried, and a panel is kept only when the regenerated
    counterfactual's probability moves by ``effect_threshold`` or more: a
    recorded effect is necessary, not sufficient (a saturated softmax)."""
    effects = records.style_change[:, direction, sindex, class_index]
    if allow_both_directions_change:
        images_idx = np.flatnonzero(np.abs(effects) > effect_threshold)
    else:
        images_idx = np.flatnonzero(effects > effect_threshold)
    if images_idx.size == 0:
        return None
    rng = np.random.RandomState(seed) if seed is not None else np.random
    rng.shuffle(images_idx)
    images_idx = images_idx[: min(max_images * 10, len(images_idx))]

    rows = []
    for i in images_idx:
        panel, base_prob, change_prob = generate_images_given_dlatent(
            model, classifier_fn, records.latents[i], records.noise, records, sindex,
            direction, shift_size, class_index, image_index=int(i), return_probs=True)
        if abs(change_prob - base_prob) < effect_threshold:
            continue
        rows.append(panel)
        if len(rows) == max_images:
            break
    if len(rows) < min_images:
        return None
    return np.concatenate(rows, axis=0)


def visualize_style_by_distance_in_s(
    model: StylEx, classifier_fn: Classify, records: AttFindRecords, sindex: int,
    direction: int, shift_size: float = 1.0, class_index: int = 0, max_images: int = 10,
) -> np.ndarray:
    """Panels, stacked, of the ``max_images`` images farthest in StyleSpace
    from the extreme this style is pushed to: the ones it changes most."""
    extreme = records.minima[sindex] if direction == 0 else records.maxima[sindex]
    dist = np.abs(extreme - records.style_coordinates[:, sindex])
    order = np.argsort(dist)[::-1][:max_images]
    rows = [generate_images_given_dlatent(model, classifier_fn, records.latents[i],
                                          records.noise, records, sindex, direction,
                                          shift_size, class_index, image_index=int(i))
            for i in order]
    return np.concatenate(rows, axis=0)
