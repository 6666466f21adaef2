"""Counterfactual evaluation: the FID-against-top-k-attributes protocol.

The JAX package's ``eval/counterfactual.py`` (the reference's TF FID
notebook) on the port:

* :func:`find_significant_styles_filtered`: the greedy top-k search with
  discriminator rejection: a candidate style is rejected when pushing it
  to its extreme moves D's score by more than the threshold on any probe
  image;
* :func:`create_counterfactual_dataset`: every image with the top-k shifts
  applied jointly, the direction flipped for images of base class 0, one
  batched ``style_delta`` per generator forward;
* :func:`fid_topk`: FID(originals, generated), then FID(originals,
  counterfactuals with the top 1..k styles), written to a
  ``fid_results.csv`` on request.

Generation runs under ``torch.no_grad()`` on the model's device and in its
dtype, on the default (fused) resample graph, as the JAX package runs it.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stylex_tpu_torch.attfind.extraction import AttFindRecords
from stylex_tpu_torch.config import Arch
from stylex_tpu_torch.eval.fid import compute_feature_stats, frechet_distance, resolve_feature_fn
from stylex_tpu_torch.models.stylex import StylEx
from stylex_tpu_torch.ops.latents import expand_styles

__all__ = [
    "find_significant_styles_filtered",
    "create_counterfactual_dataset",
    "fid_topk",
]

Classify = Callable[[torch.Tensor], torch.Tensor]
PROBE_IMAGES = 10


def _on_model(model: StylEx, a: np.ndarray) -> torch.Tensor:
    param = next(model.parameters())
    return torch.as_tensor(np.asarray(a, np.float32)).to(param.device, param.dtype)


@torch.no_grad()
def _probe(model: StylEx, classifier_fn: Classify, w, noise, deltas) -> np.ndarray:
    """|D(G(w)) - D(G(w, deltas))| per image; on the NEW arch D is
    conditioned on the classifier's softmax of each image."""
    w_styles = expand_styles(_on_model(model, w), model.num_layers)
    noise = _on_model(model, noise)
    base, _ = model.generate(w_styles, noise)
    pert, _ = model.generate(w_styles, noise, style_delta=_on_model(model, deltas))
    if model.cfg.arch == Arch.NEW:
        d_base = model.discriminate(base, torch.softmax(classifier_fn(base), dim=-1))
        d_pert = model.discriminate(pert, torch.softmax(classifier_fn(pert), dim=-1))
    else:
        d_base, d_pert = model.discriminate(base), model.discriminate(pert)
    return (d_base - d_pert).abs().float().cpu().numpy()


def _discriminator_filter(model: StylEx, classifier_fn: Classify, records: AttFindRecords,
                          sindex: int, class_index: int, num_images: int = PROBE_IMAGES,
                          change_threshold: float = 0.5, shift_size: float = 2.0,
                          effect_threshold: float = 0.2) -> bool:
    """True when the style passes: for each direction, no probe image (the
    first ``num_images`` whose recorded effect exceeds
    ``effect_threshold``) moves D's score by more than ``change_threshold``
    when the coordinate is pushed ``shift_size`` times toward its extreme.
    The probe batch is padded to ``num_images`` with its first image, which
    cannot change the answer."""
    C = records.style_change.shape[2]
    for direction in range(2):
        effects = records.style_change[:, direction, sindex, class_index]
        idx = np.flatnonzero(effects > effect_threshold)[:num_images]
        if len(idx) == 0:
            continue
        idx = np.concatenate([idx, np.full(num_images - len(idx), idx[0])])
        extreme = records.minima[sindex] if direction == 0 else records.maxima[sindex]
        deltas = np.zeros((len(idx), C), np.float32)
        deltas[:, sindex] = (extreme - records.style_coordinates[idx, sindex]) * shift_size
        moves = _probe(model, classifier_fn, records.latents[idx], records.noise, deltas)
        if bool(np.any(moves > change_threshold)):
            return False
    return True


def find_significant_styles_filtered(
    records: AttFindRecords,
    num_indices: int,
    class_index: int,
    model: Optional[StylEx] = None,
    classifier_fn: Optional[Classify] = None,
    max_image_effect: float = 0.2,
    discriminator_threshold: float = 0.2,
    use_discriminator: bool = True,
    sindex_offset: int = 0,
) -> Tuple[List[Tuple[int, int]], List[int]]:
    """Greedy top-k with discriminator rejection. Returns the picks as
    (direction, sindex) pairs and the rejected sindices, in order. Without
    ``model`` or with ``use_discriminator=False`` it is the plain greedy
    search.

    A rejection zeroes the candidate's column without picking it, so the
    search could run out of StyleSpace: it asks for no more picks than
    columns and stops once no positive effect remains."""
    effect4 = records.style_change
    num_images, _, C, _ = effect4.shape
    effect = np.maximum(0.0, effect4[:, :, :, class_index]).reshape(num_images, -1)
    num_indices = min(num_indices, effect.shape[1])
    images_effect = np.zeros(num_images)
    picks: List[int] = []
    removed: List[int] = []
    while len(picks) < num_indices and effect.max() > 0.0:
        active = images_effect < max_image_effect
        if not np.any(active):
            active = np.ones(num_images, bool)
        next_s = int(np.argmax(np.mean(effect[active], axis=0)))
        sindex = next_s % C
        if use_discriminator and model is not None:
            if sindex == 0 and effect[:, next_s].max() == 0.0:
                break
            if not _discriminator_filter(model, classifier_fn, records, sindex, class_index,
                                         change_threshold=discriminator_threshold):
                effect[:, next_s] = 0.0
                removed.append(sindex)
                continue
        picks.append(next_s)
        images_effect += effect[:, next_s]
        effect[:, next_s] = 0.0
    return [(s // C, (s % C) + sindex_offset) for s in picks], removed


def _counterfactual_deltas(records: AttFindRecords, s_indices_and_signs, k: int,
                           shift_size: float) -> np.ndarray:
    """(N, C) StyleSpace deltas of the top ``k`` picks. An image of base
    class 0 moves each style the other way. The shifts compound: a pick on
    an already shifted coordinate moves it from where the earlier pick left
    it, as the reference re-reads the style vector after each bias
    update."""
    N, C = records.latents.shape[0], records.style_change.shape[2]
    flip = np.argmax(records.base_prob, axis=1) == 0
    deltas = np.zeros((N, C), np.float32)
    for direction, sindex in list(s_indices_and_signs)[:k]:
        eff_dir = np.where(flip, 1 - direction, direction)
        extreme = np.where(eff_dir == 0, records.minima[sindex], records.maxima[sindex])
        current = records.style_coordinates[:, sindex] + deltas[:, sindex]
        deltas[:, sindex] += (extreme - current) * shift_size
    return deltas


@torch.no_grad()
def create_counterfactual_dataset(
    model: StylEx,
    classifier_fn: Optional[Classify],
    records: AttFindRecords,
    s_indices_and_signs: Sequence[Tuple[int, int]],
    k: int,
    shift_size: float = 1.0,
    batch_size: int = 32,
) -> np.ndarray:
    """(N, S, S, 3) images in [0, 1]: every record's latent generated with
    the top ``k`` shifts applied jointly (``k = 0``: the encoder
    round-trip). ``classifier_fn`` is unused: the directions come from the
    recorded base logits."""
    deltas = _counterfactual_deltas(records, s_indices_and_signs, k, shift_size)
    noise = _on_model(model, records.noise)
    outs = []
    for start in range(0, records.latents.shape[0], batch_size):
        w = _on_model(model, records.latents[start:start + batch_size])
        imgs, _ = model.generate(expand_styles(w, model.num_layers), noise,
                                 style_delta=_on_model(model, deltas[start:start + batch_size]))
        outs.append(imgs.float().clamp(0.0, 1.0).permute(0, 2, 3, 1).cpu().numpy())
    return np.concatenate(outs)


def fid_topk(
    model: StylEx,
    classifier_fn: Optional[Classify],
    records: AttFindRecords,
    s_indices_and_signs: Sequence[Tuple[int, int]],
    k: int = 10,
    shift_size: float = 1.0,
    batch_size: int = 32,
    csv_path: Optional[str] = None,
    feature_fn=None,
) -> List[float]:
    """FID(originals, generated), then FID(originals, counterfactuals of the
    top 1..k styles): k + 1 values. The originals' statistics are computed
    once. ``feature_fn`` defaults to :func:`resolve_feature_fn`'s extractor
    on the model's device. With ``csv_path``, writes rows ``k,fid``:
    ``generated`` first, then 1..k."""
    def batches(arr):
        for start in range(0, arr.shape[0], batch_size):
            yield arr[start:start + batch_size]

    feature_fn = resolve_feature_fn(feature_fn, next(model.parameters()).device)
    mu_o, cov_o = compute_feature_stats(batches(records.original_images), feature_fn)

    def fid_vs_originals(picks, kk):
        imgs = create_counterfactual_dataset(model, classifier_fn, records, picks, kk,
                                             shift_size, batch_size)
        mu, cov = compute_feature_stats(batches(imgs), feature_fn)
        return frechet_distance(mu_o, cov_o, mu, cov)

    fids = [fid_vs_originals([], 0)]
    fids += [fid_vs_originals(s_indices_and_signs, i + 1) for i in range(k)]
    if csv_path:
        Path(csv_path).parent.mkdir(parents=True, exist_ok=True)
        with open(csv_path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["k", "fid"])
            writer.writerow(["generated", fids[0]])
            for i, fid in enumerate(fids[1:], 1):
                writer.writerow([i, fid])
    return fids
