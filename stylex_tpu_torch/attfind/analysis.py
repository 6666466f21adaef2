"""AttFind analysis: greedy significant-style selection and scoring.

NumPy implementations of the reference notebook's analysis cells 11-16,
with the same greedy semantics, so top-k coordinate lists of the port, the
JAX package and the reference compare directly.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = [
    "filter_unstable_images",
    "split_by_class",
    "find_significant_styles",
    "merge_and_score",
    "style_vector_distances",
    "rank_styles",
    "warn_visualize_top",
]


def filter_unstable_images(
    style_change_effect: np.ndarray, effect_threshold: float = 0.3, num_indices_threshold: int = 150
) -> np.ndarray:
    """Zero out images with too many large effects (cell 11)."""
    out = style_change_effect.copy()
    unstable = (np.abs(out) > effect_threshold).sum(axis=(1, 2, 3)) > num_indices_threshold
    out[unstable] = 0.0
    return out


def split_by_class(
    style_change_effect: np.ndarray,
    latents: np.ndarray,
    base_probs: np.ndarray,
    style_coordinates: np.ndarray,
    minima: np.ndarray,
    maxima: np.ndarray,
    num_classes: int = 2,
):
    """Per-class effect/latent/distance dicts (cell 14)."""
    labels = np.argmax(base_probs, axis=1)
    distances = style_vector_distances(style_coordinates, minima, maxima)
    effects: Dict[int, np.ndarray] = {}
    w_cls: Dict[int, np.ndarray] = {}
    dist_cls: Dict[int, np.ndarray] = {}
    coords_cls: Dict[int, np.ndarray] = {}
    for cls in range(num_classes):
        idx = np.flatnonzero(labels == cls)
        effects[cls] = style_change_effect[idx]
        w_cls[cls] = latents[idx]
        dist_cls[cls] = distances[idx]
        coords_cls[cls] = style_coordinates[idx]
    return effects, w_cls, dist_cls, coords_cls


def style_vector_distances(style_coordinates: np.ndarray, minima: np.ndarray, maxima: np.ndarray) -> np.ndarray:
    """Distance of each coordinate to its min/max extreme: (N, C, 2)."""
    d_min = style_coordinates - minima[None]
    d_max = maxima[None] - style_coordinates
    return np.stack([d_min, d_max], axis=-1)


def find_significant_styles(
    style_change_effect: np.ndarray,
    num_indices: int,
    class_index: int,
    max_image_effect: float = 0.2,
    sindex_offset: int = 0,
) -> List[Tuple[int, int]]:
    """Greedy top-k StyleSpace coordinates (cell 15).

    Repeatedly pick the (direction, sindex) with the largest mean positive
    effect toward ``class_index`` over images whose accumulated effect is
    still below ``max_image_effect``; zero the column and repeat.

    Returns a list of (direction, sindex + offset) pairs.
    """
    num_images = style_change_effect.shape[0]
    num_coords = style_change_effect.shape[2]
    if num_images == 0:
        return []
    effect = np.maximum(0.0, style_change_effect[:, :, :, class_index]).reshape(num_images, -1)

    # termination guard the reference lacks: once every (direction, sindex)
    # column has been picked (and zeroed) there is nothing left to select,
    # so asking for more would spin forever on argmax==0
    num_indices = min(num_indices, effect.shape[1])

    images_effect = np.zeros(num_images)
    picked: List[int] = []
    while len(picked) < num_indices:
        active = images_effect < max_image_effect
        if not np.any(active):
            # DELIBERATE deviation: when every image saturates, the
            # reference's mean over an empty selection is all-NaN and its
            # argmax degenerates to flat index 0, so it appends
            # (direction 0, sindex 0+offset) repeatedly (with a
            # RuntimeWarning). Re-activating all images keeps the greedy
            # scan meaningful instead of emitting that garbage tail.
            active = np.ones(num_images, bool)
        next_s = int(np.argmax(np.mean(effect[active], axis=0)))
        picked.append(next_s)
        images_effect += effect[:, next_s]
        effect[:, next_s] = 0.0
    return [(s // num_coords, (s % num_coords) + sindex_offset) for s in picked]


def merge_and_score(
    style_change_effect: np.ndarray,
    per_class_picks: Dict[int, List[Tuple[int, int]]],
    num_indices: int,
) -> List[Tuple[int, int]]:
    """Merge both classes' picks into one ranked list (cell 16).

    Class-1 picks flip direction; scores are
    ``mean(effect[:, dir, s, 0]) + mean(effect[:, 1-dir, s, 1])`` and the
    union is sorted descending.
    """
    class0 = per_class_picks.get(0, [])
    class1 = per_class_picks.get(1, [])
    sindex_class_0 = {s for _, s in class0}
    joined = [(1 - d, s) for d, s in class1 if s not in sindex_class_0]
    joined += class0
    scores = []
    for direction, sindex in joined:
        other = 1 - direction
        scores.append(
            float(
                np.mean(style_change_effect[:, direction, sindex, 0])
                + np.mean(style_change_effect[:, other, sindex, 1])
            )
        )
    order = np.argsort(scores)[::-1]
    return [joined[i] for i in order][:num_indices]


def rank_styles(
    records,
    num_classes: int = 2,
    num_indices: int = 5,
    effect_threshold: float = 0.5,
):
    """The full analysis chain (cells 14-16) over an
    :class:`~stylex_tpu_torch.attfind.extraction.AttFindRecords` (or anything with
    its attributes): per-class split -> greedy picks -> merged ranked list.

    Returns ``(ranked, per_class)``. Classes with zero images contribute no
    picks (the reference's analysis would crash on an empty class).
    """
    effects_cls, _, _, _ = split_by_class(
        records.style_change,
        records.latents,
        records.base_prob,
        records.style_coordinates,
        records.minima,
        records.maxima,
        num_classes=num_classes,
    )
    per_class: Dict[int, List[Tuple[int, int]]] = {}
    for class_index in range(num_classes):
        if len(effects_cls[class_index]) == 0:
            per_class[class_index] = []
            continue
        per_class[class_index] = find_significant_styles(
            effects_cls[class_index],
            num_indices,
            class_index,
            max_image_effect=effect_threshold * 5,
        )
    ranked = merge_and_score(records.style_change, per_class, num_indices)
    return ranked, per_class


def warn_visualize_top(requested: int, num_ranked: int, num_indices: int) -> None:
    """Shared CLI warning when more panels are asked for than the greedy
    pool (bounded by ``num_indices`` per class) can rank. Enlarging the
    pool silently instead would CHANGE the ranking, so the CLIs clamp and
    say so (run_attfind / replay_results)."""
    if requested > num_ranked:
        print(
            f"warning: --visualize-top {requested} exceeds the "
            f"{num_ranked} ranked styles (--num-indices {num_indices}); "
            f"rendering {num_ranked} panels — raise --num-indices for more"
        )
