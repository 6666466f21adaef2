"""User-study stimuli: odd-one-out counterfactual GIFs and their answer key.

The reference ships the artifacts of its perceptual user studies (two-frame
GIFs and an ``info_of_images.txt`` answer key) but not the code that made
them; the JAX package's ``user_study.py`` regenerates that family from a
model and AttFind records, and this is its port:

* each stimulus is a square two-frame GIF, a 2x2 grid of ``panel_px``
  panels with ``gutter``-pixel black gutters (the reference's 1030x1030 at
  750 ms a frame: 512-pixel panels, 2-pixel gutters); frame 0 holds four
  base reconstructions, frame 1 their counterfactuals;
* three quadrants apply the same ranked (direction, sindex) shift to three
  images, the odd one out applies the next ranked style;
* quadrants are in row-major order ``[top-left, top-right, bottom-left,
  bottom-right]``; GIF names are shuffled so that a name never gives away
  the question's order;
* ``info_of_images.txt`` holds, per question, the odd quadrant's position,
  the ``(question, gif)`` pair and the 4x2 ``[direction, sindex]`` matrix,
  in the reference's text schema.

The picks and the GIF order come from ``numpy.random.RandomState(seed)``
in the JAX package's order, so the same records and seed give the same
answer key. Each frame is one batched generator forward of the four
quadrants with an explicit ``style_delta``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from stylex_tpu_torch.attfind.extraction import AttFindRecords
from stylex_tpu_torch.attfind.visualize import _gen
from stylex_tpu_torch.utils.image import to_uint8

__all__ = ["render_study_frames", "generate_user_study", "QUADRANT_NAMES", "main"]

QUADRANT_NAMES = ("top-left", "top-right", "bottom-left", "bottom-right")


def _compose_grid(panels: Sequence[np.ndarray], panel_px: int, gutter: int) -> np.ndarray:
    """Four (H, W, 3) uint8 panels, each resized to ``panel_px``, in a 2x2
    grid with black gutters: ``2 * panel_px + 3 * gutter`` pixels a side."""
    from PIL import Image

    side = 2 * panel_px + 3 * gutter
    canvas = Image.new("RGB", (side, side), (0, 0, 0))
    for q, panel in enumerate(panels):
        im = Image.fromarray(panel).resize((panel_px, panel_px), Image.BILINEAR)
        canvas.paste(im, (gutter + (q % 2) * (panel_px + gutter),
                          gutter + (q // 2) * (panel_px + gutter)))
    return np.asarray(canvas)


def render_study_frames(model, classifier_fn, records: AttFindRecords,
                        image_ids: Sequence[int], styles: Sequence[tuple],
                        shift_size: float = 1.0, panel_px: int = 512,
                        gutter: int = 2) -> tuple:
    """One stimulus: (base frame, counterfactual frame), uint8 grids.
    Quadrant q shows record ``image_ids[q]`` shifted by ``styles[q] =
    (direction, sindex)``."""
    C = records.style_change.shape[2]
    w = records.latents[np.asarray(image_ids)]
    delta = np.zeros((len(image_ids), C), dtype=np.float32)
    for q, (i, (direction, sindex)) in enumerate(zip(image_ids, styles)):
        extreme = records.minima[sindex] if direction == 0 else records.maxima[sindex]
        delta[q, sindex] = (extreme - records.style_coordinates[i, sindex]) * shift_size
    base, _ = _gen(model, classifier_fn, w, records.noise)
    pert, _ = _gen(model, classifier_fn, w, records.noise, delta)
    return (_compose_grid(list(to_uint8(base)), panel_px, gutter),
            _compose_grid(list(to_uint8(pert)), panel_px, gutter))


def _pick_images(rng, candidates: np.ndarray, k: int, exclude: set) -> list:
    pool = [int(i) for i in candidates if int(i) not in exclude]
    if len(pool) >= k:
        return [int(i) for i in rng.choice(np.asarray(pool), size=k, replace=False)]
    # too few records: reuse images across quadrants rather than fail
    extra = [int(i) for i in candidates]
    picks = pool[:]
    while len(picks) < k and extra:
        picks.append(extra[len(picks) % len(extra)])
    return picks[:k]


def generate_user_study(
    model,
    classifier_fn,
    records: AttFindRecords,
    out_dir,
    num_studies: int = 6,
    ranked: Optional[Sequence[tuple]] = None,
    num_indices: int = 6,
    num_classes: int = 2,
    effect_threshold: float = 0.1,
    shift_size: float = 1.0,
    panel_px: int = 512,
    gutter: int = 2,
    frame_ms: int = 750,
    seed: int = 0,
) -> list:
    """Write ``class_study_<gif>.gif`` stimuli and ``info_of_images.txt``
    under ``out_dir``; return each study's metadata.

    Study k's majority style is ``ranked[k % len(ranked)]`` (by default
    ``rank_styles``'s ranking) and its odd quadrant takes the next distinct
    ranked style. Quadrant images are drawn from the records whose class-0
    effect of the style exceeds ``effect_threshold``, or else the four
    strongest."""
    from PIL import Image

    from stylex_tpu_torch.attfind.analysis import rank_styles

    if ranked is None:
        ranked, _ = rank_styles(records, num_classes=num_classes, num_indices=num_indices,
                                effect_threshold=effect_threshold)
    ranked = [(int(d), int(s)) for d, s in ranked]
    if len(ranked) < 2:
        raise ValueError(
            f"user study needs >=2 ranked styles to build an odd-one-out, got {ranked}")

    rng = np.random.RandomState(seed)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    gif_order = rng.permutation(num_studies)

    def candidates(direction: int, sindex: int) -> np.ndarray:
        effects = records.style_change[:, direction, sindex, 0]
        above = np.flatnonzero(effects > effect_threshold)
        return above if above.size >= 1 else np.argsort(effects)[::-1][:4]

    studies = []
    for k in range(num_studies):
        main_style = ranked[k % len(ranked)]
        odd = ranked[(k + 1) % len(ranked)]
        if odd == main_style:
            odd = next(st for st in ranked if st != main_style)
        odd_pos = int(rng.randint(4))
        main_ids = _pick_images(rng, candidates(*main_style), 3, exclude=set())
        odd_ids = _pick_images(rng, candidates(*odd), 1, exclude=set(main_ids))
        image_ids, styles = [], []
        main_iter = iter(main_ids)
        for q in range(4):
            if q == odd_pos:
                image_ids.append(odd_ids[0])
                styles.append(odd)
            else:
                image_ids.append(next(main_iter))
                styles.append(main_style)

        base, pert = render_study_frames(model, classifier_fn, records, image_ids, styles,
                                         shift_size=shift_size, panel_px=panel_px,
                                         gutter=gutter)
        gif_idx = int(gif_order[k])
        frames = [Image.fromarray(base), Image.fromarray(pert)]
        frames[0].save(out / f"class_study_{gif_idx}.gif", save_all=True,
                       append_images=frames[1:], duration=frame_ms, loop=0)
        studies.append({"question": k, "gif": gif_idx, "odd_position": odd_pos,
                        "image_ids": image_ids, "styles": styles})

    lines = []
    for st in studies:
        mat = np.asarray([[d, s] for d, s in st["styles"]], dtype=np.int64)
        lines.append(f"Odd transformation in {QUADRANT_NAMES[st['odd_position']]} \n"
                     f" ({st['question']}, {st['gif']}) \n {mat} \n")
    (out / "info_of_images.txt").write_text("\n".join(lines))
    return studies


def main(argv=None) -> None:
    import argparse

    from stylex_tpu_torch.replay_results import add_model_args, load_model

    p = argparse.ArgumentParser(
        description="Generate odd-one-out counterfactual user-study stimuli")
    p.add_argument("--records", required=True, help="style_change_records.hdf5 (or .npz)")
    p.add_argument("--out", default="./user_study")
    p.add_argument("--num-studies", type=int, default=6)
    p.add_argument("--num-indices", type=int, default=6)
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--effect-threshold", type=float, default=0.1)
    p.add_argument("--shift-size", type=float, default=1.0)
    p.add_argument("--panel-px", type=int, default=512)
    p.add_argument("--frame-ms", type=int, default=750)
    p.add_argument("--seed", type=int, default=0)
    add_model_args(p)
    args = p.parse_args(argv)

    from stylex_tpu_torch.attfind import load_records

    loaded = load_model(args)
    if loaded is None:
        p.error("a model is needed: --name, or --checkpoint with --config")
    model, clf_fn = loaded[0], loaded[1].classify_images
    studies = generate_user_study(
        model, clf_fn, load_records(args.records), args.out,
        num_studies=args.num_studies, num_indices=args.num_indices,
        num_classes=args.num_classes, effect_threshold=args.effect_threshold,
        shift_size=args.shift_size, panel_px=args.panel_px, frame_ms=args.frame_ms,
        seed=args.seed)
    print(f"wrote {len(studies)} stimuli + info_of_images.txt under {args.out}")


if __name__ == "__main__":
    main()
