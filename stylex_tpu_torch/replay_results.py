"""Replay AttFind results from precomputed records: the report and panels.

    python -m stylex_tpu_torch.replay_results \\
        --records ./attfind_out/style_change_records.hdf5 --out ./replay_out

From a ``style_change_records.hdf5`` (as ``run_attfind`` writes it) this
always writes the per-class greedy picks and the merged ranking (printed,
and ``top_styles.json`` with per-style effect summaries): no model needed,
no StyleSpace re-sweep. Given a model it also renders, for the top
``--visualize-top`` styles, the by-effect panel (``style_<d>_<s>.png``,
when enough images pass ``--panel-threshold``) and the by-distance panel
(``style_<d>_<s>_by_distance.png``). The model is either the port's own
checkpoint (``--name`` under ``--base-dir``/``--models-dir``, its ``.pt`` or the JAX
package's ``.ckpt``, through ``Trainer.load(inference=True)``) or a
reference-layout ``.pt`` or JAX ``.ckpt`` with its ``.config.json``
(``--checkpoint`` and ``--config``, as ``run_attfind`` takes them). It runs
on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

__all__ = ["main", "add_model_args", "load_model"]


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The flags that name a model (``--name``, or ``--checkpoint`` with
    ``--config``) and its classifier."""
    p.add_argument("--name", default=None,
                   help="the model's name under --models-dir: its latest (or --load-from) "
                        "model_<n>.pt or the JAX package's model_<n>.ckpt")
    p.add_argument("--base-dir", default="./")
    p.add_argument("--models-dir", default="models")
    p.add_argument("--load-from", type=int, default=-1)
    p.add_argument("--checkpoint", default=None,
                   help="a reference-layout StylEx .pt or a JAX .ckpt, with --config")
    p.add_argument("--config", default=None, help="the checkpoint's .config.json")
    p.add_argument("--classifier-name", default="resnet")
    p.add_argument("--classifier-path", default=None)
    p.add_argument("--device", default=None, help="default: the GPU")


def load_model(args, ship_ema: bool = True, param_dtype=None):
    """(StylEx in eval mode, its ClassifierBundle) from the flags of
    :func:`add_model_args`, the model's float32 weights cast to
    ``param_dtype``; None when they name no model. ``--name`` loads through
    ``Trainer.load(inference=True)``, which places only the parameters on
    the device (the EMA copies only with ``ship_ema``)."""
    if args.checkpoint is not None:
        if args.config is None:
            raise SystemExit("--checkpoint needs --config (the model's .config.json)")
        from stylex_tpu_torch.config import ModelConfig
        from stylex_tpu_torch.device import resolve_device
        from stylex_tpu_torch.models import build_classifier
        from stylex_tpu_torch.models.stylex import StylEx
        from stylex_tpu_torch.utils.checkpoint import read_model_weights

        device = resolve_device(args.device)
        cfg = ModelConfig.from_json(Path(args.config).read_text())
        model = StylEx(cfg)
        model.load_state_dict(read_model_weights(args.checkpoint, cfg))
        clf = build_classifier(args.classifier_name, cfg.image_size, cfg.num_classes,
                               checkpoint_path=args.classifier_path, device=device)
        return model.to(param_dtype or torch.float32).to(device).eval(), clf
    if args.name is None:
        return None
    from stylex_tpu_torch.train.trainer import Trainer

    trainer = Trainer(name=args.name, base_dir=args.base_dir, models_dir=args.models_dir,
                      classifier_name=args.classifier_name,
                      classifier_path=args.classifier_path, device=args.device)
    trainer.load(args.load_from, inference=True, ship_ema=ship_ema, param_dtype=param_dtype)
    return trainer.state.model.eval(), trainer.classifier


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Replay StylEx AttFind results from precomputed records")
    p.add_argument("--records", required=True, help="style_change_records.hdf5 (or .npz)")
    p.add_argument("--out", default="./replay_results")
    p.add_argument("--num-indices", type=int, default=5)
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--effect-threshold", type=float, default=0.5)
    p.add_argument("--shift-size", type=float, default=1.0)
    add_model_args(p)
    p.add_argument("--visualize-top", type=int, default=5)
    p.add_argument("--panel-threshold", type=float, default=0.1)
    p.add_argument("--min-images", type=int, default=1)
    p.add_argument("--max-images", type=int, default=10)
    args = p.parse_args(argv)

    from stylex_tpu_torch.attfind import load_records, rank_styles, warn_visualize_top

    records = load_records(args.records)
    n, _, c, _ = records.style_change.shape
    print(f"records: {n} images x {c} StyleSpace coordinates x 2 directions "
          f"({args.records})")

    ranked, per_class = rank_styles(records, num_classes=args.num_classes,
                                    num_indices=args.num_indices,
                                    effect_threshold=args.effect_threshold)
    warn_visualize_top(args.visualize_top, len(ranked), args.num_indices)

    labels = np.argmax(records.base_prob, axis=1)
    for ci in range(args.num_classes):
        print(f"class {ci}: {int((labels == ci).sum())} images, "
              f"picks {per_class.get(ci, [])}")
    print("Directions and style indices for moving from class 1 to class 0 =",
          ranked[: args.num_indices])
    print("Use the other direction to move from class 0 to 1.")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sc = records.style_change
    summary = {
        "ranked": ranked,
        "per_class": {str(kk): v for kk, v in per_class.items()},
        "num_images": int(n),
        "num_style_coords": int(c),
        "per_style": [
            {
                "direction": int(d),
                "sindex": int(s),
                "mean_effect_class0": float(np.mean(sc[:, d, s, 0])),
                "mean_effect_class1": float(np.mean(sc[:, 1 - d, s, 1])),
                "num_images_above_threshold": int((sc[:, d, s, 0] > args.panel_threshold).sum()),
            }
            for d, s in ranked
        ],
    }
    (out / "top_styles.json").write_text(json.dumps(summary, indent=1))
    print(f"report written to {out / 'top_styles.json'}")

    loaded = load_model(args)
    if loaded is None:
        print("no --name given: report-only (pass a checkpoint name to render "
              "counterfactual panels)")
        return

    from PIL import Image

    from stylex_tpu_torch.attfind import visualize_style, visualize_style_by_distance_in_s

    model, clf_fn = loaded[0], loaded[1].classify_images
    rendered = 0
    for direction, sindex in ranked[: args.visualize_top]:
        panel = visualize_style(model, clf_fn, records, sindex, direction,
                                shift_size=args.shift_size,
                                effect_threshold=args.panel_threshold,
                                max_images=args.max_images, min_images=args.min_images)
        if panel is not None:
            Image.fromarray(panel).save(out / f"style_{direction}_{sindex}.png")
            rendered += 1
        panel_d = visualize_style_by_distance_in_s(model, clf_fn, records, sindex, direction,
                                                   shift_size=args.shift_size,
                                                   max_images=args.max_images)
        Image.fromarray(panel_d).save(out / f"style_{direction}_{sindex}_by_distance.png")
    print(f"panels rendered for top {args.visualize_top} styles "
          f"({rendered} passed the effect threshold) under {out}")


if __name__ == "__main__":
    main()
