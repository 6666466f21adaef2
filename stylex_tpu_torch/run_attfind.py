"""AttFind CLI: extraction, ranking and records for a trained StylEx.

    python -m stylex_tpu_torch.run_attfind --name plants --load-from 100 \\
        --classifier-name mobilenet --classifier-path mobilenet_plants.msgpack \\
        --data ./data/plants --num-images 250 --dtype bfloat16

The model is named as the JAX package's CLI names it: ``--name`` under
``--base-dir``/``--models-dir``, its latest (or ``--load-from``) checkpoint,
the port's ``model_<n>.pt`` or the JAX package's ``model_<n>.ckpt``, loaded
by ``Trainer.load(inference=True, ship_ema=False, param_dtype=<--dtype>)``
(the sweep uses the live nets only); or ``--checkpoint`` (a reference-layout
``.pt`` or a JAX ``.ckpt``) with its ``--config``. The classifier is a
torchvision-layout state dict or an ingested ``.msgpack``. The StyleSpace
sweep runs on the GPU (``--device cpu`` runs it on the host), writes
``style_change_records.hdf5`` (the reference schema; ``.npz`` with the
same datasets where h5py is not installed) and ``top_styles.json``
to ``--results-folder``, and prints the ranked (direction, sindex) pairs.
With ``--visualize-top N`` it then renders the counterfactual panel of each
of the top N styles (``visualize_style``: images whose effect exceeds 0.1,
at least one) and saves each that passes as ``style_<direction>_<sindex>.png``
beside the records, as the JAX package's CLI does.

Google's published StylEx runs from its dlatents: ``--google-generator``
names a :func:`~stylex_tpu_torch.models.google_stylex.save_google_generator`
file (convert the release's SavedModel with
:func:`~stylex_tpu_torch.ingest_tf.convert_google_generator` on a host with
TensorFlow), ``--dlatents`` a ``.npy`` of (N, 514) dlatents or the
release's examples ``.tfrecord``::

    python -m stylex_tpu_torch.run_attfind --google-generator google256.pt \
        --dlatents examples_1.tfrecord --classifier-name mobilenet \
        --classifier-path mobilenet_celeba.msgpack --num-images 50

The sweep resumes at each resolution; the extremes of each coordinate are
taken over every dlatent given (the first ``--num-images`` enter the
sweep), and ``top_styles.json`` also gives each ranked style's
(layer, index within the layer) of the generator's ``layer_shapes``.

The sweep is split over data-parallel ranks as the JAX CLI shards it over
its trainer's mesh: over the largest count of GPUs present that divides
the training batch size (``TrainConfig().batch_size``), one process per
GPU. With one device (one GPU, an indexed ``--device cuda:N``, or
``--device cpu``) it runs in this process, with no process group. Every
rank computes the same records; rank 0 writes them, the ranking and the
panels.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's flags, checked."""
    from stylex_tpu_torch.replay_results import add_model_args

    p = argparse.ArgumentParser(description="StylEx AttFind attribute discovery (PyTorch)")
    add_model_args(p)
    p.add_argument("--data", default="./data")
    p.add_argument("--dataset-name", default=None, help="'synthetic' for generated images")
    p.add_argument("--num-images", type=int, default=250)
    p.add_argument("--num-indices", type=int, default=5)
    p.add_argument("--shift-size", type=float, default=1.0)
    p.add_argument("--effect-threshold", type=float, default=0.5)
    p.add_argument("--discriminator-threshold", type=float, default=None)
    p.add_argument("--use-discriminator", action="store_true")
    p.add_argument("--coord-batch", type=int, default=512)
    p.add_argument("--chunks-per-dispatch", type=int, default=8,
                   help="sweep chunks issued back to back whose effects share one "
                        "device-to-host copy; the records do not depend on it")
    p.add_argument("--no-block-resume", action="store_true",
                   help="use the flat full-recompute sweep")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="sweep compute dtype; records are float32 either way")
    p.add_argument("--results-folder", default="./attfind_results")
    p.add_argument("--visualize-top", type=int, default=0,
                   help="render counterfactual panels for the top-N styles")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--google-generator", default=None,
                   help="a save_google_generator .pt: sweep Google's StylEx from --dlatents")
    p.add_argument("--dlatents", default=None,
                   help="with --google-generator: a .npy of (N, dlatent_dim) dlatents, or an "
                        "examples .tfrecord")
    args = p.parse_args(argv)
    if args.google_generator is not None:
        if args.dlatents is None:
            p.error("--google-generator needs --dlatents")
        if args.use_discriminator or args.visualize_top:
            p.error("--google-generator has no discriminator and no panels: drop "
                    "--use-discriminator and --visualize-top")
        return args
    if args.use_discriminator and args.discriminator_threshold is None:
        p.error("--use-discriminator needs --discriminator-threshold "
                "(the reference uses -0.5 for the plant model)")
    if args.name is None and args.checkpoint is None:
        p.error("a model is needed: --name, or --checkpoint with --config")
    return args


def main(argv=None) -> list:
    """Run the CLI. Returns each rank's ``seconds`` of extraction,
    ``styles`` (perturbed forwards) and kernel ``launches``."""
    from stylex_tpu_torch.config import TrainConfig
    from stylex_tpu_torch.parallel import launch, make_mesh, resolve_num_devices

    args = parse_args(argv)
    n = resolve_num_devices(None, TrainConfig().batch_size, args.device)
    if n > 1:
        return launch(extract, n, args.device, args=(args,))
    return [extract(make_mesh(1, args.device), args)]


def load_dlatents(path: str) -> np.ndarray:
    """(N, dlatent_dim) float32 dlatents of a ``.npy`` or an examples
    ``.tfrecord``."""
    if str(path).endswith(".npy"):
        return np.load(path).astype(np.float32)
    from stylex_tpu_torch.ingest_tf import load_examples_tfrecord

    return load_examples_tfrecord(path)[0].astype(np.float32)


@torch.no_grad()
def _google_inputs(args, device, dtype):
    """Google's generator, the classifier, the dlatents that enter the
    sweep and the range of every coordinate over all of them."""
    from stylex_tpu_torch.models import build_classifier
    from stylex_tpu_torch.models.google_stylex import load_google_generator

    spec, gen = load_google_generator(args.google_generator, device=device)
    gen.to(dtype)
    clf = build_classifier(args.classifier_name, spec.image_size,
                           checkpoint_path=args.classifier_path, device=device)
    dlatents = load_dlatents(args.dlatents)
    coords = [torch.cat(gen.style_vectors(torch.from_numpy(b).to(device, dtype))[0], dim=-1)
              for b in np.array_split(dlatents, max(1, len(dlatents) // 256))]
    coords = torch.cat(coords).float()
    style_range = (coords.min(0).values.cpu().numpy(), coords.max(0).values.cpu().numpy())
    return spec, gen, clf, dlatents[:args.num_images], style_range


def extract(mesh, args: argparse.Namespace) -> dict:
    """The extraction, ranking and outputs on one rank of ``mesh`` (every
    rank of a launched group calls it with the same ``args``)."""
    from stylex_tpu_torch.replay_results import load_model

    from stylex_tpu_torch.attfind import (
        attfind_extraction,
        rank_styles,
        records_file_name,
        save_records,
        visualize_style,
        warn_visualize_top,
    )
    from stylex_tpu_torch.data import FolderDataset, SyntheticImageDataset
    from stylex_tpu_torch.device import resolve_dtype
    from stylex_tpu_torch.ops import LAUNCHES
    from stylex_tpu_torch.ops.latents import image_noise

    args.device = str(mesh.device)
    dtype = resolve_dtype(args.dtype)
    spec, style_range = None, None
    if args.google_generator is not None:
        spec, model, clf, images, style_range = _google_inputs(args, mesh.device, dtype)
        clf.to(dtype)
        num_classes, device, n, noise = clf.num_classes, mesh.device, len(images), None
    else:
        model, clf = load_model(args, ship_ema=False, param_dtype=dtype)
        clf.to(dtype)
        num_classes = model.cfg.num_classes
        image_size = model.cfg.image_size
        device = next(model.G.parameters()).device

        if args.dataset_name == "synthetic":
            ds = SyntheticImageDataset(args.num_images, image_size)
        else:
            ds = FolderDataset(args.data, image_size)
        n = min(args.num_images, len(ds))
        # with the D filter, over-sample candidates so the sweep still gets n survivors
        pool = min(4 * n, len(ds)) if args.use_discriminator else n
        images = np.stack([ds[i] for i in range(pool)])
        # the fixed noise image shared by every forward
        noise = image_noise(torch.Generator().manual_seed(args.seed), 1, image_size).numpy()

    t0 = time.perf_counter()
    records = attfind_extraction(
        model, clf.classify_images, images, noise,
        shift_size=args.shift_size,
        discriminator_threshold=args.discriminator_threshold,
        use_discriminator=args.use_discriminator,
        num_images=n,
        coord_batch=args.coord_batch,
        block_resume=not args.no_block_resume,
        compute_dtype=dtype,
        chunks_per_dispatch=args.chunks_per_dispatch,
        mesh=mesh,
        style_range=style_range,
    )
    dt = time.perf_counter() - t0
    total = records.style_change.shape[0] * 2 * records.style_change.shape[2]
    summary = dict(rank=mesh.rank, seconds=dt, styles=total, launches=dict(LAUNCHES))
    if mesh.rank != 0:
        return summary
    print(f"AttFind sweep: {total} perturbed forwards in {dt:.3f}s = {total / dt:.1f} styles/s "
          f"on {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}"
          f" x {mesh.world_size} rank(s)")

    out = Path(args.results_folder)
    out.mkdir(parents=True, exist_ok=True)
    records_path = out / records_file_name()
    if records_path.suffix == ".npz":
        print(f"h5py is not installed: records written to {records_path} (the hdf5 datasets)")
    save_records(records, str(records_path))
    ranked, per_class = rank_styles(records, num_classes=num_classes,
                                    num_indices=args.num_indices,
                                    effect_threshold=args.effect_threshold)
    print("Directions and style indices for moving from class 1 to class 0 =",
          ranked[: args.num_indices])
    print("Use the other direction to move from class 0 to 1.")
    top = {"ranked": ranked, "per_class": {str(k): v for k, v in per_class.items()}}
    if spec is not None:  # (layer, index within the layer) of each ranked style
        top["layers"] = [spec.sindex_to_layer_and_index(int(s)) for _, s in ranked]
    (out / "top_styles.json").write_text(json.dumps(top))

    warn_visualize_top(args.visualize_top, len(ranked), args.num_indices)
    for direction, sindex in ranked[: args.visualize_top]:
        panel = visualize_style(model, clf.classify_images, records, sindex, direction,
                                shift_size=args.shift_size, effect_threshold=0.1, min_images=1)
        if panel is not None:
            from PIL import Image

            Image.fromarray(panel).save(out / f"style_{direction}_{sindex}.png")
    return summary


if __name__ == "__main__":
    main()
