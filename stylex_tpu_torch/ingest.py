"""Pretrained-weight ingestion: torch state dicts -> the JAX package's
``.msgpack`` weight trees.

The counterpart of ``stylex_tpu.ingest``, with the same subcommands and the
same files: what one package writes, the other reads. The frozen classifier
(MobileNetV2 / ResNet-18), LPIPS-alex and the FID InceptionV3 are converted
once from a torch state dict on disk into flax's msgpack format, written by
:mod:`~stylex_tpu_torch.utils.flax_msgpack` (no ``flax`` or ``msgpack``
needed):

    python -m stylex_tpu_torch.ingest classifier --src mobilenet.pt --kind mobilenet \\
        --out saved_models/classifier.msgpack [--num-classes 2]
    python -m stylex_tpu_torch.ingest lpips     --src lpips_alex.pt  --out saved_models/lpips_alex.msgpack
    python -m stylex_tpu_torch.ingest inception --src inception_v3.pt --out saved_models/inception_fid.msgpack

Consumers of either package take the ``.msgpack`` path directly:

    Trainer(..., classifier_path='saved_models/classifier.msgpack',
            lpips_path='saved_models/lpips_alex.msgpack')
    STYLEX_TPU_INCEPTION=saved_models/inception_fid.msgpack  # FID

Loaders fail when a requested weights file is missing or malformed; the
seeded random init applies only when no weights were requested.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict

import torch

from stylex_tpu_torch.utils import flax_msgpack

__all__ = ["save_msgpack_tree", "load_msgpack_tree", "ingest_classifier", "ingest_lpips",
           "ingest_inception", "main"]


def save_msgpack_tree(tree, out: str) -> int:
    """Write a tree (nested dicts of numpy arrays or tensors) to ``out`` in
    flax's msgpack format; returns its size in bytes. The one writer of
    weight trees, which ``ClassifierTrainer.save`` uses too."""
    return flax_msgpack.dump(tree, out)


def load_msgpack_tree(path: str):
    """A ``.msgpack`` tree as nested dicts of numpy arrays; raises
    ``FileNotFoundError`` on a missing file."""
    return flax_msgpack.load(path)


def _torch_sd(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        raise FileNotFoundError(f"torch checkpoint not found: {path}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    # some torch checkpoints nest the state dict
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    return sd


def _save(tree, out: str) -> None:
    size = save_msgpack_tree(tree, out)
    print(f"wrote {out} ({size / 1e6:.1f} MB)")


def ingest_classifier(src: str, kind: str, out: str, num_classes: int = 2) -> None:
    """A torchvision ResNet-18 / MobileNetV2 state dict -> flax
    ``{'params', 'batch_stats'}``. ``num_classes`` is the head's, which the
    state dict already fixes; it is taken for the JAX CLI's signature."""
    from stylex_tpu_torch.models.convert import classifier_tree_from_state_dict

    _save(classifier_tree_from_state_dict(_torch_sd(src), kind), out)


def ingest_lpips(src: str, out: str) -> None:
    """A full ``lpips.LPIPS(net='alex')`` state dict (or a torchvision
    AlexNet's) -> the LPIPS tree ``{'conv{i}': {'kernel', 'bias'},
    'lin{i}'}``."""
    from stylex_tpu_torch.models.convert import lpips_tree_from_params
    from stylex_tpu_torch.models.lpips import convert_lpips_state_dict

    _save(lpips_tree_from_params(convert_lpips_state_dict(_torch_sd(src))), out)


def ingest_inception(src: str, out: str) -> None:
    """A torchvision / pytorch_fid ``inception_v3`` state dict -> the
    ``InceptionV3FID`` variables."""
    from stylex_tpu_torch.models.convert import inception_tree_from_state_dict

    _save(inception_tree_from_state_dict(_torch_sd(src)), out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="net", required=True)
    for net in ("classifier", "lpips", "inception"):
        p = sub.add_parser(net)
        p.add_argument("--src", required=True, help="torch state-dict (.pt) path")
        p.add_argument("--out", required=True, help="output .msgpack path")
        if net == "classifier":
            p.add_argument("--kind", default="mobilenet", choices=["mobilenet", "resnet"])
            p.add_argument("--num-classes", type=int, default=2)
    args = ap.parse_args(argv)
    if args.net == "classifier":
        ingest_classifier(args.src, args.kind, args.out, args.num_classes)
    elif args.net == "lpips":
        ingest_lpips(args.src, args.out)
    else:
        ingest_inception(args.src, args.out)


if __name__ == "__main__":
    main()
