"""Classifier-training CLI: the counterpart of ``stylex_tpu.train_classifier``,
with its flags and defaults, plus ``--device``.

    python -m stylex_tpu_torch.train_classifier --dataset FFHQ-Aging \\
        --data-root data/Kaggle_FFHQ_Resized_256px --epochs 20 --lr 1e-4
    python -m stylex_tpu_torch.train_classifier --dataset CelebA --data-root data/celeba \\
        --model resnet --progressive --epochs 3

MobileNetV2 trains with its first ``--amount-frozen-layers`` feature stages
frozen (or only its head, ``--freeze-all-layers``); ResNet-18 with
``--progressive`` unfreezes fc, then layer4, then layer3, one epoch each.
The best validation epoch is saved as ``<saved-models-dir>/<checkpoint-name>``
(``classifier.msgpack``: the JAX package's flax tree, which both packages'
``build_classifier`` read; any other suffix a torchvision state dict), the
test accuracy as ``<results-dir>/<checkpoint-name>.json``, and TensorBoard
scalars under ``--tensorboard-dir``. ``--dataset synthetic`` trains on
generated images with alternating labels. Runs on the GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def labeled_batches(view, batch_size: int, seed: int = 42, shuffle: bool = True):
    """(images, labels) numpy batches of a labeled dataset: uint8 NHWC
    images (a quarter of float32's bytes to the device) and int32 labels,
    the last batch short (the reference's ``DataLoader`` keeps it)."""
    n = len(view)
    order = np.random.RandomState(seed).permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
        samples = [view[int(i)] for i in order[start:start + batch_size]]
        images = np.stack([s[0] for s in samples])
        if images.dtype != np.uint8:
            images = np.clip(images * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
        yield images, np.asarray([s[1] for s in samples], np.int32)


class _SyntheticLabeled:
    """Generated images with labels alternating 0, 1."""

    def __init__(self, n: int, image_size: int, seed: int):
        from stylex_tpu_torch.data import SyntheticImageDataset

        self.ds = SyntheticImageDataset(n, image_size, seed=seed)

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i], i % 2


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train a StylEx classifier (PyTorch)")
    parser.add_argument("--dataset", default="FFHQ-Aging",
                        choices=["FFHQ-Aging", "CelebA", "PlantVillage", "synthetic"])
    parser.add_argument("--data-root", default="data/Kaggle_FFHQ_Resized_256px")
    parser.add_argument("--model", default="mobilenet", choices=["mobilenet", "resnet"])
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--amount-frozen-layers", type=int, default=15)
    parser.add_argument("--freeze-all-layers", action="store_true")
    parser.add_argument("--progressive", action="store_true",
                        help="ResNet progressive unfreeze (fc -> +layer4 -> +layer3)")
    parser.add_argument("--checkpoint-name", default="classifier.msgpack")
    parser.add_argument("--saved-models-dir", default="saved_models")
    parser.add_argument("--results-dir", default="classifier_results")
    parser.add_argument("--tensorboard-dir", default="./tboard_logs")
    parser.add_argument("--device", default=None, help="default: the GPU")
    return parser.parse_args(argv)


def datasets(args):
    """The (train, valid, test) views that ``args`` name."""
    if args.dataset == "FFHQ-Aging":
        from stylex_tpu_torch.data.labeled import FFHQGender

        return FFHQGender(args.data_root, args.image_size).splits(args.seed)
    if args.dataset == "CelebA":
        from stylex_tpu_torch.data.labeled import CelebAAttribute

        return CelebAAttribute(args.data_root, args.image_size).splits(args.seed)
    if args.dataset == "PlantVillage":
        from stylex_tpu_torch.data.labeled import plant_village_splits

        return plant_village_splits(args.data_root, args.image_size, args.seed)
    return tuple(_SyntheticLabeled(n, args.image_size, seed)
                 for n, seed in ((64, 0), (16, 1), (16, 2)))


def train(args):
    """Train, checkpoint and test as ``args`` say; returns the trainer (the
    best validation epoch's weights restored) and ``{test_accuracy,
    best_val_accuracy, epoch_<i>: {loss, train_acc, val_acc}}``."""
    from stylex_tpu_torch.train.classifier_training import (
        ClassifierTrainer,
        mobilenet_freeze_mask,
        resnet_progressive_stages,
    )

    train_v, valid_v, test_v = datasets(args)
    trainer = ClassifierTrainer(args.model, lr=args.lr, seed=args.seed,
                                tensorboard_dir=args.tensorboard_dir, device=args.device)
    trainer.init(args.image_size)
    stages = None
    if args.model == "resnet" and args.progressive:
        stages = resnet_progressive_stages()
    elif args.model == "mobilenet":
        trainer.set_trainable(mask=mobilenet_freeze_mask(args.amount_frozen_layers,
                                                         args.freeze_all_layers))

    # the train loader reshuffles per epoch (the reference's shuffle=True);
    # the evaluation loaders keep the fixed seed
    def loader(view):
        return lambda epoch=0: labeled_batches(view, args.batch_size, args.seed + epoch)

    ckpt = os.path.join(args.saved_models_dir, args.checkpoint_name)
    try:
        history = trainer.fit(loader(train_v), loader(valid_v), args.epochs, ckpt, stages=stages)
        results = trainer.test(loader(test_v), results_path=os.path.join(
            args.results_dir, args.checkpoint_name + ".json"))
    finally:
        trainer.close()
    return trainer, {**results, **history}


def main(argv=None) -> dict:
    _, results = train(parse_args(argv))
    print({k: results[k] for k in ("test_accuracy", "best_val_accuracy")})
    return results


if __name__ == "__main__":
    main()
