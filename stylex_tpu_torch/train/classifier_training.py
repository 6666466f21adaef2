"""Classifier pretraining: the first stage of the pipeline, which produces
the frozen classifier that StylEx training and AttFind explain.

The counterpart of ``stylex_tpu.train.classifier_training``, covering the
reference's two workflows:

* MobileNetV2 with its first feature stages frozen (or all of them), Adam
  and cross-entropy, best-validation checkpointing, a test accuracy JSON,
  and TensorBoard scalars ``Loss/train`` and ``Accuracy/{train,validation}``;
* ResNet-18 with progressive unfreezing: the fc layer alone, then with
  ``layer4``, then with ``layer3``, one epoch per stage.

Parameters are named by the JAX package's top-level modules (``stem``,
``block{i}``, ``head``, ``classifier``; ``stem``, ``layer{l}_{b}``,
``fc``), so freeze masks and stages read as they do there. Adam (0.9, 0.999,
eps 1e-8, as ``optax.adam``) runs over the trainable parameters only, and a
new trainable set starts it afresh. The whole net runs in train mode: batch
norm with batch statistics and running-statistics updates in frozen layers
too, as flax's ``train=True`` does, and MobileNetV2's head dropout drawing
from the trainer's ``torch.Generator``.

Runs on the GPU unless ``device='cpu'`` is given.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from stylex_tpu_torch.device import resolve_device
from stylex_tpu_torch.models.classifiers import (
    MobileNetV2,
    ResNet18,
    _torchvision_init_,
    imagenet_normalize,
    read_classifier_weights,
)
from stylex_tpu_torch.utils.logging import tensorboard_writer

__all__ = [
    "ClassifierTrainer",
    "mobilenet_freeze_mask",
    "resnet_progressive_stages",
    "module_name",
    "cross_entropy_loss",
    "accuracy",
]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()


def module_name(kind: str, key: str) -> str:
    """The JAX package's top-level module of the torchvision-layout
    parameter ``key``."""
    parts = key.split(".")
    if kind == "resnet":
        if parts[0] in ("conv1", "bn1"):
            return "stem"
        if parts[0].startswith("layer"):
            return f"{parts[0]}_{parts[1]}"
        return parts[0]  # fc
    if parts[0] == "classifier":
        return "classifier"
    feature = int(parts[1])
    return "stem" if feature == 0 else "head" if feature == 18 else f"block{feature - 1}"


def mobilenet_freeze_mask(amount_frozen_layers: int = 15,
                          freeze_all: bool = False) -> Dict[str, bool]:
    """Trainable (True) per MobileNetV2 module: ``features[0..N-1]`` frozen
    (torchvision's features 0 is the stem, 1-17 the blocks, 18 the head);
    with ``freeze_all`` only the classifier head trains. The JAX package's
    ``mobilenet_freeze_mask``, by module name."""

    def trainable(name: str) -> bool:
        if freeze_all:
            return name == "classifier"
        if name == "stem":
            return amount_frozen_layers < 1
        if name.startswith("block"):
            return int(name[5:]) + 1 >= amount_frozen_layers
        if name == "head":
            return 0 <= amount_frozen_layers <= 18
        return True  # classifier

    names = ["stem"] + [f"block{i}" for i in range(17)] + ["head", "classifier"]
    return {name: trainable(name) for name in names}


def resnet_progressive_stages() -> List[Callable[[str], bool]]:
    """The CelebA notebook's unfreeze schedule: stage 0 trains fc alone;
    stage 1 adds layer4; stage 2 adds layer3."""
    return [
        lambda name: name == "fc",
        lambda name: name == "fc" or name.startswith("layer4"),
        lambda name: name == "fc" or name.startswith("layer4") or name.startswith("layer3"),
    ]


class ClassifierTrainer:
    """Train and evaluate a classifier with freeze schedules. Loaders yield
    ``(images, labels)`` numpy batches: NHWC images, uint8 (normalised in
    float32) or floats in [0, 1], and integer labels."""

    def __init__(self, kind: str = "mobilenet", num_classes: int = 2, lr: float = 1e-4,
                 seed: int = 42, tensorboard_dir: Optional[str] = None, device=None):
        if kind not in ("mobilenet", "resnet"):
            raise ValueError(f"unknown classifier kind {kind!r}")
        self.kind = kind
        self.device = resolve_device(device)
        self.net = (MobileNetV2 if kind == "mobilenet" else ResNet18)(num_classes).to(self.device)
        self.lr = lr
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.opt: Optional[torch.optim.Adam] = None
        self.trainable: Dict[str, bool] = {}
        self._writer = tensorboard_writer(tensorboard_dir) if tensorboard_dir else None

    # ------------------------------------------------------------------ setup
    def init(self, image_size: int, state_dict: Optional[Dict[str, Any]] = None,
             seed: int = 0) -> None:
        """Weights: ``state_dict`` (torchvision layout), else torchvision's
        init drawn from ``seed``. ``image_size`` is the JAX package's
        argument (flax infers shapes from a dummy batch); here it is
        unused."""
        if state_dict is not None:
            self.net.load_state_dict(state_dict)
        else:  # drawn on the host, so the draws do not depend on the device
            _torchvision_init_(self.net.cpu(), torch.Generator().manual_seed(seed))
            self.net.to(self.device)

    def set_trainable(self, mask_fn: Optional[Callable[[str], bool]] = None,
                      mask: Optional[Dict[str, bool]] = None) -> None:
        """Train the modules that ``mask`` (module name -> bool) or
        ``mask_fn`` (module name -> bool) select; all without either. Starts
        a new Adam over those parameters, as the notebook builds a new
        optimizer per stage."""
        names = {module_name(self.kind, k) for k, _ in self.net.named_parameters()}
        if mask is None:
            mask = {name: True if mask_fn is None else bool(mask_fn(name)) for name in names}
        self.trainable = dict(mask)
        params = []
        for key, p in self.net.named_parameters():
            train = self.trainable[module_name(self.kind, key)]
            p.requires_grad_(train)
            if train:
                params.append(p)
        self.opt = torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)

    def _inputs(self, images, labels):
        x = torch.as_tensor(np.asarray(images)).to(self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        y = torch.as_tensor(np.asarray(labels)).to(self.device, torch.int64)
        # normalised in the images' dtype, then run in the net's, as flax
        # promotes them
        dtype = next(self.net.parameters()).dtype
        return imagenet_normalize(x.permute(0, 3, 1, 2)).to(dtype), y

    def train_step(self, images, labels):
        """One Adam step on a batch; returns (loss, accuracy) tensors."""
        x, y = self._inputs(images, labels)
        self.net.train()
        logits = self.net(x, self.generator)
        loss = cross_entropy_loss(logits, y)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach(), accuracy(logits.detach(), y)

    @torch.no_grad()
    def logits(self, images) -> torch.Tensor:
        """Eval-mode logits of an NHWC batch."""
        self.net.eval()
        return self.net(self._inputs(images, np.zeros(len(images), np.int64))[0])

    # ------------------------------------------------------------------ loops
    def train_epoch(self, loader: Iterable, epoch: int = 0, log_every: int = 20) -> float:
        losses = []
        for i, (images, labels) in enumerate(loader):
            loss, _ = self.train_step(images, labels)
            losses.append(float(loss))
            if self._writer is not None:
                self._writer.add_scalar("Loss/train", losses[-1], epoch * 10_000 + i)
            if i % log_every == 0:
                print(f"\repoch {epoch}: batch {i}, running loss {np.mean(losses):.4f}",
                      end="", flush=True)
        print()
        return float(np.mean(losses)) if losses else float("nan")

    def evaluate(self, loader: Iterable) -> float:
        """Accuracy over a loader."""
        correct = total = 0
        for images, labels in loader:
            pred = self.logits(images).argmax(dim=-1).cpu().numpy()
            correct += int((pred == np.asarray(labels)).sum())
            total += len(labels)
        return correct / max(total, 1)

    def fit(self, train_loader_fn, valid_loader_fn, epochs: int, checkpoint_path: str,
            stages: Optional[Sequence[Callable[[str], bool]]] = None) -> Dict[str, Any]:
        """Best-validation training; with ``stages``, one unfreeze stage per
        epoch. ``train_loader_fn`` may take the epoch (to reshuffle per
        epoch). The best epoch's weights are saved to ``checkpoint_path``
        and reloaded at the end."""
        best_val = -1.0  # so the first epoch always writes the file load() reads
        history: Dict[str, Any] = {}
        for epoch in range(epochs):
            if stages is not None:
                self.set_trainable(stages[min(epoch, len(stages) - 1)])
            elif self.opt is None:
                self.set_trainable()
            t0 = time.time()

            def train_loader():
                try:
                    return train_loader_fn(epoch)
                except TypeError:
                    return train_loader_fn()

            train_loss = self.train_epoch(train_loader(), epoch)
            train_acc = self.evaluate(train_loader())
            val_acc = self.evaluate(valid_loader_fn())
            print(f"epoch {epoch}: loss {train_loss:.4f}, train acc {train_acc:.4f}, "
                  f"val acc {val_acc:.4f} ({(time.time() - t0) / 60:.2f} min)")
            if self._writer is not None:
                self._writer.add_scalar("Accuracy/train", train_acc, epoch)
                self._writer.add_scalar("Accuracy/validation", val_acc, epoch)
            if val_acc > best_val:
                best_val = val_acc
                self.save(checkpoint_path)
            history[f"epoch_{epoch}"] = {"loss": train_loss, "train_acc": train_acc,
                                         "val_acc": val_acc}
        if best_val >= 0.0:
            self.load(checkpoint_path)
        history["best_val_accuracy"] = max(best_val, 0.0)
        return history

    def test(self, test_loader_fn, results_path: Optional[str] = None) -> Dict[str, float]:
        """Test accuracy, also written as JSON to ``results_path``."""
        results = {"test_accuracy": self.evaluate(test_loader_fn())}
        if results_path:
            Path(results_path).parent.mkdir(parents=True, exist_ok=True)
            Path(results_path).write_text(json.dumps(results, indent=2))
        return results

    def confusion_matrix(self, loader: Iterable, num_classes: int = 2) -> np.ndarray:
        """Counts of (true label, predicted label)."""
        cm = np.zeros((num_classes, num_classes), np.int64)
        for images, labels in loader:
            preds = self.logits(images).argmax(dim=-1).cpu().numpy()
            np.add.at(cm, (np.asarray(labels, np.int64), preds), 1)
        return cm

    # ------------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """A ``.msgpack`` (or ``.mp``) path gets the JAX package's flax
        variables tree, which both packages' ``build_classifier`` read; any
        other a torchvision-layout state dict."""
        if str(path).endswith((".msgpack", ".mp")):
            from stylex_tpu_torch.ingest import save_msgpack_tree
            from stylex_tpu_torch.models.convert import classifier_tree_from_state_dict

            save_msgpack_tree(classifier_tree_from_state_dict(self.net.state_dict(), self.kind),
                              path)
        else:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            torch.save(self.net.state_dict(), path)

    def load(self, path: str) -> None:
        self.net.load_state_dict(read_classifier_weights(path, self.kind))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
