"""Labeled datasets for classifier pretraining and evaluation: the
counterpart of ``stylex_tpu.data.labeled``, with the same splits from the
same seed.

* :class:`FFHQGender`: the Kaggle 256px FFHQ resize with the gender labels
  of ``ffhq_aging_labels.csv`` (male 0, female 1) and the reference's
  70/15/15 seeded split;
* :class:`CelebAAttribute`: ``img_align_celeba`` with a binary attribute of
  ``list_attr_celeba.csv`` (default "Male");
* :class:`ImageFolderDataset` and :func:`plant_village_splits`: the binary
  healthy/sick PlantVillage folder with a 70/20/10 split, seed 42;
  :func:`prepare_plant_village` reorganises an extracted archive into it.

Every dataset returns ``(image, label)``, the image (H, W, 3) float32 in
[0, 1]; ImageNet normalisation is the classifier's, so the same images
feed StylEx training and classification.
"""

from __future__ import annotations

import csv
import shutil
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from stylex_tpu_torch.data.dataset import load_and_transform

__all__ = [
    "FFHQGender",
    "CelebAAttribute",
    "ImageFolderDataset",
    "seeded_split",
    "plant_village_splits",
    "prepare_plant_village",
    "LabeledView",
]


def seeded_split(n: int, fractions: Sequence[float], seed: int) -> List[np.ndarray]:
    """Deterministic index split (the reference's seeded
    ``torch.utils.data.random_split``; first split absorbs rounding, as in
    `plant_village/util.py:104-110`)."""
    counts = [round(f * n) for f in fractions]
    counts[0] += n - sum(counts)
    perm = np.random.RandomState(seed).permutation(n)
    out = []
    start = 0
    for c in counts:
        out.append(np.sort(perm[start : start + c]))
        start += c
    return out


class LabeledView:
    """An index-subset view over a labeled dataset."""

    def __init__(self, base, indices: np.ndarray):
        self.base = base
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.base[int(self.indices[i])]

    def label(self, i: int) -> int:
        return self.base.label(int(self.indices[i]))

    @property
    def labels(self) -> np.ndarray:
        return np.asarray([self.base.label(int(i)) for i in self.indices])


class FFHQGender:
    """FFHQ 256px with gender labels (male=0, female=1)."""

    def __init__(self, root: str, image_size: int = 224, label: str = "gender"):
        resized = Path(root) / "flickrfaceshq-dataset-nvidia-resized-256px" / "resized"
        self.paths = sorted(p for p in resized.iterdir() if p.suffix == ".jpg")
        self.image_size = image_size
        self._labels: List[int] = []
        enc = {"male": 0, "female": 1}
        with open(Path(root) / "ffhq_aging_labels.csv") as f:
            reader = csv.DictReader(f)
            for row in reader:
                self._labels.append(enc[row[label]])

    def __len__(self):
        return len(self.paths)

    def label(self, i: int) -> int:
        return self._labels[i]

    def __getitem__(self, i: int):
        img = load_and_transform(self.paths[i], self.image_size)
        return img, self._labels[i]

    def splits(self, seed: int = 42):
        """70/15/15 train/valid/test (`ffhq_utils.py:11-25`)."""
        idx = seeded_split(len(self), [0.7, 0.15, 0.15], seed)
        return tuple(LabeledView(self, i) for i in idx)


class CelebAAttribute:
    """CelebA aligned images with a binary attribute label (default 'Male')."""

    def __init__(self, root: str, image_size: int = 64, attribute: str = "Male"):
        self.img_dir = Path(root) / "img_align_celeba"
        if (self.img_dir / "img_align_celeba").is_dir():
            self.img_dir = self.img_dir / "img_align_celeba"
        self.image_size = image_size
        self.files: List[str] = []
        self._labels: List[int] = []
        with open(Path(root) / "list_attr_celeba.csv") as f:
            reader = csv.DictReader(f)
            for row in reader:
                self.files.append(row[reader.fieldnames[0]])
                self._labels.append(1 if int(row[attribute]) == 1 else 0)

    def __len__(self):
        return len(self.files)

    def label(self, i: int) -> int:
        return self._labels[i]

    def __getitem__(self, i: int):
        img = load_and_transform(self.img_dir / self.files[i], self.image_size)
        return img, self._labels[i]

    def splits(self, seed: int = 42, fractions=(0.8, 0.1, 0.1)):
        idx = seeded_split(len(self), list(fractions), seed)
        return tuple(LabeledView(self, i) for i in idx)


class ImageFolderDataset:
    """torchvision-style ImageFolder: ``root/<class>/*.jpg`` with classes
    sorted alphabetically -> label ids."""

    def __init__(self, root: str, image_size: int):
        self.image_size = image_size
        root_p = Path(root)
        self.classes = sorted(d.name for d in root_p.iterdir() if d.is_dir())
        self.samples: List[Tuple[Path, int]] = []
        for ci, cname in enumerate(self.classes):
            for p in sorted((root_p / cname).iterdir()):
                if p.suffix.lower() in (".jpg", ".jpeg", ".png"):
                    self.samples.append((p, ci))

    def __len__(self):
        return len(self.samples)

    def label(self, i: int) -> int:
        return self.samples[i][1]

    def __getitem__(self, i: int):
        path, label = self.samples[i]
        return load_and_transform(path, self.image_size), label


def plant_village_splits(path: str = "./plant-village", image_size: int = 64, seed: int = 42):
    """70/20/10 split of the healthy/sick folder
    (`plant_village/util.py:76-118`)."""
    ds = ImageFolderDataset(path, image_size)
    idx = seeded_split(len(ds), [0.7, 0.2, 0.1], seed)
    return tuple(LabeledView(ds, i) for i in idx)


def prepare_plant_village(archive_dir: str, out_path: str = "./plant-village") -> str:
    """Reorganise an extracted PlantVillage archive into binary
    ``healthy/`` / ``sick/`` folders (`plant_village/util.py:13-74`).

    ``archive_dir`` holds the extracted
    ``Plant_leave_diseases_dataset_without_augmentation`` directory
    (:mod:`stylex_tpu_torch.data.download` fetches and extracts it)."""
    src = Path(archive_dir)
    inner = src / "Plant_leave_diseases_dataset_without_augmentation"
    if inner.is_dir():
        src = inner
    healthy = Path(out_path) / "healthy"
    sick = Path(out_path) / "sick"
    healthy.mkdir(parents=True, exist_ok=True)
    sick.mkdir(parents=True, exist_ok=True)
    idx = 0
    for class_dir in sorted(p for p in src.iterdir() if p.is_dir()):
        dst = healthy if "healthy" in class_dir.name.lower() else sick
        for img in sorted(class_dir.iterdir()):
            if img.suffix.lower() in (".jpg", ".jpeg", ".png"):
                shutil.copy2(img, dst / f"{idx}{img.suffix.lower()}")
                idx += 1
    return str(out_path)
