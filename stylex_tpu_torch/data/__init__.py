from stylex_tpu_torch.data.dataset import FolderDataset
from stylex_tpu_torch.data.loader import (
    SampleLoader,
    StepBatchLoader,
    as_float01,
    balanced_class_weights,
)
from stylex_tpu_torch.data.mnist import (
    MNIST1vA,
    SyntheticImageDataset,
    load_idx_images,
    load_idx_labels,
)

__all__ = [
    "FolderDataset",
    "SampleLoader",
    "StepBatchLoader",
    "as_float01",
    "balanced_class_weights",
    "MNIST1vA",
    "SyntheticImageDataset",
    "load_idx_images",
    "load_idx_labels",
]
