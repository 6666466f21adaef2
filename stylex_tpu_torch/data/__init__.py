from stylex_tpu_torch.data.dataset import FolderDataset
from stylex_tpu_torch.data.loader import (
    SampleLoader,
    StepBatchLoader,
    as_float01,
    balanced_class_weights,
)
from stylex_tpu_torch.data.mnist import SyntheticImageDataset

__all__ = [
    "FolderDataset",
    "SampleLoader",
    "StepBatchLoader",
    "as_float01",
    "balanced_class_weights",
    "SyntheticImageDataset",
]
