from stylex_tpu_torch.data.dataset import FolderDataset
from stylex_tpu_torch.data.mnist import SyntheticImageDataset

__all__ = ["FolderDataset", "SyntheticImageDataset"]
