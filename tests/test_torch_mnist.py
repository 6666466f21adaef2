"""The port's MNIST one-vs-all reader against the JAX package's, on IDX
files the test writes from a seed, plain and gzipped: items and labels are
equal exactly. The trainer takes it as ``dataset_name='MNIST'`` with
class-rebalanced sampling."""

import gzip
import struct

import numpy as np
import pytest
import torch

from stylex_tpu.data.mnist import MNIST1vA as JMNIST1vA
from stylex_tpu_torch.config import ModelConfig, TrainConfig
from stylex_tpu_torch.data import MNIST1vA, load_idx_images, load_idx_labels

torch.set_num_threads(2)


def write_idx(folder, prefix: str, n: int, seed: int, gz: bool):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    labels[:3] = 8
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with opener(folder / f"{prefix}-images-idx3-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with opener(folder / f"{prefix}-labels-idx1-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return images, labels


@pytest.mark.parametrize("gz,train", [(False, True), (True, True), (True, False)])
def test_items_and_labels_equal_jax(tmp_path, gz, train):
    prefix = "train" if train else "t10k"
    images, labels = write_idx(tmp_path, prefix, 20, seed=int(gz) + 2 * int(train), gz=gz)
    ours = MNIST1vA(str(tmp_path), train=train)
    theirs = JMNIST1vA(str(tmp_path), train=train)
    assert len(ours) == len(theirs) == 20
    np.testing.assert_array_equal(ours.images, images)
    np.testing.assert_array_equal(ours.targets, (labels == 8).astype(np.int64))
    np.testing.assert_array_equal(ours.targets, theirs.targets)
    for i in range(20):
        item = ours[i]
        assert item.shape == (32, 32, 3) and item.dtype == np.float32
        np.testing.assert_array_equal(item, theirs[i])
        assert ours.label(i) == theirs.label(i)


def test_idx_readers_check_their_input(tmp_path):
    write_idx(tmp_path, "train", 4, seed=0, gz=False)
    assert load_idx_images(tmp_path / "train-images-idx3-ubyte").shape == (4, 28, 28)
    assert load_idx_labels(tmp_path / "train-labels-idx1-ubyte").shape == (4,)
    (tmp_path / "bad-idx3-ubyte").write_bytes(struct.pack(">IIII", 2049, 1, 28, 28))
    with pytest.raises(ValueError, match="magic"):
        load_idx_images(tmp_path / "bad-idx3-ubyte")
    with pytest.raises(ValueError, match="magic"):
        load_idx_labels(tmp_path / "train-images-idx3-ubyte")
    with pytest.raises(FileNotFoundError):
        MNIST1vA(str(tmp_path / "nowhere"))


def test_trainer_trains_on_mnist_with_balanced_sampling(tmp_path):
    from stylex_tpu_torch.train.trainer import Trainer

    write_idx(tmp_path, "train", 40, seed=1, gz=True)
    cfg = ModelConfig(image_size=32, network_capacity=4, latent_dim=34, encoder_dim=32)
    tc = TrainConfig(batch_size=2, gradient_accumulate_every=1, save_every=1000,
                     evaluate_every=1000, num_image_tiles=2, aug_prob=0.0)
    trainer = Trainer(base_dir=str(tmp_path), model_cfg=cfg, train_cfg=tc,
                      classifier_name="mobilenet", device="cpu")
    try:
        trainer.set_data_src(str(tmp_path), dataset_name="MNIST")
        weights = trainer.loader.sample_loader.weights
        targets = trainer.dataset.targets
        # inverse class frequency: each class carries half the sampling mass
        assert abs(weights[targets == 1].sum() - 0.5) < 1e-9
        metrics = trainer.train()
        assert np.isfinite(metrics["g_loss"]) and np.isfinite(metrics["d_loss"])
    finally:
        trainer.close()
