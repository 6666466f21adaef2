"""The port's ``ingest`` against the JAX package's, on the CPU.

The same torch state dicts (the port's seeded MobileNetV2, ResNet-18 and
InceptionV3, and random weights in ``lpips.LPIPS(net='alex')``'s layout)
go through ``stylex_tpu.ingest`` and ``stylex_tpu_torch.ingest``: the two
``.msgpack`` trees are equal leaf for leaf, value and dtype. Then the
port's ``.msgpack`` readers (``build_classifier``, ``load_lpips_params``,
``STYLEX_TPU_INCEPTION``) give the same logits, LPIPS distances and pool3
features as the ``.pt`` route, bit for bit, from either package's file.
"""

import numpy as np
import pytest
import torch

import jax
from flax import serialization

from stylex_tpu import ingest as j_ingest
from stylex_tpu_torch import ingest
from stylex_tpu_torch.models import build_classifier
from stylex_tpu_torch.models import lpips as tlpips
from stylex_tpu_torch.models.inception import ENV, build_inception, default_pool3_features

from test_torch_lpips import _lpips_package_state_dict

torch.set_num_threads(2)


def _assert_files_equal(mine, theirs):
    a = serialization.msgpack_restore(open(mine, "rb").read())
    b = serialization.msgpack_restore(open(theirs, "rb").read())
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


@pytest.mark.parametrize("kind", ["mobilenet", "resnet"])
def test_classifier_ingest_matches_jax_and_reads_like_pt(kind, tmp_path):
    net = build_classifier(kind, 32, device="cpu", seed=3).net
    # running statistics away from their init, so that they count
    g = torch.Generator().manual_seed(0)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    src = tmp_path / "clf.pt"
    torch.save(net.state_dict(), src)
    mine, theirs = tmp_path / "mine.msgpack", tmp_path / "theirs.msgpack"
    ingest.main(["classifier", "--src", str(src), "--kind", kind, "--out", str(mine)])
    j_ingest.ingest_classifier(str(src), kind, str(theirs))
    _assert_files_equal(mine, theirs)

    x = torch.rand(2, 3, 32, 32, generator=g)
    want = build_classifier(kind, 32, checkpoint_path=str(src), device="cpu").classify_images(x)
    for path in (mine, theirs):
        got = build_classifier(kind, 32, checkpoint_path=str(path), device="cpu").classify_images(x)
        assert torch.equal(got, want)
    with pytest.raises(FileNotFoundError):
        build_classifier(kind, 32, checkpoint_path=str(tmp_path / "missing.msgpack"), device="cpu")
    other = "resnet" if kind == "mobilenet" else "mobilenet"
    with pytest.raises(ValueError, match="not a"):
        build_classifier(other, 32, checkpoint_path=str(mine), device="cpu")


def test_lpips_ingest_matches_jax_and_reads_like_pt(tmp_path):
    sd = _lpips_package_state_dict(seed=2)
    src = tmp_path / "alex.pt"
    torch.save(sd, src)
    mine, theirs = tmp_path / "mine.msgpack", tmp_path / "theirs.msgpack"
    ingest.main(["lpips", "--src", str(src), "--out", str(mine)])
    j_ingest.ingest_lpips(str(src), str(theirs))
    _assert_files_equal(mine, theirs)

    rng = np.random.RandomState(0)
    x, y = (torch.from_numpy(rng.rand(2, 3, 32, 32).astype(np.float32)) for _ in range(2))
    want = tlpips.lpips_distance(tlpips.load_lpips_params(str(src), device="cpu"), x, y)
    for path in (mine, theirs):
        got = tlpips.lpips_distance(tlpips.load_lpips_params(str(path), device="cpu"), x, y)
        assert torch.equal(got, want)
    bad = tmp_path / "bad.msgpack"
    ingest.save_msgpack_tree({"lin0": np.ones(3, np.float32)}, str(bad))
    with pytest.raises(ValueError, match="not an ingested LPIPS tree"):
        tlpips.load_lpips_params(str(bad))
    with pytest.raises(FileNotFoundError):
        tlpips.load_lpips_params(str(tmp_path / "missing.msgpack"))


def test_inception_ingest_matches_jax_and_reads_like_pt(tmp_path, monkeypatch):
    net = build_inception(seed=4, device="cpu")
    g = torch.Generator().manual_seed(1)
    sd = net.state_dict()
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = torch.randn(sd[k].shape, generator=g) * 0.1
        elif k.endswith("running_var"):
            sd[k] = torch.rand(sd[k].shape, generator=g) + 0.5
    sd["fc.weight"] = torch.zeros(10, 2048)  # a classifier head, dropped by both
    src = tmp_path / "inception.pt"
    torch.save(sd, src)
    mine, theirs = tmp_path / "mine.msgpack", tmp_path / "theirs.msgpack"
    ingest.main(["inception", "--src", str(src), "--out", str(mine)])
    j_ingest.ingest_inception(str(src), str(theirs))
    _assert_files_equal(mine, theirs)

    x = torch.rand(2, 3, 64, 64, generator=g)
    monkeypatch.setenv(ENV, str(src))
    want = default_pool3_features("cpu")(x)
    for path in (mine, theirs):
        monkeypatch.setenv(ENV, str(path))
        assert torch.equal(default_pool3_features("cpu")(x), want)
    bad = tmp_path / "bad.msgpack"
    ingest.save_msgpack_tree({"params": {}}, str(bad))
    monkeypatch.setenv(ENV, str(bad))
    with pytest.raises(ValueError, match="not an ingested Inception tree"):
        default_pool3_features("cpu")


def test_msgpack_tree_helpers_match_jax(tmp_path):
    tree = {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "b": np.asarray(1, np.int32)}
    path = tmp_path / "t.msgpack"
    size = ingest.save_msgpack_tree(tree, str(path))
    assert size == path.stat().st_size
    assert path.read_bytes() == serialization.msgpack_serialize(tree)
    got = ingest.load_msgpack_tree(str(path))
    want = j_ingest.load_msgpack_tree(str(path))
    assert np.array_equal(got["a"]["kernel"], want["a"]["kernel"]) and got["b"] == want["b"]
    with pytest.raises(FileNotFoundError):
        ingest.load_msgpack_tree(str(tmp_path / "missing.msgpack"))
