"""The port's FID numerics and feature side against the JAX package's, on
the CPU.

``FeatureStats`` and ``frechet_distance`` agree at rtol 1e-10 (the same
float64 host arithmetic), the rank-deficient jitter path included; the
resize agrees with ``jax.image.resize`` upsampling 64 -> 299 and, with its
default antialiasing, shrinking 320 -> 299; the AlexNet fallback, with
the JAX package's LPIPS tree carried across, agrees to 1e-5 x max|ref|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylex_tpu.eval import fid as jfid
from stylex_tpu.models.lpips import init_lpips_params as j_init_lpips
from stylex_tpu_torch.eval import fid
from stylex_tpu_torch.models.convert import lpips_params_from_jax
from stylex_tpu_torch.models.inception import ENV, build_inception

torch.set_num_threads(2)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("n,dim", [(300, 16), (7, 32)])
def test_feature_stats_match_jax(n, dim):
    rng = np.random.RandomState(n)
    feats = (rng.randn(n, dim) * 3.0 + 10.0).astype(np.float32)
    ours, theirs = fid.FeatureStats(dim), jfid.FeatureStats(dim)
    for chunk in np.array_split(feats, 3):
        ours.update(torch.from_numpy(chunk))
        theirs.update(jnp.asarray(chunk))
    for a, b in zip(ours.finalize(), theirs.finalize()):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=0)
    assert ours.n == n


@pytest.mark.parametrize("n1,n2,dim", [(400, 300, 8), (5, 9, 24), (3, 3, 64)])
def test_frechet_distance_matches_jax(n1, n2, dim):
    """Full-rank covariances, and (n <= dim) the preemptive jitter path."""
    rng = np.random.RandomState(dim)
    stats = []
    for n, shift in ((n1, 0.0), (n2, 0.7)):
        s = jfid.FeatureStats(dim)
        s.update(rng.randn(n, dim) + shift)
        stats.append(s.finalize())
    (mu1, c1), (mu2, c2) = stats
    got = fid.frechet_distance(mu1, c1, mu2, c2)
    want = jfid.frechet_distance(mu1, c1, mu2, c2)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert abs(fid.frechet_distance(mu1, c1, mu1, c1)) < 1e-3 * max(abs(got), 1.0)


@pytest.mark.parametrize("h,size", [(64, 299), (320, 299), (28, 32), (32, 64)])
def test_resize_matches_jax_image_resize(h, size):
    x = np.random.RandomState(h).rand(2, h, h, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, size, size, 3), "bilinear"))
    got = fid.resize_bilinear(_nchw(x), size).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("h", [32, 80])
def test_alexnet_features_match_jax(h):
    """Below 64 pixels the images are first resized to 64; above, not."""
    jax_fn = jfid.alexnet_features_fn(seed=3)
    tree = jax.tree.map(np.asarray, j_init_lpips(jax.random.PRNGKey(3)))
    ours = fid.alexnet_features_fn(params=lpips_params_from_jax(tree), device="cpu")
    x = np.random.RandomState(h).rand(3, h, h, 3).astype(np.float32)
    want = np.asarray(jax_fn(jnp.asarray(x)))
    got = ours(_nchw(x)).numpy()
    assert got.shape == want.shape == (3, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_resolve_feature_fn_tags(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    default = fid.resolve_feature_fn(device="cpu")
    # the port's seeded AlexNet is not the JAX package's: its cached
    # statistics must never be read as the other's
    assert default.tag == fid.ALEXNET_TAG != "alexnet_seeded"
    assert default(torch.rand(2, 3, 16, 16)).shape == (2, 256)

    def feats(x):
        return x.mean(dim=(2, 3))

    def other(x):
        return x.mean(dim=(2, 3))

    other.__qualname__ = feats.__qualname__
    assert fid.resolve_feature_fn(feats).tag.startswith(feats.__qualname__ + "-")
    assert fid.resolve_feature_fn(other).tag != feats.tag  # same name, other instance
    other.tag = "mine"
    assert fid.resolve_feature_fn(other).tag == "mine"

    class Extractor:
        def features(self, x):
            return x.mean(dim=(2, 3))

    wrapped = fid.resolve_feature_fn(Extractor().features)  # a bound method takes no tag
    assert "Extractor.features" in wrapped.tag
    assert wrapped(torch.ones(1, 3, 2, 2)).tolist() == [[1.0, 1.0, 1.0]]


def test_inception_env_selects_inception_and_fails_loudly(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV, str(tmp_path / "missing.pt"))
    with pytest.raises(FileNotFoundError):
        fid.resolve_feature_fn(device="cpu")
    bad = tmp_path / "bad.pt"
    torch.save({"Conv2d_1a_3x3.conv.weight": torch.zeros(1)}, bad)
    monkeypatch.setenv(ENV, str(bad))
    with pytest.raises(RuntimeError):
        fid.resolve_feature_fn(device="cpu")
    packed = tmp_path / "inception.msgpack"
    packed.write_bytes(b"\x80")
    monkeypatch.setenv(ENV, str(packed))
    with pytest.raises(ValueError, match="msgpack"):
        fid.resolve_feature_fn(device="cpu")
    good = tmp_path / "inception.pt"
    torch.save(build_inception(seed=1, device="cpu").state_dict(), good)
    monkeypatch.setenv(ENV, str(good))
    fn = fid.resolve_feature_fn(device="cpu")
    assert fn.tag == fid.INCEPTION_TAG
    assert fn(torch.rand(1, 3, 32, 32)).shape == (1, 2048)


def _shared_features(x: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) -> (B, 5): channel means, the mean square and a corner,
    summed in float64, so that both layouts give the same float32 features."""
    x = np.asarray(x, np.float64)
    return np.concatenate([x.mean(axis=(1, 2)), (x ** 2).mean(axis=(1, 2, 3))[:, None],
                           x[:, 0, 0, :1]], axis=1)


def test_fid_from_image_batches_matches_jax():
    rng = np.random.RandomState(0)
    real = [rng.rand(8, 16, 16, 3).astype(np.float32) for _ in range(3)]
    fake = [rng.rand(8, 16, 16, 3).astype(np.float32) ** 1.5 for _ in range(2)]
    ours = fid.fid_from_image_batches(
        real, fake, lambda x: torch.from_numpy(_shared_features(x.numpy().transpose(0, 2, 3, 1))))
    theirs = jfid.fid_from_image_batches(
        real, fake, lambda x: jnp.asarray(_shared_features(np.asarray(x))))
    np.testing.assert_allclose(ours, theirs, rtol=1e-10)
    with pytest.raises(ValueError, match="empty"):
        fid.compute_feature_stats([], lambda x: x)
