"""The port's InceptionV3 (FID variant) against the JAX package's, on the
CPU.

The port's seeded network, with random batch-norm weights and statistics
so that every mapping shows, goes into the JAX package through its own
``convert_inception_state_dict`` (a torchvision-layout state dict); the
trunk and ``pool3_features_fn`` agree to 1e-4 x max|ref| at 1-2 images of
75-96 pixels. The JAX tree comes back through
``inception_state_dict_from_jax`` unchanged, and a torchvision-layout file
(classifier keys, no ``num_batches_tracked``) loads through
``STYLEX_TPU_INCEPTION``.
"""

import numpy as np
import pytest
import torch

import jax

from stylex_tpu.models import inception as jinc
from stylex_tpu_torch.models import inception
from stylex_tpu_torch.models.convert import inception_state_dict_from_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    """(the port's network, its state dict, the JAX variables)."""
    net = inception.build_inception(seed=4, device="cpu")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    variables = jinc.convert_inception_state_dict(sd)
    return net, sd, variables


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("n,size", [(1, 75), (2, 96)])
def test_trunk_matches_jax(weights, n, size):
    net, _, variables = weights
    x = np.random.RandomState(size).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jinc.InceptionV3FID().apply)(variables, x))
    with torch.no_grad():
        got = net(_nchw(x)).numpy()
    assert got.shape == want.shape == (n, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("h,resize_to", [(64, 80), (100, 90)])
def test_pool3_features_match_jax(weights, h, resize_to):
    """Images in [0, 1], resized (up, or down with antialiasing) and
    scaled to [-1, 1] as the JAX feature function does."""
    net, _, variables = weights
    x = np.random.RandomState(h).rand(2, h, h, 3).astype(np.float32)
    want = np.asarray(jinc.pool3_features_fn(variables, resize_to=resize_to)(x))
    got = inception.pool3_features_fn(net, resize_to=resize_to)(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_jax_tree_round_trips(weights):
    net, sd, variables = weights
    back = inception_state_dict_from_jax(jax.tree.map(np.asarray, variables))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_torchvision_state_dict_loads_through_the_env(weights, tmp_path, monkeypatch):
    net, sd, _ = weights
    tv = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    tv["fc.weight"] = torch.zeros(1000, 2048)
    tv["fc.bias"] = torch.zeros(1000)
    tv["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    path = tmp_path / "pt_inception.pt"
    torch.save(tv, path)
    loaded = inception.load_inception_variables(str(path))
    assert set(loaded) == set(sd)
    monkeypatch.setenv(inception.ENV, str(path))
    fn = inception.default_pool3_features(device="cpu")
    x = torch.rand(1, 3, 40, 40, generator=torch.Generator().manual_seed(0))
    assert torch.equal(fn(x), inception.pool3_features_fn(net)(x))
    monkeypatch.delenv(inception.ENV)
    assert inception.default_pool3_features(device="cpu") is None


def test_pools_exclude_padding_and_mixed_7c_takes_max():
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    corner = inception._avg_pool_3x3_exc(x)[0, 0, 0, 0]
    assert corner == x[0, 0, :2, :2].mean()  # 4 taps, not 9
    net = inception.InceptionV3FID()
    assert net.Mixed_7c.use_max_pool and not net.Mixed_7b.use_max_pool
    assert all(m.eps == 1e-3 for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d))
