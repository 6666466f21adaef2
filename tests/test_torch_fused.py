"""The port's fused resample graph against the JAX package's, on the CPU.

The policy (``ops/fusion.py``: the variable's three states, the contextvar
default) answers as the JAX package's does; the fused ops
(``upsample2x_blur``, ``upsample2x_conv3x3_same``,
``modulated_upsample_conv2d``, ``blur_conv3x3_down2``) equal their JAX
counterparts and their own literal compositions; the G and D/E forwards on
the default (fused) graph equal the JAX package's default forwards. The
same numpy inputs (NHWC on the JAX side) go through both, float32; values
agree to 1e-5 x max|ref|. The JAX policy is read when a function is
traced, so each JAX call is made inside the environment its test sets.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylex_tpu.config import Arch as JArch, ModelConfig as JModelConfig
from stylex_tpu.models import build_stylex as j_build_stylex, init_stylex_params
from stylex_tpu.ops import blur as jblur
from stylex_tpu.ops import downconv as jdown
from stylex_tpu.ops import fusion as jfusion
from stylex_tpu.ops import modconv as jmod
from stylex_tpu.ops import upconv as jup
from stylex_tpu.ops.latents import expand_styles as j_expand
from stylex_tpu_torch.config import Arch, ModelConfig
from stylex_tpu_torch.models.convert import stylex_state_dict_from_jax
from stylex_tpu_torch.models.stylex import StylEx
from stylex_tpu_torch.ops import blur as tblur
from stylex_tpu_torch.ops import downconv as tdown
from stylex_tpu_torch.ops import fusion as tfusion
from stylex_tpu_torch.ops import modconv as tmod
from stylex_tpu_torch.ops import upconv as tup

torch.set_num_threads(2)

REL = 1e-5
ENV = "STYLEX_TPU_NO_FUSED_UPCONV"
TINY = dict(image_size=16, network_capacity=4, latent_dim=34, encoder_dim=32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL * float(np.abs(want).max()))


@pytest.fixture
def fused(monkeypatch):
    """The workload default: the variable unset."""
    monkeypatch.delenv(ENV, raising=False)


@pytest.mark.parametrize("env", [None, "0", "1", "yes"])
def test_policy_matches_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, env)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the JAX package warns once about "0"
        assert tfusion.resample_fusion_enabled() == jfusion.resample_fusion_enabled()
        with tfusion.prefer_literal_resample(), jfusion.prefer_literal_resample():
            assert tfusion.resample_fusion_enabled() == jfusion.resample_fusion_enabled()
        assert tfusion.resample_fusion_enabled() == jfusion.resample_fusion_enabled()
    want = {None: (True, False), "0": (True, True), "1": (False, False), "yes": (False, False)}
    with tfusion.prefer_literal_resample():
        inside = tfusion.resample_fusion_enabled()
    assert (tfusion.resample_fusion_enabled(), inside) == want[env]


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 5, 5, 3), (3, 4, 6, 2), (1, 2, 2, 3), (2, 1, 4, 3)])
def test_upsample2x_blur_matches_jax(fused, shape):
    """Fused above 2x2, the literal composition below (the JAX package's own
    rule), and fused = literal."""
    x = _x(shape)
    want = jblur.upsample2x_blur(jnp.asarray(x))
    got = tblur.upsample2x_blur(_nchw(x))
    _close(_nhwc(got), want)
    _close(_nhwc(tblur.upsample2x_blur_unfused(_nchw(x))),
           jblur.upsample2x_blur_unfused(jnp.asarray(x)))
    _close(_nhwc(got), jblur.upsample2x_blur_unfused(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(2, 3, 3, 4), (2, 4, 6, 3), (1, 8, 8, 5), (2, 2, 5, 3)])
def test_upsample2x_conv3x3_same_matches_jax(shape):
    x = _x(shape, 1)
    w = _x((3, 3, shape[-1], 6), 2)  # HWIO
    want = jup.upsample2x_conv3x3_same(jnp.asarray(x), jnp.asarray(w))
    w_t = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = tup.upsample2x_conv3x3_same(_nchw(x), w_t)
    _close(_nhwc(got), want)
    literal = torch.nn.functional.conv2d(tblur.upsample2x_bilinear(_nchw(x)), w_t, padding=1)
    _close(_nhwc(got), _nhwc(literal))


@pytest.mark.parametrize("demod", [True, False])
def test_modulated_upsample_conv2d_matches_jax(demod):
    x, w, s = _x((2, 4, 4, 5), 3), _x((3, 3, 5, 6), 4), _x((2, 5), 5)
    want = jmod.modulated_upsample_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                          demod=demod)
    w_t = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = tmod.modulated_upsample_conv2d(_nchw(x), w_t, torch.from_numpy(s), demod=demod)
    _close(_nhwc(got), want)
    literal = tmod.modulated_conv2d(tblur.upsample2x_bilinear(_nchw(x)), w_t,
                                    torch.from_numpy(s), demod=demod)
    _close(_nhwc(got), _nhwc(literal))


@pytest.mark.parametrize("shape", [(2, 4, 4, 3), (2, 8, 6, 4), (1, 16, 16, 2)])
def test_blur_conv3x3_down2_matches_jax(shape):
    x, w = _x(shape, 6), _x((3, 3, shape[-1], 5), 7)
    want = jdown.blur_conv3x3_down2(jnp.asarray(x), jnp.asarray(w))
    w_t = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = tdown.blur_conv3x3_down2(_nchw(x), w_t)
    _close(_nhwc(got), want)
    literal = torch.nn.functional.conv2d(tblur.blur3(_nchw(x)), w_t, stride=2, padding=1)
    _close(_nhwc(got), _nhwc(literal))


def test_fused_ops_differentiate_as_literal():
    """Gradients of the fused ops (input and weight) equal the literal
    compositions' in float64."""
    rng = np.random.RandomState(8)
    x = torch.tensor(rng.randn(2, 3, 6, 6), requires_grad=True)
    w = torch.tensor(rng.randn(4, 3, 3, 3), requires_grad=True)
    pairs = [
        (lambda: tup.upsample2x_conv3x3_same(x, w),
         lambda: torch.nn.functional.conv2d(tblur.upsample2x_bilinear(x), w, padding=1)),
        (lambda: tdown.blur_conv3x3_down2(x, w),
         lambda: torch.nn.functional.conv2d(tblur.blur3(x), w, stride=2, padding=1)),
        (lambda: tblur._upsample2x_blur_axis(tblur._upsample2x_blur_axis(x, 2), 3) * w.sum(),
         lambda: tblur.upsample2x_blur_unfused(x) * w.sum()),
    ]
    for fused_fn, literal_fn in pairs:
        got, want = fused_fn(), literal_fn()
        g = torch.cos(torch.arange(got.numel(), dtype=got.dtype)).reshape(got.shape)
        ga = torch.autograd.grad((got * g).sum(), (x, w))
        gb = torch.autograd.grad((want * g).sum(), (x, w))
        for a, b in zip(ga, gb):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10)


def _pair(model_kwargs, arch="old"):
    jcfg = JModelConfig(arch=JArch(arch), **model_kwargs)
    modules = j_build_stylex(jcfg)
    params = init_stylex_params(jax.random.PRNGKey(0), modules)
    cfg = ModelConfig(arch=Arch(arch), **model_kwargs)
    model = StylEx(cfg)
    model.load_state_dict(stylex_state_dict_from_jax(jax.tree.map(np.asarray, params), cfg))
    return modules, params, model.eval()


def test_generator_default_graph_matches_jax(fused):
    modules, params, model = _pair(TINY)
    rng = np.random.RandomState(9)
    L = modules.num_layers
    w = rng.randn(3, TINY["latent_dim"]).astype(np.float32)
    noise = rng.rand(1, 16, 16, 1).astype(np.float32)
    delta = (rng.randn(3, model.total_style_coords) * 0.5).astype(np.float32)
    rgb_j, coords_j = modules.generate(params, j_expand(jnp.asarray(w), L), jnp.asarray(noise),
                                       style_delta=jnp.asarray(delta))
    with torch.no_grad():
        rgb, coords = model.generate(torch.from_numpy(w)[:, None].expand(-1, L, -1),
                                     torch.from_numpy(noise), style_delta=torch.from_numpy(delta))
    _close(_nhwc(rgb), rgb_j)
    _close(coords, coords_j)


@pytest.mark.parametrize("arch", ["old", "new"])
def test_discriminator_and_encoder_default_graph_match_jax(fused, arch):
    """Capacity 16 at 16px: blocks of 64 and 128 channels take the fused
    downsample, the 256-channel one the literal pair, as at the 64px
    config."""
    modules, params, model = _pair(dict(TINY, network_capacity=16), arch)
    x = np.random.RandomState(10).rand(3, 16, 16, 3).astype(np.float32)
    probs = np.random.RandomState(11).dirichlet([1.0, 1.0], size=3).astype(np.float32)
    p = jnp.asarray(probs) if arch == "new" else None
    with torch.no_grad():
        d = model.discriminate(_nchw(x), torch.from_numpy(probs) if arch == "new" else None)
        e = model.encode(_nchw(x))
    _close(d, modules.discriminate(params, jnp.asarray(x), p))
    _close(e, modules.encode(params, jnp.asarray(x)))
