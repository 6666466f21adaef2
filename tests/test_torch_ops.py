"""The port's ops against the JAX package's, on the CPU.

The kernels' plain versions (what a CPU tensor runs) are held against the
JAX forms and the Pallas kernels in interpret mode, float32, atol 1e-6:
both sides compute the same taps in float32, so they agree to rounding.
Modulated conv and the latent helpers are held at rtol 1e-5 (one conv /
matmul summed in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stylex_tpu.ops import blur as jblur
from stylex_tpu.ops import latents as jlatents
from stylex_tpu.ops.modconv import modulated_conv2d as j_modconv
from stylex_tpu.ops.pallas_blur import blur3_downsample2x_pallas, blur3_pallas
from stylex_tpu.ops.pallas_upsample import (
    upsample2x_bilinear_pallas,
    upsample2x_bilinear_pallas_batched,
)
from stylex_tpu_torch.ops import blur as tblur
from stylex_tpu_torch.ops import latents as tlatents
from stylex_tpu_torch.ops.modconv import modulated_conv2d as t_modconv

torch.set_num_threads(2)

ATOL_KERNEL = 1e-6
RTOL = 1e-5

SHAPES = [(2, 4, 4, 8), (3, 8, 8, 16), (2, 8, 12, 5), (1, 16, 16, 3)]


def _nhwc(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port(fn, x_nhwc):
    """Run an NCHW port function on an NHWC numpy array, return NHWC."""
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
    return fn(x).numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("oracle", ["xla", "pallas_batched", "pallas_rows"])
def test_upsample_plain_matches_jax(shape, oracle):
    x = _nhwc(shape, 0)
    want = {
        "xla": lambda v: jblur.upsample2x_bilinear_xla(v),
        "pallas_batched": lambda v: upsample2x_bilinear_pallas_batched(v, interpret=True),
        "pallas_rows": lambda v: upsample2x_bilinear_pallas(v, interpret=True),
    }[oracle](jnp.asarray(x))
    got = _port(tblur.upsample2x_bilinear_plain, x)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL_KERNEL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("oracle", ["xla", "pallas"])
def test_blur_plain_matches_jax(shape, oracle):
    x = _nhwc(shape, 1)
    fn = jblur.blur3_xla if oracle == "xla" else (lambda v: blur3_pallas(v, interpret=True))
    got = _port(tblur.blur3_plain, x)
    np.testing.assert_allclose(got, np.asarray(fn(jnp.asarray(x))), rtol=0, atol=ATOL_KERNEL)


@pytest.mark.parametrize("name", ["upsample2x_bilinear", "blur3", "blur3_downsample2x"])
def test_wrapper_backward_matches_plain_autograd(name):
    """The wrappers' backward is the plain version's vjp (the ops are linear)."""
    wrapper, plain = getattr(tblur, name), getattr(tblur, f"{name}_plain")
    x = torch.from_numpy(_nhwc((2, 3, 6, 8), 2)).requires_grad_(True)
    g = torch.from_numpy(_nhwc(tuple(plain(x.detach()).shape), 3))
    (want,) = torch.autograd.grad(plain(x), x, g)
    (got,) = torch.autograd.grad(wrapper(x), x, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL_KERNEL)


@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (3, 8, 8, 16), (2, 8, 12, 5), (1, 2, 2, 3)])
@pytest.mark.parametrize("oracle", ["xla", "pallas"])
def test_blur_downsample_plain_matches_jax(shape, oracle):
    """Kernel #4's plain version against the Pallas kernel in interpret
    mode and against ``blur3_xla(x)[:, ::2, ::2]``."""
    x = _nhwc(shape, 6)
    if oracle == "xla":
        want = np.asarray(jblur.blur3_xla(jnp.asarray(x)))[:, ::2, ::2]
    else:
        want = np.asarray(blur3_downsample2x_pallas(jnp.asarray(x), interpret=True))
    got = _port(tblur.blur3_downsample2x_plain, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_KERNEL)


@pytest.mark.parametrize("shape", [(1, 2, 5, 4), (1, 2, 4, 7), (1, 2, 1, 4), (2, 4, 4)])
@pytest.mark.parametrize("fn", ["blur3_downsample2x", "blur3_downsample2x_plain"])
def test_blur_downsample_refuses_odd_or_small_shapes(shape, fn):
    with pytest.raises(ValueError, match="even H, W"):
        getattr(tblur, fn)(torch.zeros(shape))


def _second_derivative(op, x, a, c):
    """d/da of the squared input gradient of ``sum(c * tanh(op(a * x)))``:
    the gradient-penalty pattern, whose second derivative runs through the
    op's backward."""
    a = a.clone().requires_grad_(True)
    xx = x.clone().requires_grad_(True)
    s = (c * torch.tanh(op(a * xx))).sum()
    (gx,) = torch.autograd.grad(s, xx, create_graph=True)
    (ga,) = torch.autograd.grad(gx.square().sum(), a)
    return ga


@pytest.mark.parametrize("name", ["upsample2x_bilinear", "blur3", "blur3_downsample2x"])
def test_wrapper_second_derivative_matches_plain(name):
    """A penalty on the input gradient, differentiated once more, must see
    the path through the op's backward: the wrapper's result equals the
    plain version's (a non-differentiable backward drops that path)."""
    wrapper, plain = getattr(tblur, name), getattr(tblur, f"{name}_plain")
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 3, 6, 8).astype(np.float32))
    a = torch.from_numpy(rng.randn(1, 3, 1, 1).astype(np.float32))
    c = torch.from_numpy(rng.randn(*plain(x).shape).astype(np.float32))
    want = _second_derivative(plain, x, a, c)
    got = _second_derivative(wrapper, x, a, c)
    assert want.abs().max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("demod", [True, False])
def test_modulated_conv2d_matches_jax(k, demod):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 6, 6, 8).astype(np.float32)
    w = (rng.randn(k, k, 8, 5) * 0.3).astype(np.float32)  # HWIO
    style = rng.randn(3, 8).astype(np.float32)
    want = np.asarray(j_modconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(style), demod=demod))
    got = t_modconv(
        torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
        torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
        torch.from_numpy(style), demod=demod,
    ).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("fn", ["expand_styles", "mixed_w_styles", "truncate_w", "slerp",
                                "lpips_normalize"])
def test_latent_helpers_match_jax(fn):
    rng = np.random.RandomState(5)
    a = rng.randn(4, 10).astype(np.float32)
    b = rng.randn(4, 10).astype(np.float32)
    args = {
        "expand_styles": lambda m, x, y: m.expand_styles(x, 5),
        "mixed_w_styles": lambda m, x, y: m.mixed_w_styles(x, y, 2, 5),
        "truncate_w": lambda m, x, y: m.truncate_w(x, y[0], 0.75),
        "slerp": lambda m, x, y: m.slerp(0.3, x, y),
        "lpips_normalize": lambda m, x, y: m.lpips_normalize(x.reshape(2, 5, 2, 2)),
    }[fn]
    want = np.asarray(args(jlatents, jnp.asarray(a), jnp.asarray(b)))
    got = args(tlatents, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
