"""The port's training losses against the JAX package's, on the CPU.

The same numpy inputs go through both; float32, rtol 1e-5 / atol 1e-6 for
the closed-form losses, rtol 1e-4 / atol 1e-5 where a network (LPIPS) or a
second derivative sums in another order. The two penalties are checked on
their value and on the gradient of their value with respect to an upstream
weight, which runs through the kernels' backward (blur, upsample).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylex_tpu import losses as jlosses
from stylex_tpu.models.lpips import init_lpips_params as j_init_lpips
from stylex_tpu.ops.blur import blur3_xla, upsample2x_bilinear_xla
from stylex_tpu_torch import losses as tlosses
from stylex_tpu_torch.models.convert import lpips_params_from_jax
from stylex_tpu_torch.ops.blur import blur3, upsample2x_bilinear

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["d_hinge_loss", "dual_contrastive_loss",
                                  "classifier_kl_loss", "g_hinge_loss"])
def test_closed_form_losses_match_jax(name):
    rng = np.random.RandomState(0)
    shape = (6, 2) if name == "classifier_kl_loss" else (8,)
    a, b = (rng.randn(*shape).astype(np.float32) * 2 for _ in range(2))
    args = (a,) if name == "g_hinge_loss" else (a, b)
    want = getattr(jlosses, name)(*map(jnp.asarray, args))
    got = getattr(tlosses, name)(*map(torch.from_numpy, args))
    _close(got, want)


def test_reconstruction_loss_matches_jax():
    rng = np.random.RandomState(1)
    jlp = j_init_lpips(jax.random.PRNGKey(1))
    lp = lpips_params_from_jax(jax.tree.map(np.asarray, jlp))
    x, y = (rng.rand(3, 16, 16, 3).astype(np.float32) for _ in range(2))
    wx, wy = (rng.randn(3, 32).astype(np.float32) for _ in range(2))
    want = jlosses.reconstruction_loss(jlp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(wy),
                                       jnp.asarray(wx))
    got = tlosses.reconstruction_loss(lp, _nchw(x), _nchw(y), torch.from_numpy(wy),
                                      torch.from_numpy(wx))
    _close(got, want, rtol=1e-4, atol=1e-5)


def _gp_inputs():
    rng = np.random.RandomState(2)
    x = rng.rand(3, 8, 8, 4).astype(np.float32)
    a = (rng.randn(4) * 0.5 + 1).astype(np.float32)
    c = rng.randn(8, 8, 4).astype(np.float32)
    return x, a, c


def test_gradient_penalty_and_its_weight_gradient_match_jax():
    """score(x) = sum(c * tanh(blur3(a * x))) per sample; the penalty and
    d penalty / d a."""
    x, a, c = _gp_inputs()

    def j_pen(a_):
        score = lambda im: jnp.sum(c * jnp.tanh(blur3_xla(im * a_)), axis=(1, 2, 3))
        return jlosses.gradient_penalty(score, jnp.asarray(x))

    want, want_da = jax.value_and_grad(j_pen)(jnp.asarray(a))
    at = torch.from_numpy(a).requires_grad_(True)
    ct = _nchw(c[None])[0]
    score = lambda im: (ct * torch.tanh(blur3(im * at[:, None, None]))).sum(dim=(1, 2, 3))
    got = tlosses.gradient_penalty(score, _nchw(x))
    (got_da,) = torch.autograd.grad(got, at)
    _close(got, want, rtol=1e-4, atol=1e-5)
    _close(got_da, want_da, rtol=1e-4, atol=1e-5)


def test_path_length_penalty_and_its_weight_gradient_match_jax():
    """images = upsample2x(tanh(w-linear map)); the penalty, the mean path
    length and d penalty / d M, with JAX's projection noise passed in."""
    rng = np.random.RandomState(3)
    B, L, D, S = 2, 3, 5, 4
    w = rng.randn(B, L, D).astype(np.float32)
    m = (rng.randn(L * D, S * S * 3) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    pl_mean = 0.7

    def j_gen(m_):
        return lambda w_: upsample2x_bilinear_xla(
            jnp.tanh(w_.reshape(B, -1) @ m_).reshape(B, S, S, 3))

    def j_pen(m_):
        return jlosses.path_length_penalty(j_gen(m_), jnp.asarray(w), key, pl_mean)

    (want, want_len), want_dm = jax.value_and_grad(j_pen, has_aux=True)(jnp.asarray(m))
    noise = np.asarray(jax.random.normal(key, (B, 2 * S, 2 * S, 3)))
    mt = torch.from_numpy(m).requires_grad_(True)
    gen = lambda w_: upsample2x_bilinear(
        torch.tanh(w_.reshape(B, -1) @ mt).reshape(B, S, S, 3).permute(0, 3, 1, 2).contiguous())
    got, got_len = tlosses.path_length_penalty(gen, torch.from_numpy(w), _nchw(noise),
                                               torch.tensor(pl_mean))
    (got_dm,) = torch.autograd.grad(got, mt)
    _close(got, want, rtol=1e-4, atol=1e-5)
    _close(got_len, want_len, rtol=1e-4, atol=1e-5)
    _close(got_dm, want_dm, rtol=1e-4, atol=1e-5)
