"""The port's DiffAugment against the JAX package's, on the CPU, with the
JAX draws passed in.

:func:`jax_draws` replays the key splits of ``augment_for_discriminator``
(gate, flip, pipeline key) and of each augmentation, and hands the same
random numbers to the port. The augmentations move, scale and mask pixels
in the same float32 order, so they agree to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylex_tpu.ops import diffaug as jaug
from stylex_tpu_torch.ops import diffaug as taug

ATOL = 1e-6
TYPE_SETS = [("translation", "cutout"), ("color",), ("lightcolor",), ("offset",),
             ("offset_h",), ("offset_v",), ("lightbrightness", "lightsaturation", "lightcontrast")]


def jax_draws(key, n, size, prob, types):
    """The draws ``augment_for_discriminator(key, x, prob, types)`` makes
    for n square images, as the port's :class:`AugmentDraws`."""
    k_gate, k_flip, k_aug = jax.random.split(key, 3)
    gate = bool(jax.random.bernoulli(k_gate, prob))
    flip = bool(jax.random.bernoulli(k_flip, 0.5))
    return taug.AugmentDraws(torch.full((n,), gate), torch.full((n,), flip),
                             jax_pipeline_draws(k_aug, n, size, types))


def jax_pipeline_draws(k_aug, n, size, types):
    """The draws of ``diff_augment(k_aug, x, types)`` for n square images,
    as the ``ops`` of the port's :class:`AugmentDraws`."""
    t = lambda a, dt=torch.int64: torch.from_numpy(np.array(a).reshape(-1)).to(dt)
    ops = []
    for name, arg in (s for ty in types for s in jaug.AUGMENT_TYPES[ty]):
        k_aug, sub = jax.random.split(k_aug)
        if name in ("brightness", "saturation", "contrast"):
            ops.append((t(jax.random.uniform(sub, (n, 1, 1, 1)), torch.float32),))
        elif name == "translation":
            s = int(size * arg + 0.5)
            kh, kw = jax.random.split(sub)
            ops.append((t(jax.random.randint(kh, (n, 1, 1), -s, s + 1)),
                        t(jax.random.randint(kw, (n, 1, 1), -s, s + 1))))
        elif name == "cutout":
            c = int(size * arg + 0.5)
            kh, kw = jax.random.split(sub)
            ops.append((t(jax.random.randint(kh, (n, 1, 1), 0, size + (1 - c % 2))),
                        t(jax.random.randint(kw, (n, 1, 1), 0, size + (1 - c % 2)))))
        else:
            ratio, rh, rv = arg
            max_h, max_v = int(size * ratio * rh), int(size * ratio * rv)
            kh, kv = jax.random.split(sub)
            vh = t(jax.random.randint(kh, (n,), 0, max_h + 1) * 2 - max_h) if max_h > 0 else None
            vv = t(jax.random.randint(kv, (n,), 0, max_v + 1) * 2 - max_v) if max_v > 0 else None
            ops.append((vh, vv))
    return tuple(ops)


def _images(seed, n=3, size=16):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


def _port(x_nhwc, draws, types):
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
    y = taug.augment_for_discriminator(x, draws, types)
    assert y.is_contiguous()  # D's blur kernel takes contiguous NCHW only
    return y.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("types", TYPE_SETS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_for_discriminator_matches_jax(types, seed):
    x = _images(seed)
    key = jax.random.PRNGKey(seed)
    prob = 0.7
    want = np.asarray(jaug.augment_for_discriminator(key, jnp.asarray(x), prob, types))
    got = _port(x, jax_draws(key, 3, 16, prob, types), types)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_micro_batches_take_their_own_draws():
    """Two micro-batches in one call, each with its own gate and flip,
    equal the JAX pipeline run on each with its own key."""
    types = ("translation", "cutout", "color")
    x = _images(5, n=4)
    keys = [jax.random.PRNGKey(10), jax.random.PRNGKey(13)]
    parts = [jax_draws(k, 2, 16, 1.0, types) for k in keys]
    both = taug.AugmentDraws(
        torch.cat([p.gate for p in parts]), torch.cat([p.flip for p in parts]),
        tuple(tuple(None if a[0] is None else torch.cat(a) for a in zip(*ops))
              for ops in zip(*(p.ops for p in parts))))
    want = np.concatenate([np.asarray(jaug.augment_for_discriminator(k, jnp.asarray(x[2 * i:2 * i + 2]),
                                                                     1.0, types))
                           for i, k in enumerate(keys)])
    np.testing.assert_allclose(_port(x, both, types), want, rtol=0, atol=ATOL)


def test_no_augmentation_is_the_identity():
    gen = torch.Generator().manual_seed(0)
    assert taug.draw_augment(gen, 2, 2, 16, 0.0, ("translation",)) is None
    x = torch.rand(2, 3, 8, 8)
    assert torch.equal(taug.augment_for_discriminator(x, None, ("translation",)), x)


def test_draw_augment_shapes_and_ranges():
    gen = torch.Generator().manual_seed(1)
    types = ("translation", "cutout", "offset", "color")
    d = taug.draw_augment(gen, groups=3, group_size=4, image_size=16, prob=0.5, types=types)
    assert d.gate.shape == d.flip.shape == (12,)
    assert torch.equal(d.gate.view(3, 4), d.gate.view(3, 4)[:, :1].expand(3, 4))
    (th, tw), (oy, ox), (vh, vv) = d.ops[:3]
    assert int(th.abs().max()) <= 2 and int(tw.abs().max()) <= 2
    assert int(oy.min()) >= 0 and int(oy.max()) <= 16
    assert int(vh.abs().max()) <= 16 and vv.shape == (12,)
    assert len(d.ops) == 6
    y = taug.augment_for_discriminator(torch.rand(12, 3, 16, 16), d, types)
    assert y.shape == (12, 3, 16, 16) and torch.isfinite(y).all()
    # D's blur kernel takes contiguous NCHW only
    assert y.is_contiguous()
