"""The port's ops against the JAX package's, on the CPU.

The kernels' plain versions (what a CPU tensor runs) are held against the
JAX forms and the Pallas kernels in interpret mode, float32, atol 1e-6:
both sides compute the same taps in float32, so they agree to rounding.
Modulated conv and the latent helpers are held at rtol 1e-5 (one conv /
matmul summed in another order).
"""

import importlib.util
import re
from pathlib import Path

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
from stylex_tpu_torch.profile_sweep import OWN_KERNELS

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

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


# ------------------------------------------------- the kernels' launch geometry


def _phase2_cases():
    """Every shape ``chip_smoke.py`` phase 2 gives each kernel."""
    return [pytest.param(name, tuple(shape), id=f"{name}-{group}-{'x'.join(map(str, shape))}")
            for name, groups in chip_smoke.kernel_shapes().items()
            for group, shapes in groups.items() for shape in shapes]


def _thread_accesses(name, vec, segs, h, w, units):
    """For kernel threads ``units`` (numbered within one launch), as the
    ``.cu`` kernels map them: the plane, the first element of each vector
    load of x (two or three rows), and the output elements written, as flat
    indices within the launch (shape (len(units), k)); then the elements per
    load and per store access (1 at ``vec`` 1: scalar accesses)."""
    if name == "upsample2x_bilinear":
        orow = units // segs  # plane * 2h + output row
        c0 = (units - orow * segs) * vec
        row = orow // 2  # plane * h + input row
        plane, iy = row // h, row % h
        mid = row * w + c0
        near = np.where(orow % 2, np.where(iy < h - 1, mid + w, mid), np.where(iy > 0, mid - w, mid))
        out = (orow * 2 * w + 2 * c0)[:, None] + np.arange(2 * vec)
        return plane, np.stack([near, mid], 1), out, (vec, 2 * vec if vec > 1 else 1)
    down = name == "blur3_downsample2x"
    ho, wo = (h // 2, w // 2) if down else (h, w)
    orow = units // segs
    c0 = (units - orow * segs) * vec
    plane = orow // ho
    r = (orow - plane * ho) * (2 if down else 1)
    mid = (plane * h + r) * w + (2 * c0 if down else c0)
    loads = np.stack([np.where(r > 0, mid - w, mid + w), mid, np.where(r < h - 1, mid + w, mid - w)], 1)
    out = (orow * wo + c0)[:, None] + np.arange(vec)
    return plane, loads, out, (2 * vec if down and vec > 1 else vec, vec)


@pytest.mark.parametrize("name,shape", _phase2_cases())
def test_launch_geometry_covers_each_output_once(name, shape):
    """The grid the wrapper computes, emulated thread by thread as the
    kernels map threads to elements: every output element of a plane is
    written by exactly one thread, every vector access is aligned, and the
    grid stays within CUDA's limits. Float32 and bfloat16, an aligned input
    and one a single element into its storage."""
    n, c, h, w = shape
    planes = n * c
    oh, ow = {"upsample2x_bilinear": (2 * h, 2 * w), "blur3": (h, w),
              "blur3_downsample2x": (h // 2, w // 2)}[name]
    for itemsize in (4, 2):
        for x_addr in (0, itemsize):
            vec, rows, segs, launches = tblur.launch_geometry(name, planes, h, w, itemsize,
                                                              x_addr, 0)
            assert vec * itemsize * (1 if name == "blur3" else 2) <= 16
            if x_addr:
                assert vec == 1
            assert [p0 for p0, _, _ in launches] == list(
                np.cumsum([0] + [k for _, k, _ in launches])[:-1])
            assert sum(k for _, k, _ in launches) == planes
            for p0, k, blocks in launches:
                units = k * rows * segs
                assert units <= 2**31 - 1
                assert 1 <= blocks <= 2**31 - 1  # gridDim.x; y and z stay 1
                assert (blocks - 1) * tblur.THREADS < units <= blocks * tblur.THREADS
                # the threads of the launch's first two planes and its last
                per_plane = rows * segs
                sample = np.unique(np.concatenate([
                    np.arange(min(2, k) * per_plane), np.arange((k - 1) * per_plane, units)]))
                plane, loads, out, (load_n, store_n) = _thread_accesses(name, vec, segs, h, w,
                                                                         sample)
                assert ((x_addr + loads * itemsize) % (load_n * itemsize) == 0).all()
                assert (loads >= 0).all() and (loads + load_n <= k * h * w).all()
                assert (out[:, ::store_n] % store_n == 0).all()
                for p in np.unique(plane):
                    written = np.sort(out[plane == p].ravel())
                    np.testing.assert_array_equal(written, p * oh * ow + np.arange(oh * ow))


def test_launch_geometry_vector_widths_and_split():
    g = tblur.launch_geometry
    # 16-byte stores of the upsample's output rows, 16-byte loads of the blurs
    assert g("upsample2x_bilinear", 616 * 512, 4, 4, 2, 0, 0)[0] == 4
    assert g("upsample2x_bilinear", 4 * 64, 128, 128, 4, 0, 0)[0] == 2
    assert g("blur3", 616 * 3, 64, 64, 2, 0, 0)[0] == 8
    assert g("blur3", 64 * 64, 64, 64, 4, 0, 0)[0] == 4
    assert g("blur3_downsample2x", 32 * 64, 64, 64, 2, 0, 0)[0] == 4
    assert g("blur3_downsample2x", 32 * 64, 64, 64, 4, 0, 0)[0] == 2
    # ragged widths narrow the vector to what divides the row
    assert g("blur3", 24, 5, 7, 2, 0, 0)[0] == 1
    assert g("blur3", 24, 2, 6, 2, 0, 0)[0] == 2
    assert g("upsample2x_bilinear", 24, 4, 2, 2, 0, 0)[0] == 2
    # a call past 2^31 threads is split by planes into several launches
    vec, rows, segs, launches = g("blur3", 40, 2**15, 2**15, 2, 0, 0)
    assert len(launches) == 3 and sum(k for _, k, _ in launches) == 40
    assert all(k * rows * segs <= 2**31 - 1 for _, k, _ in launches)


def test_profile_names_match_kernel_symbols():
    """``profile_sweep`` and ``profile_train`` find the package's kernels in a
    trace by these substrings of their symbols."""
    src = "".join(p.read_text() for p in (ROOT / "stylex_tpu_torch" / "csrc").glob("*.cu"))
    for symbol in OWN_KERNELS.values():
        assert re.search(rf"__global__[^;{{]*\b{symbol}\(", src), symbol
