"""The port's im2col convolution (``ops/conv.py``) against ``F.conv2d``.

On the card, float32 convolutions of the trainable nets run as im2col and a
matmul while autograd records; here, on the CPU, the same function is held
against ``F.conv2d`` in float64: forward, first derivatives and the second
derivative that the gradient penalty takes, grouped (the attention's
depthwise conv) and not. The dispatcher sends CPU
tensors to ``F.conv2d`` itself.

The column passes are two autograd Functions, ``im2col`` and its adjoint
``col2im``, each the other's backward; on the CPU they run the plain
versions (the CUDA kernels' sources are held against those in
``test_torch_kernel_emulation.py``). Here: the adjoint identity in float64,
``gradcheck`` and ``gradgradcheck`` of both, the 1x1 view, the tile
geometries the kernels are launched with, and that a CPU tensor never
reaches a kernel.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stylex_tpu_torch import csrc
from stylex_tpu_torch.ops import LAUNCHES
from stylex_tpu_torch.ops import conv as tconv
from stylex_tpu_torch.ops.conv import col2im, conv2d, conv2d_gemm, im2col

# (in_ch, out_ch, kernel, stride, padding, bias, groups): the D/E/G convs
# (3x3 stride 1 and 2, 1x1 residual stride 2, 1x1 to-RGB), a 5x5 (the fused
# downsample), the attention's depthwise 3x3 and a grouped one
CASES = [(4, 6, 3, 1, 1, True, 1), (4, 6, 3, 2, 1, True, 1), (4, 6, 1, 2, 0, True, 1),
         (5, 3, 1, 1, 0, False, 1), (3, 4, 5, 1, 2, False, 1), (3, 5, 3, 2, 0, True, 1),
         (4, 4, 3, 1, 1, False, 4), (4, 6, 3, 2, 1, True, 2),
         (3, 4, 5, 2, 0, True, 1), (4, 4, 3, 2, 1, False, 4)]


def _inputs(c_in, c_out, k, bias, seed, groups=1):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(2, c_in, 8, 10), dtype=torch.float64, requires_grad=True)
    w = torch.tensor(rng.randn(c_out, c_in // groups, k, k) / k, dtype=torch.float64,
                     requires_grad=True)
    b = torch.tensor(rng.randn(c_out), dtype=torch.float64, requires_grad=True) if bias else None
    return x, w, b


@pytest.mark.parametrize("c_in,c_out,k,stride,padding,bias,groups", CASES)
def test_conv2d_gemm_matches_conv2d_to_second_order(c_in, c_out, k, stride, padding, bias,
                                                    groups):
    x, w, b = _inputs(c_in, c_out, k, bias, seed=k * 10 + stride, groups=groups)
    params = [x, w] + ([b] if bias else [])
    results = []
    for fn in (conv2d_gemm, F.conv2d):
        y = fn(x, w, b, stride, padding, groups=groups)
        gy = torch.cos(torch.arange(y.numel(), dtype=y.dtype)).reshape(y.shape)
        grads = torch.autograd.grad((y * gy).sum(), params, create_graph=True)
        # an R1-style penalty on d(y . gy)/dx, differentiated again
        (gw,) = torch.autograd.grad(grads[0].square().sum(), [w])
        results.append([y, *grads, gw])
    for got, want in zip(*results):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                                   rtol=1e-10, atol=1e-10)


def test_conv2d_sends_cpu_tensors_to_conv2d():
    x, w, b = _inputs(4, 6, 3, True, seed=0)
    x32, w32, b32 = x.detach().float(), w.detach().float(), b.detach().float()
    assert torch.equal(conv2d(x32, w32, b32, 1, 1), F.conv2d(x32, w32, b32, 1, 1))
    w_dw = torch.randn(4, 1, 3, 3)
    assert torch.equal(conv2d(x32, w_dw, None, 1, 1, groups=4),
                       F.conv2d(x32, w_dw, None, 1, 1, groups=4))


# (image, kernel, stride, padding) of the column passes: CASES' windows on
# the test's 8x10 images, then a 5x5 stride 2 over the fused downsample's
# unpadded map, and the same windows over a sliced (non-contiguous) image
WINDOWS = sorted({(k, s, p) for _, _, k, s, p, _, _ in CASES})


def _image(shape, seed, sliced=False):
    rng = np.random.RandomState(seed)
    if not sliced:
        return torch.tensor(rng.randn(*shape), dtype=torch.float64)
    n, c, h, w = shape
    big = torch.tensor(rng.randn(n, c + 1, 2 * h, w + 3), dtype=torch.float64)
    return big[:, 1:, ::2, 2:w + 2]


COLUMN_CASES = ([((2, 3, 8, 10), k, s, p, False) for k, s, p in WINDOWS]
                + [((2, 3, 11, 11), 5, 2, 0, False)]
                + [((2, 3, 8, 10), k, s, p, True) for k, s, p in WINDOWS])


@pytest.mark.parametrize("g_position_major", [False, True])
@pytest.mark.parametrize("shape,k,s,p,sliced", COLUMN_CASES)
def test_col2im_is_the_adjoint_of_im2col(shape, k, s, p, sliced, g_position_major):
    """<im2col(x), g> == <x, col2im(g)> in float64, and each equals its
    plain version; the columns position-major (but for the 1x1 view), the
    gradient row-major or position-major."""
    x = _image(shape, seed=k * 10 + s, sliced=sliced)
    assert x.is_contiguous() == (not sliced)
    cols = im2col(x, k, s, p)
    assert torch.equal(cols, tconv.im2col_plain(x, k, s, p))
    if (k, s, p) != (1, 1, 0) or sliced:
        assert cols.stride()[1:] == (1, cols.shape[1])
    g = _image(cols.shape + (1,), seed=7)[..., 0]
    if g_position_major:
        g = g.mT.contiguous().mT
    back = col2im(g, x.shape[2:], k, s, p)
    assert back.shape == x.shape
    assert torch.equal(back, tconv.col2im_plain(g, x.shape[2:], k, s, p))
    lhs, rhs = float((cols * g).sum()), float((x * back).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k,s,p", WINDOWS + [(5, 2, 0)])
@pytest.mark.parametrize("op", ["im2col", "col2im", "im2col sliced", "col2im position-major"])
def test_column_functions_pass_gradcheck_and_gradgradcheck(op, k, s, p):
    x = _image((1, 2, 6, 7), seed=k + s + p, sliced=op.endswith("sliced")).requires_grad_(True)
    pm = op.endswith("position-major")
    if op.startswith("im2col"):
        fn, inp = (lambda t: im2col(t, k, s, p)), x
    else:
        rows = tconv.im2col_plain(x.detach(), k, s, p)
        inp = _image(rows.shape + (1,), seed=3)[..., 0]
        inp = (inp.mT.contiguous().mT if pm else inp).requires_grad_(True)
        fn = lambda t: col2im(t, (6, 7), k, s, p)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (inp,))
    assert torch.autograd.gradgradcheck(fn, (inp,))


def test_one_by_one_stride_one_columns_are_a_view():
    x = _image((2, 3, 4, 5), seed=1).requires_grad_(True)
    cols = im2col(x, 1, 1, 0)
    assert cols.shape == (2, 3, 20) and cols.data_ptr() == x.data_ptr()
    (g,) = torch.autograd.grad(cols.sum(), x)
    assert torch.equal(g, torch.ones_like(x))


def test_columns_stay_on_the_plain_path_on_cpu(monkeypatch):
    """A CPU convolution, its gradients and the penalty's second derivative
    through conv2d_gemm never load or launch a kernel."""
    def no_build(*_):
        raise AssertionError("a CPU tensor must not reach the CUDA kernel")

    monkeypatch.setattr(csrc, "load", no_build)
    before = dict(LAUNCHES)
    x, w, b = _inputs(3, 4, 5, True, seed=2)
    y = conv2d_gemm(x.float(), w.float(), b.float(), 2, 0)
    (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    torch.autograd.grad(gx.square().sum(), w)
    assert LAUNCHES == before and {"im2col", "col2im"} <= set(LAUNCHES)


def test_column_passes_refuse_other_devices():
    x = torch.empty(1, 1, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        im2col(x, 3, 1, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        col2im(torch.empty(1, 9, 16, device="meta"), (4, 4), 3, 1, 1)


# (n, c, h, w, kernel, stride, padding): the step's columns at 256 px and
# batch 32 (D's 3x3 and 5x5 stride 2, G's 3x3 and its up-conv's strips, the
# 1x1 residuals, the RGB input), small planes, wide rows, and a window too
# large for col2im's tile; for im2col and for col2im
GEOMETRY_CASES = [(32, 64, 256, 256, 3, 1, 1), (64, 64, 259, 259, 5, 2, 0),
                  (32, 32, 256, 256, 3, 1, 1), (32, 128, 3, 128, 3, 1, 1),
                  (32, 128, 128, 3, 3, 1, 1), (32, 256, 64, 64, 1, 2, 0),
                  (32, 512, 4, 4, 3, 1, 1), (16, 512, 2, 2, 3, 1, 1), (32, 3, 256, 256, 3, 1, 1),
                  (2, 3, 9, 7, 3, 2, 1), (2, 1, 3, 1400, 3, 1, 1), (1, 2, 40, 3000, 5, 2, 2),
                  (1, 1, 1, 1, 1, 1, 0), (1, 6, 40, 40, 63, 1, 31)]


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("n,c,h,w,k,s,p", GEOMETRY_CASES)
def test_columns_geometry_fits_the_tile_and_covers_the_output(n, c, h, w, k, s, p, gather):
    """im2col's tiles (``gather`` False) and col2im's (True) fit the shared
    tile that ``csrc`` compiles and cover the output with whole channel
    groups of one image."""
    taps = k * k
    if gather:
        if ((k - 1) // s + 1) ** 2 * (taps | 1) > csrc.GATHER_FLOATS:  # even one pixel's windows
            with pytest.raises(ValueError, match="outgrow"):
                tconv.gather_geometry(n, c, h, w, k, k, s, s)
            return
        geo = tconv.gather_geometry(n, c, h, w, k, k, s, s)
        pim, pjm = (geo.th + k - 2) // s + 1, (geo.tw + k - 2) // s + 1
        assert c % geo.cb == 0 and pim * pjm * (geo.cb * taps | 1) <= csrc.GATHER_FLOATS
        assert 1 <= geo.th <= h and 1 <= geo.tw <= w
        assert geo.blocks == n * (c // geo.cb) * -(-h // geo.th) * -(-w // geo.tw)
        return
    geo = tconv.columns_geometry(n, c, h, w, k, k, s, s, p, p)
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    assert (geo.oh, geo.ow) == (oh, ow)
    rows, wt = (geo.ti - 1) * s + k, (geo.tj - 1) * s + k
    assert geo.pb * rows * wt <= csrc.TILE_FLOATS
    assert 1 <= geo.ti <= min(oh, 8) and 1 <= geo.tj <= min(ow, 16)
    assert geo.blocks == n * (c // geo.pb) * -(-oh // geo.ti) * -(-ow // geo.tj)
    # whole channel groups of one image; runs of pb * k * k entries
    assert c % geo.pb == 0 and geo.pb * taps % geo.vec == 0 and c * taps % geo.vec == 0
    assert geo.vec == 4 or (geo.pb * taps % (2 * geo.vec) or c * taps % (2 * geo.vec))
