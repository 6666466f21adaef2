"""The port's im2col convolution (``ops/conv.py``) against ``F.conv2d``.

On the card, float32 convolutions of the trainable nets run as im2col and a
matmul while autograd records; here, on the CPU, the same function is held
against ``F.conv2d`` in float64: forward, first derivatives and the second
derivative that the gradient penalty takes, grouped (the attention's
depthwise conv) and not. The dispatcher sends CPU
tensors to ``F.conv2d`` itself.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stylex_tpu_torch.ops.conv import conv2d, conv2d_gemm

# (in_ch, out_ch, kernel, stride, padding, bias, groups): the D/E/G convs
# (3x3 stride 1 and 2, 1x1 residual stride 2, 1x1 to-RGB), a 5x5 (the fused
# downsample), the attention's depthwise 3x3 and a grouped one
CASES = [(4, 6, 3, 1, 1, True, 1), (4, 6, 3, 2, 1, True, 1), (4, 6, 1, 2, 0, True, 1),
         (5, 3, 1, 1, 0, False, 1), (3, 4, 5, 1, 2, False, 1), (3, 5, 3, 2, 0, True, 1),
         (4, 4, 3, 1, 1, False, 4), (4, 6, 3, 2, 1, True, 2)]


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
