"""Bilinear 2x upsample and 3x3 binomial blur (NCHW), each a CUDA kernel
with its plain PyTorch version beside it.

``upsample2x_bilinear`` and ``blur3`` dispatch on the tensor's device: a CPU
tensor takes the plain version; a CUDA tensor launches the kernel
(``csrc/upsample2x_bilinear.cu``, ``csrc/blur3.cu``) or raises on what the
kernel does not take. Nothing falls back from the kernel to the plain
version. Both ops are linear, so the backward pass of either is the plain
version's vjp, whichever forward ran.

The plain versions compute in float32 and round once to the input dtype,
as the kernels do; with the same order of operations the float32 results
agree bit for bit.

``LAUNCHES`` counts kernel launches per kernel name; only a launch adds to
it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from stylex_tpu_torch import csrc

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "upsample2x_bilinear",
    "upsample2x_bilinear_plain",
    "blur3",
    "blur3_plain",
]

LAUNCHES: Dict[str, int] = {name: 0 for name in csrc.KERNELS}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ plain versions


def _upsample_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device)
    prev = x.index_select(dim, (idx - 1).clamp(min=0))
    nxt = x.index_select(dim, (idx + 1).clamp(max=n - 1))
    even = prev * 0.25 + x * 0.75
    odd = x * 0.75 + nxt * 0.25
    return torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)


def upsample2x_bilinear_plain(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample, half-pixel centres (torch ``align_corners=False``),
    as explicit clamp-indexed taps: rows, then columns."""
    y = _upsample_axis(_upsample_axis(x.float(), 2), 3)
    return y.to(x.dtype)


def blur3_plain(x: torch.Tensor) -> torch.Tensor:
    """[1,2,1] x [1,2,1] / 16 blur with reflect padding: the vertical pass,
    then the horizontal one (the JAX package's ``blur3_xla`` order)."""
    h, w = x.shape[-2:]
    xp = F.pad(x.float(), (1, 1, 1, 1), mode="reflect")
    v = (xp[..., 0:h, :] * 0.25 + xp[..., 1:h + 1, :] * 0.5) + xp[..., 2:h + 2, :] * 0.25
    y = (v[..., 0:w] * 0.25 + v[..., 1:w + 1] * 0.5) + v[..., 2:w + 2] * 0.25
    return y.to(x.dtype)


# ------------------------------------------------------------ kernel launches


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int) -> int:
    # enough 256-thread blocks to fill every SM; the kernels loop over the rest
    return torch.cuda.get_device_properties(device_index).multi_processor_count * 8


def _launch(name: str, x: torch.Tensor, out_shape) -> torch.Tensor:
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: CUDA kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: CUDA kernel takes a contiguous NCHW tensor")
    fn = getattr(csrc.load(name), f"{name}_{_SUFFIX[x.dtype]}")
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    n, c, h, w = x.shape
    if y.numel() == 0:
        return y
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
        n * c, h, w, _max_blocks(index), index, ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return y


def _plain_vjp(plain: Callable, in_shape, g: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        x = torch.zeros(in_shape, dtype=g.dtype, device=g.device, requires_grad=True)
        (grad,) = torch.autograd.grad(plain(x), x, g)
    return grad


def _check_device(name: str, x: torch.Tensor) -> bool:
    """True for CUDA, False for CPU; raises on any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


class _Upsample2xBilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.in_shape = x.shape
        if not _check_device("upsample2x_bilinear", x):
            return upsample2x_bilinear_plain(x)
        n, c, h, w = x.shape
        return _launch("upsample2x_bilinear", x, (n, c, 2 * h, 2 * w))

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp(upsample2x_bilinear_plain, ctx.in_shape, g)


class _Blur3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.in_shape = x.shape
        if not _check_device("blur3", x):
            return blur3_plain(x)
        if x.dim() == 4 and (x.shape[2] < 2 or x.shape[3] < 2):
            raise ValueError("blur3: reflect padding needs H and W of at least 2")
        return _launch("blur3", x, x.shape)

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp(blur3_plain, ctx.in_shape, g)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W) bilinear, half-pixel centres, edge
    clamp: ``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=False)``.
    CUDA tensors run the hand-written kernel; CPU tensors the plain version."""
    return _Upsample2xBilinear.apply(x)


def blur3(x: torch.Tensor) -> torch.Tensor:
    """3x3 normalised binomial blur with reflect padding, (B, C, H, W).
    CUDA tensors run the hand-written kernel; CPU tensors the plain version."""
    return _Blur3.apply(x)
