"""Bilinear 2x upsample and 3x3 binomial blur (NCHW), each a CUDA kernel
with its plain PyTorch version beside it.

``upsample2x_bilinear``, ``blur3`` and ``blur3_downsample2x`` dispatch on
the tensor's device: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel (``csrc/upsample2x_bilinear.cu``, ``csrc/blur3.cu``) or
raises on what the kernel does not take. Nothing falls back from the kernel
to the plain version.

All three ops are linear. The backward of each is its transpose, an
autograd Function of its own (the plain version's vjp) whose backward is the
op again, so second derivatives (the gradient penalty, the path-length
penalty) differentiate through the op exactly and launch its kernel. Where
no graph is recorded (grad off, or an input that needs none) the wrappers
call the forward directly: the Function would record nothing and costs
host time on every call.

The plain versions compute in float32 (float64 for float64 input) and round
once to the input dtype, as the kernels do; with the same order of operations the float32 results
agree bit for bit.

``LAUNCHES`` counts kernel launches per kernel name; only a launch adds to
it.

``upsample2x_blur`` (the generator's RGB-skip resampler) is the upsample
followed by the blur, or, on the fused resample graph (``ops.fusion``), one
polyphase pass in plain PyTorch ops, as the JAX package computes it.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from stylex_tpu_torch import csrc
from stylex_tpu_torch.ops.fusion import resample_fusion_enabled

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "upsample2x_bilinear",
    "upsample2x_bilinear_plain",
    "blur3",
    "blur3_plain",
    "blur3_downsample2x",
    "blur3_downsample2x_plain",
    "upsample2x_blur",
    "upsample2x_blur_unfused",
    "downsample_blur",
]

LAUNCHES: Dict[str, int] = {name: 0 for name in csrc.KERNELS}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ plain versions


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in float64 if it is that."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


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
    y = _upsample_axis(_upsample_axis(_wide(x), 2), 3)
    return y.to(x.dtype)


def _blur_plain(x: torch.Tensor, step: int) -> torch.Tensor:
    """The blur at every ``step``-th row and column."""
    h, w = x.shape[-2:]
    xp = F.pad(_wide(x), (1, 1, 1, 1), mode="reflect")
    v = (xp[..., 0:h:step, :] * 0.25 + xp[..., 1:h + 1:step, :] * 0.5) + xp[..., 2:h + 2:step, :] * 0.25
    y = (v[..., 0:w:step] * 0.25 + v[..., 1:w + 1:step] * 0.5) + v[..., 2:w + 2:step] * 0.25
    return y.to(x.dtype)


def blur3_plain(x: torch.Tensor) -> torch.Tensor:
    """[1,2,1] x [1,2,1] / 16 blur with reflect padding: the vertical pass,
    then the horizontal one (the JAX package's ``blur3_xla`` order)."""
    return _blur_plain(x, 1)


def _check_down_shape(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[2] < 2 or x.shape[3] < 2 or x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(
            f"blur3_downsample2x: needs (B, C, H, W) with even H, W >= 2, got {tuple(x.shape)}")


def blur3_downsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """``blur3_plain`` at the even rows and columns only, with the same taps
    in the same order: equal to ``blur3_plain(x)[..., ::2, ::2]``."""
    _check_down_shape(x)
    return _blur_plain(x, 2)


# ------------------------------------------------------------ kernel launches


THREADS = 256  # per block, as the kernels are compiled
_MAX_UNITS = 2**31 - 1  # the kernels number their threads in 32 bits

# kernel -> (input columns, output columns) per column of a thread's segment
_SEGMENT = {"upsample2x_bilinear": (1, 2), "blur3": (1, 1), "blur3_downsample2x": (2, 1)}


@functools.lru_cache(maxsize=4096)
def launch_geometry(name: str, planes: int, h: int, w: int, itemsize: int, x_addr: int,
                    y_addr: int):
    """How kernel ``name`` covers ``planes`` input planes of (h, w).

    Each thread takes one segment of one output row: ``vec`` input columns
    (2 * ``vec`` outputs) for the upsample, ``vec`` outputs for the blurs.
    ``vec`` is the widest that keeps every vector access within 16 bytes
    and aligned, given the addresses' residues mod 16 (``x_addr``,
    ``y_addr``), and divides the row: odd widths and misaligned inputs take
    1, scalar accesses. Returns ``(vec, rows, segs, launches)``: ``rows``
    and ``segs`` the thread rows and segments per plane, ``launches`` a
    tuple of ``(first plane, planes, blocks)``, one per launch, each under
    2^31 threads (one launch at every shape the paths give).
    """
    x_cols, y_cols = _SEGMENT[name]
    rows, cols = {"upsample2x_bilinear": (2 * h, w), "blur3": (h, w),
                  "blur3_downsample2x": (h // 2, w // 2)}[name]
    vec = 16 // (max(x_cols, y_cols) * itemsize)
    while vec > 1 and (cols % vec or x_addr % (vec * x_cols * itemsize)
                       or y_addr % (vec * y_cols * itemsize)):
        vec //= 2
    segs = cols // vec
    per_plane = rows * segs
    if per_plane > _MAX_UNITS:
        raise ValueError(f"{name}: a plane of {h}x{w} needs more than 2^31 threads")
    step = _MAX_UNITS // per_plane  # planes per launch
    launches = []
    for p0 in range(0, planes, step):
        n = min(step, planes - p0)
        launches.append((p0, n, -(-n * per_plane // THREADS)))
    return vec, rows, segs, tuple(launches)


# (kernel name, dtype) -> its C function, resolved at first use
_FUNCTIONS: Dict[tuple, Callable] = {}


def _launch(name: str, x: torch.Tensor, out_shape) -> torch.Tensor:
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: CUDA kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: CUDA kernel takes a contiguous NCHW tensor")
    fn = _FUNCTIONS.get((name, x.dtype))
    if fn is None:
        fn = _FUNCTIONS[name, x.dtype] = getattr(csrc.load(name), f"{name}_{_SUFFIX[x.dtype]}")
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    n, c, h, w = x.shape
    size = x.element_size()
    x_ptr, y_ptr = x.data_ptr(), y.data_ptr()
    vec, _, _, launches = launch_geometry(name, n * c, h, w, size, x_ptr % 16, y_ptr % 16)
    index = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    x_plane, y_plane = h * w * size, out_shape[2] * out_shape[3] * size
    for p0, planes, blocks in launches:
        err = fn(x_ptr + p0 * x_plane, y_ptr + p0 * y_plane, planes, h, w, vec, blocks, index,
                 stream)
        if err != 0:
            raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
        LAUNCHES[name] += 1
    return y


def _plain_vjp(plain: Callable, in_shape, g: torch.Tensor) -> torch.Tensor:
    """The transpose of a linear op applied to ``g``: the vjp of its plain
    version, evaluated at zero. It returns a value only; gradients through
    it are the business of :class:`_Adjoint`."""
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


def _upsample_forward(x: torch.Tensor) -> torch.Tensor:
    if not _check_device("upsample2x_bilinear", x):
        return upsample2x_bilinear_plain(x)
    n, c, h, w = x.shape
    return _launch("upsample2x_bilinear", x, (n, c, 2 * h, 2 * w))


def _blur_forward(x: torch.Tensor) -> torch.Tensor:
    if not _check_device("blur3", x):
        return blur3_plain(x)
    if x.dim() == 4 and (x.shape[2] < 2 or x.shape[3] < 2):
        raise ValueError("blur3: reflect padding needs H and W of at least 2")
    return _launch("blur3", x, x.shape)


def _blur_down_forward(x: torch.Tensor) -> torch.Tensor:
    _check_down_shape(x)
    if not _check_device("blur3_downsample2x", x):
        return blur3_downsample2x_plain(x)
    n, c, h, w = x.shape
    return _launch("blur3_downsample2x", x, (n, c, h // 2, w // 2))


# op name -> (forward: kernel on CUDA, plain version on CPU; plain version)
_OPS = {
    "upsample2x_bilinear": (_upsample_forward, upsample2x_bilinear_plain),
    "blur3": (_blur_forward, blur3_plain),
    "blur3_downsample2x": (_blur_down_forward, blur3_downsample2x_plain),
}


class _Op(torch.autograd.Function):
    """A linear op; its backward is :class:`_Adjoint`, so gradients of any
    order stay on the graph."""

    @staticmethod
    def forward(ctx, x, name):
        ctx.name, ctx.in_shape = name, x.shape
        return _OPS[name][0](x)

    @staticmethod
    def backward(ctx, g):
        return _Adjoint.apply(g, ctx.name, ctx.in_shape), None


class _Adjoint(torch.autograd.Function):
    """The transpose of op ``name``. Its own backward is the op's forward
    again (the transpose of the transpose), which launches the op's kernel
    on CUDA tensors: a double backward runs the forward kernels."""

    @staticmethod
    def forward(ctx, g, name, in_shape):
        ctx.name = name
        return _plain_vjp(_OPS[name][1], in_shape, g)

    @staticmethod
    def backward(ctx, gg):
        return _Op.apply(gg.contiguous(), ctx.name), None, None


def _apply(x: torch.Tensor, name: str) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Op.apply(x, name)
    # nothing to record: the forward alone, without the Function's host cost
    return _OPS[name][0](x)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W) bilinear, half-pixel centres, edge
    clamp: ``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=False)``.
    CUDA tensors run the hand-written kernel; CPU tensors the plain version."""
    return _apply(x, "upsample2x_bilinear")


def blur3(x: torch.Tensor) -> torch.Tensor:
    """3x3 normalised binomial blur with reflect padding, (B, C, H, W).
    CUDA tensors run the hand-written kernel; CPU tensors the plain version."""
    return _apply(x, "blur3")


def blur3_downsample2x(x: torch.Tensor) -> torch.Tensor:
    """``blur3`` keeping the even rows and columns: (B, C, H, W) ->
    (B, C, H/2, W/2) for even H, W >= 2. CUDA tensors run the hand-written
    kernel, which never writes the full-resolution blur; CPU tensors the
    plain version."""
    return _apply(x, "blur3_downsample2x")


# ------------------------------------------------------ fused upsample + blur


def upsample2x_blur_unfused(x: torch.Tensor) -> torch.Tensor:
    """The literal RGB-skip resampler: bilinear 2x, then the blur (two
    kernel launches on CUDA tensors)."""
    return blur3(upsample2x_bilinear(x))


# Per-axis polyphase taps of blur3 o upsample2x_bilinear on the edge-clamped
# coarse grid (half-pixel bilinear y[2i] = x[i-1]/4 + 3x[i]/4, y[2i+1] =
# 3x[i]/4 + x[i+1]/4; blur z[f] = y[f-1]/4 + y[f]/2 + y[f+1]/4):
#   z[2i]   = 0.3125 x[i-1] + 0.625 x[i] + 0.0625 x[i+1]
#   z[2i+1] = 0.0625 x[i-1] + 0.625 x[i] + 0.3125 x[i+1]
# except at the two outer fine rows, where the blur's reflect padding meets
# the upsample's clamp: z[0] = 0.875 x[0] + 0.125 x[1], z[2N-1] mirrored.
# Every tap is a dyadic, exact in bfloat16.
_UPBLUR_EVEN = (0.3125, 0.625, 0.0625)
_UPBLUR_ODD = (0.0625, 0.625, 0.3125)


def _upsample2x_blur_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    first, last = x.narrow(dim, 0, 1), x.narrow(dim, n - 1, 1)
    lo = torch.cat([first, x.narrow(dim, 0, n - 1)], dim)
    hi = torch.cat([x.narrow(dim, 1, n - 1), last], dim)
    (e0, e1, e2), (o0, o1, o2) = _UPBLUR_EVEN, _UPBLUR_ODD
    even = lo * e0 + x * e1 + hi * e2
    odd = lo * o0 + x * o1 + hi * o2
    z = torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)
    top = first * 0.875 + x.narrow(dim, 1, 1) * 0.125
    bottom = x.narrow(dim, n - 2, 1) * 0.125 + last * 0.875
    return torch.cat([top, z.narrow(dim, 1, 2 * n - 2), bottom], dim)


def upsample2x_blur(x: torch.Tensor) -> torch.Tensor:
    """``blur3(upsample2x_bilinear(x))``, (B, C, H, W) -> (B, C, 2H, 2W).

    With fusion on (``ops.fusion``) and H, W >= 2 it is one separable
    polyphase pass on the coarse grid (taps above), the fine grid written
    once, already blurred; equal to the literal composition to rounding.
    Otherwise it is the literal composition, which launches the two
    kernels on CUDA tensors. The fused form is plain PyTorch ops, as the
    JAX package computes it outside any Pallas kernel; autograd through it
    is its exact transpose.
    """
    h, w = x.shape[-2:]
    if h < 2 or w < 2 or not resample_fusion_enabled():
        return upsample2x_blur_unfused(x)
    return _upsample2x_blur_axis(_upsample2x_blur_axis(x, 2), 3)


def downsample_blur(x: torch.Tensor) -> torch.Tensor:
    """The blur before a stride-2 conv on the discriminator's downsample
    path: :func:`blur3` (the conv, which has weights, lives with the
    model). As in the JAX package it is not fused with the decimation
    (``blur3_downsample2x``, which no path runs)."""
    return blur3(x)
