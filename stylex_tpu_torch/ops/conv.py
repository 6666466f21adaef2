"""2-D convolution of the trainable nets (NCHW / OIHW).

cuDNN's float32 algorithms (Winograd, FFT) compute weight gradients to
about 2e-5 of their magnitude at StylEx's 3x3 stride-1 shapes and to 1e-3
at a 5x5 one, where a direct sum keeps under 1e-6 (against float64, with
TF32 off, on an H100 80GB HBM3 with cuDNN 9.2: ``chip_smoke.py`` phase 6).
A train step amplifies that: its encoder and G gradients drifted to ~4e-4
x max|g| from a float64 witness, against ~1e-4 for the CPU. So a float32
convolution on a CUDA tensor that autograd records runs as im2col and one
batched matmul per group (cuBLAS, IEEE float32). Everything else (no
gradient, bfloat16, the CPU) calls ``F.conv2d``.

The column passes around the matmul are hand-written kernels:
:func:`im2col` (``csrc/im2col.cu``) writes the columns in one pass, reading
the zero padding at the image's borders, and :func:`col2im`
(``csrc/col2im.cu``), its adjoint, gathers a gradient of the columns back
to the image, each pixel's terms summed in the order of PyTorch's
``unfold_backward``. The GEMM is unchanged: the same ``torch.matmul`` on
columns of the same shape and values as the plain version's pad, strided
window views and copy (:func:`im2col_plain`). The columns are written
position-major, the transpose that ``torch.matmul`` folds an ungrouped
convolution's columns to before its one cuBLAS GEMM, so it folds them as a
view where the plain columns cost it a copy, and calls the same GEMM on the
same bytes; a grouped convolution's batched matmul copies them to the plain
layout, as the plain version's pad and copy did. So the output and the
weight gradient are the plain version's bit for bit, and the input gradient
too (:func:`col2im_plain`, autograd's own ``unfold_backward`` passes). Each
of the two is an autograd Function whose backward is the other, so every
derivative of any order is a matmul or a gather/scatter, and the gradient
penalty's double backward launches both kernels. A CPU tensor takes the
plain versions; a CUDA tensor launches the kernel or raises.
``ops.LAUNCHES`` counts the launches under ``im2col`` and ``col2im``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple

import torch
import torch.nn.functional as F

from stylex_tpu_torch import csrc
from stylex_tpu_torch.ops.blur import LAUNCHES, THREADS

__all__ = ["conv2d", "conv2d_gemm", "im2col", "im2col_plain", "col2im", "col2im_plain",
           "columns_geometry"]

# the im2col path for float32 CUDA convolutions under autograd; off, they
# go to cuDNN too (chip_smoke.py turns it off to measure cuDNN's drift)
GEMM_FLOAT32 = True

_MAX_UNITS = 2**31 - 1  # the kernels number their blocks in 32 bits


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _out_size(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


# ------------------------------------------------------------ plain versions


def im2col_plain(x: torch.Tensor, kernel, stride=1, padding=0) -> torch.Tensor:
    """The columns of ``x`` (n, c, h, w) for a ``kernel`` (kh, kw) window at
    ``stride`` over its zero ``padding``: (n, c * kh * kw, oh * ow), row
    (ch * kh + ki) * kw + kj, column i * ow + j. Zero pad, strided window
    views, one copy."""
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel), _pair(stride), _pair(padding)
    n, c = x.shape[:2]
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph))
    win = x.unfold(2, kh, sh).unfold(3, kw, sw)  # (n, c, oh, ow, kh, kw) view
    oh, ow = win.shape[2], win.shape[3]
    return win.permute(0, 1, 4, 5, 2, 3).reshape(n, c * kh * kw, oh * ow)


def col2im_plain(g: torch.Tensor, size, kernel, stride=1, padding=0) -> torch.Tensor:
    """:func:`im2col_plain`'s adjoint: the gradient (n, c, h, w) of an image
    of spatial ``size`` (h, w) from a gradient ``g`` of its columns, as
    autograd differentiates ``im2col_plain``: ``unfold_backward`` along the
    rows' windows, then the columns', then the padding cut away."""
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel), _pair(stride), _pair(padding)
    (h, w), n = size, g.shape[0]
    c = g.shape[1] // (kh * kw)
    hp, wp = h + 2 * ph, w + 2 * pw
    oh, ow = _out_size(h, kh, sh, ph), _out_size(w, kw, sw, pw)
    t = g.reshape(n, c, kh, kw, oh, ow).permute(0, 1, 4, 5, 2, 3)
    t = torch.ops.aten.unfold_backward(t, [n, c, oh, wp, kh], 3, kw, sw)
    t = torch.ops.aten.unfold_backward(t, [n, c, hp, wp], 2, kh, sh)
    return t[:, :, ph:ph + h, pw:pw + w].contiguous()


# ------------------------------------------------------------ kernel launches


class ColumnsGeometry(NamedTuple):
    """How im2col covers one call: a block takes ``pb`` channels of one
    image, ``ti`` output rows and ``tj`` output columns, loads their input
    under ``csrc.TILE_FLOATS``, and stores ``vec`` elements at a time;
    ``blocks`` blocks of ``THREADS`` threads."""
    oh: int
    ow: int
    pb: int
    ti: int
    tj: int
    vec: int
    blocks: int


@functools.lru_cache(maxsize=4096)
def columns_geometry(n: int, c: int, h: int, w: int, kh: int, kw: int, sh: int, sw: int,
                     ph: int, pw: int) -> ColumnsGeometry:
    """im2col's tiles for an (n, c, h, w) image, a (kh, kw) window at
    stride (sh, sw) over padding (ph, pw), the columns position-major: a tile
    of up to 8 x 16 positions, over the most channels of one image (a
    divisor of ``c``) that the shared tile holds while the grid keeps about
    2,048 blocks, at least 32 entries a position where the tile allows;
    ``vec`` divides a position's run of ``pb * kh * kw`` entries and the
    columns' ``c * kh * kw``."""
    oh, ow = _out_size(h, kh, sh, ph), _out_size(w, kw, sw, pw)
    if oh < 1 or ow < 1:
        raise ValueError(f"im2col: a {kh}x{kw} window does not fit a padded {h}x{w} image")
    if kh * kw > csrc.TILE_FLOATS:
        raise ValueError(f"im2col: a {kh}x{kw} window is wider than the kernel's tile")
    taps = kh * kw
    ti, tj = min(oh, 8), min(ow, 16)
    while ((ti - 1) * sh + kh) * ((tj - 1) * sw + kw) > csrc.TILE_FLOATS:
        ti, tj = (ti, tj // 2) if tj > ti else (ti // 2, tj)
    tile = ((ti - 1) * sh + kh) * ((tj - 1) * sw + kw)
    tiles = -(-oh // ti) * -(-ow // tj)
    fits = [d for d in range(1, c + 1) if c % d == 0 and d * tile <= csrc.TILE_FLOATS]
    wide = [d for d in fits if n * (c // d) * tiles >= 2048]
    pb = max(wide) if wide else min([d for d in fits if d * taps >= 32] or fits[-1:])
    vec = next(v for v in (4, 2, 1) if pb * taps % v == 0 and c * taps % v == 0)
    blocks = n * (c // pb) * tiles
    if blocks > _MAX_UNITS:
        raise ValueError(f"im2col: {blocks} blocks exceed a 32-bit grid")
    return ColumnsGeometry(oh, ow, pb, ti, tj, vec, blocks)


class GatherGeometry(NamedTuple):
    """How col2im covers position-major columns: a block takes ``cb``
    channels of one image and ``th`` x ``tw`` pixels; ``blocks`` blocks."""
    cb: int
    th: int
    tw: int
    blocks: int


@functools.lru_cache(maxsize=4096)
def gather_geometry(n: int, c: int, h: int, w: int, kh: int, kw: int, sh: int,
                    sw: int) -> GatherGeometry:
    """col2im's tiles for the gradient of an (n, c, h, w) image's
    position-major columns, a (kh, kw) window at stride (sh, sw).

    A block stages the windows over its pixels, ``(th + kh - 2) // sh + 1``
    rows of ``(tw + kw - 2) // sw + 1``, each a run of ``cb * kh * kw``
    entries (``pitch``, the run made odd, apart), in ``csrc.GATHER_FLOATS``. Of
    the tiles that fit, the one that reads the fewest 32-byte sectors per
    pixel computed wins: the windows at the tile's edges are read by two
    blocks, and a short run wastes part of its sectors; a block of fewer
    than 256 pixels, or a grid of fewer than 528 blocks (four a
    multiprocessor), counts as that much dearer."""
    taps = kh * kw
    best = None
    for tw in sorted({min(w, t) for t in (64, 32, 16, 8, 4, 2, 1)}):
        for th in sorted({min(h, t) for t in (32, 16, 8, 4, 2, 1)}):
            pim, pjm = (th + kh - 2) // sh + 1, (tw + kw - 2) // sw + 1
            for cb in (d for d in range(1, c + 1) if c % d == 0):
                run = cb * taps
                if pim * pjm * (run | 1) > csrc.GATHER_FLOATS:
                    break
                blocks = n * (c // cb) * -(-h // th) * -(-w // tw)
                outputs = cb * th * tw
                sectors = pim * pjm * (-(-run * 4 // 32) + 1)
                cost = sectors / outputs * max(1.0, 256 / outputs) * max(1.0, 528 / blocks)
                if best is None or cost < best[0]:
                    best = (cost, GatherGeometry(cb, th, tw, blocks))
    if best is None:
        raise ValueError(f"col2im: a {kh}x{kw} window's entries outgrow the kernel's tile")
    if best[1].blocks > _MAX_UNITS:
        raise ValueError(f"col2im: {best[1].blocks} blocks exceed a 32-bit grid")
    return best[1]


# (kernel name) -> its C function, resolved at first use
_FUNCTIONS: Dict[str, Callable] = {}


def _function(name: str) -> Callable:
    fn = _FUNCTIONS.get(name)
    if fn is None:
        fn = _FUNCTIONS[name] = getattr(csrc.load(name), f"{name}_f32")
    return fn


def _check(name: str, t: torch.Tensor, dim: int) -> bool:
    """True for a CUDA tensor the kernel takes, False for a CPU tensor;
    raises on anything else."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: CUDA kernel takes float32, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: CUDA kernel takes a {dim}-d tensor, got {tuple(t.shape)}")
    return True


def _call(name: str, src: torch.Tensor, dst: torch.Tensor, args: csrc.ColumnsArgs) -> None:
    index = src.get_device()
    err = _function(name)(src.data_ptr(), dst.data_ptr(), ctypes.byref(args), index,
                          torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def _position_major(cols: torch.Tensor) -> torch.Tensor:
    """(n, K, L) columns with each position's K entries together: ``cols``
    itself where they are, else a copy."""
    if cols.stride(1) == 1 or cols.shape[1] == 1:
        return cols
    return cols.mT.contiguous().mT


def im2col_launch(x: torch.Tensor, kernel, stride, padding):
    """The columns (n, c * kh * kw, oh * ow), allocated position-major, and
    the kernel's arguments for ``x``; None where the columns are empty."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    n, c, h, w = x.shape
    geo = columns_geometry(n, c, h, w, kh, kw, sh, sw, ph, pw)
    cols = torch.empty((n, geo.oh * geo.ow, c * kh * kw), dtype=x.dtype, device=x.device).mT
    if cols.numel() == 0:
        return cols, None
    if cols.data_ptr() % (4 * geo.vec):
        raise ValueError("im2col: the columns are not aligned to the kernel's stores")
    xs, gs = x.stride(), cols.stride()
    return cols, csrc.ColumnsArgs(
        planes=n * c, c=c, h=h, w=w, xs_n=xs[0], xs_c=xs[1], xs_h=xs[2], xs_w=xs[3],
        gs_n=gs[0], gs_k=gs[1], gs_l=gs[2], kh=kh, kw=kw, sh=sh, sw=sw, ph=ph, pw=pw,
        oh=geo.oh, ow=geo.ow, pb=geo.pb, ti=geo.ti, tj=geo.tj, vec=geo.vec, blocks=geo.blocks)


def col2im_launch(g: torch.Tensor, size, kernel, stride, padding):
    """The image gradient, allocated, and the kernel's arguments for ``g``,
    position-major (:func:`gather_geometry`'s tiles); None where the image
    is empty."""
    (kh, kw), (sh, sw), (ph, pw), (h, w) = kernel, stride, padding, size
    n, rows, _ = g.shape
    c = rows // (kh * kw)
    dx = torch.empty((n, c, h, w), dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx, None
    geo = gather_geometry(n, c, h, w, kh, kw, sh, sw)
    gs = g.stride()
    # the most windows over a pixel along an axis: the kernel's unrolled
    # loads; 0 (loops) above 5
    nw = max(-(-kh // sh), -(-kw // sw))
    return dx, csrc.ColumnsArgs(
        planes=n * c, c=c, h=h, w=w, gs_n=gs[0], gs_k=gs[1], gs_l=gs[2], kh=kh, kw=kw, sh=sh,
        sw=sw, ph=ph, pw=pw, oh=_out_size(h, kh, sh, ph), ow=_out_size(w, kw, sw, pw),
        pb=geo.cb, ti=geo.th, tj=geo.tw, vec=nw if nw <= 5 else 0, blocks=geo.blocks)


def _im2col(x: torch.Tensor, kernel, stride, padding) -> torch.Tensor:
    if not _check("im2col", x, 4):
        return _position_major(im2col_plain(x, kernel, stride, padding))
    cols, args = im2col_launch(x, kernel, stride, padding)
    if args is not None:
        _call("im2col", x, cols, args)
    return cols


def _col2im(g: torch.Tensor, size, kernel, stride, padding) -> torch.Tensor:
    if not _check("col2im", g, 3):
        return col2im_plain(g, size, kernel, stride, padding)
    g = _position_major(g)
    dx, args = col2im_launch(g, size, kernel, stride, padding)
    if args is not None:
        _call("col2im", g, dx, args)
    return dx


class _Im2col(torch.autograd.Function):
    """:func:`im2col`; its backward is :class:`_Col2im`."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding):
        ctx.geometry = (tuple(x.shape[2:]), kernel, stride, padding)
        return _im2col(x, kernel, stride, padding)

    @staticmethod
    def backward(ctx, g):
        return _Col2im.apply(g, *ctx.geometry), None, None, None


class _Col2im(torch.autograd.Function):
    """:func:`col2im`; its backward is :class:`_Im2col` (the adjoint of the
    adjoint), so a double backward launches the im2col kernel."""

    @staticmethod
    def forward(ctx, g, size, kernel, stride, padding):
        ctx.geometry = (kernel, stride, padding)
        return _col2im(g, size, kernel, stride, padding)

    @staticmethod
    def backward(ctx, gg):
        return _Im2col.apply(gg, *ctx.geometry), None, None, None, None


def im2col(x: torch.Tensor, kernel, stride=1, padding=0) -> torch.Tensor:
    """:func:`im2col_plain`'s columns (n, c * kh * kw, oh * ow), laid out
    position-major (strides (.., 1, c * kh * kw)): the hand-written kernel on
    a float32 CUDA tensor, the plain version on a CPU one. A 1x1 window at
    stride 1 without padding over a contiguous image is a view of it,
    row-major, with no launch."""
    kernel, stride, padding = _pair(kernel), _pair(stride), _pair(padding)
    if kernel == stride == (1, 1) and padding == (0, 0) and x.is_contiguous():
        n, c, h, w = x.shape
        return x.reshape(n, c, h * w)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Im2col.apply(x, kernel, stride, padding)
    return _im2col(x, kernel, stride, padding)


def col2im(g: torch.Tensor, size, kernel, stride=1, padding=0) -> torch.Tensor:
    """:func:`col2im_plain`'s image gradient from columns ``g`` of any
    layout: the hand-written kernel on a float32 CUDA tensor (``g`` copied
    position-major first where it is not), the plain version on a CPU one.
    Its derivative writes position-major columns."""
    size, kernel = tuple(size), _pair(kernel)
    stride, padding = _pair(stride), _pair(padding)
    if torch.is_grad_enabled() and g.requires_grad:
        return _Col2im.apply(g, size, kernel, stride, padding)
    return _col2im(g, size, kernel, stride, padding)


# ------------------------------------------------------------ the convolution


def conv2d_gemm(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1,
                padding=0, groups: int = 1) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, padding, groups=groups)`` as
    :func:`im2col` and one matmul per image and group."""
    n, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    cols = im2col(x, (kh, kw), (sh, sw), (ph, pw))  # (n, c * kh * kw, oh * ow)
    oh, ow = _out_size(h, kh, sh, ph), _out_size(w, kw, sw, pw)
    if groups == 1:
        # (o, K) @ (n, K, L). The grouped form below costs an ungrouped conv
        # more: its 4-D broadcast adds a batch reduction to the weight
        # gradient (~5 ms of a 95 ms float32 train step on an H100)
        y = weight.reshape(o, -1) @ cols
    else:
        cols = cols.reshape(n, groups, c // groups * kh * kw, oh * ow)
        y = weight.reshape(groups, o // groups, -1) @ cols  # (n, groups, o / groups, L)
    y = y.reshape(n, o, oh * ow)
    if bias is not None:
        y = y + bias[:, None]
    return y.reshape(n, o, oh, ow)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1,
           padding=0, groups: int = 1) -> torch.Tensor:
    """``F.conv2d``, through :func:`conv2d_gemm` for float32 CUDA tensors
    while autograd records."""
    if GEMM_FLOAT32 and x.is_cuda and x.dtype == torch.float32 and torch.is_grad_enabled():
        return conv2d_gemm(x, weight, bias, stride, padding, groups)
    return F.conv2d(x, weight, bias, stride, padding, groups=groups)
