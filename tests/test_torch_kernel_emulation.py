"""The CUDA sources' thread-to-element map and arithmetic, run on the CPU.

There is no ``nvcc`` and no GPU on a CPU test host, so ``csrc/*.cu`` are
compiled here by the host's C++ compiler against a small header that stands
in for the few CUDA names the kernels use: the grid is walked by two loops,
or, for a kernel that synchronises its block, each block's threads run as
coroutines that switch at every ``__syncthreads`` (shared memory is a static
array, an asynchronous copy to it a copy at once); ``__ldg`` is a load that
counts misaligned accesses, the round-to-nearest float intrinsics are float
operations with contraction off, and bfloat16 is its bit pattern with
round-to-nearest-even. Each resampling kernel is launched through its C entry
point with the wrapper's own launch geometry (``ops.blur.launch_geometry``)
and held bit for bit against its plain PyTorch version, float32 and
bfloat16, at small, ragged and odd shapes and on an input one element into
its storage; the convolution's column kernels with the arguments
``ops.conv`` builds (``im2col_launch``, ``col2im_launch``), float32,
against ``im2col_plain`` and ``col2im_plain`` at the step's kinds of window,
with the wrapper's tiles and with the smallest ones (one channel a block,
tiles ragged at the edges), and strided inputs; the classifiers' batch norm
(``csrc/frozen_bn.cu``) through ``ops.frozen_bn.launch``, float32 and
bfloat16, at every batch norm of MobileNetV2 at 64 and 256 px, at ragged
planes, channels-last and misaligned inputs and NaN and infinite values,
against ``frozen_bn_plain``.
It shows the sources'
indexing, edge handling and order of operations, not that ``nvcc`` accepts
them or how fast they run: that is ``chip_smoke.py``'s work on the card. Skips where no C++ compiler is found.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from stylex_tpu_torch import csrc
from stylex_tpu_torch.ops import blur as tblur
from stylex_tpu_torch.ops import conv as tconv
from stylex_tpu_torch.ops import frozen_bn as tbn

CSRC = Path(csrc.__file__).resolve().parent

STUB = r"""
#pragma once
#include <cstdint>
#include <cstring>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__ __restrict
#define __shared__ static
#include <algorithm>
#include <cmath>
#include <functional>
#include <vector>
#include <ucontext.h>
using std::min;
struct uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaSetDevice(int) { return 0; }
inline int cudaGetLastError() { return 0; }
struct Index { unsigned x; };
static Index blockIdx, blockDim, threadIdx;
static long long misaligned = 0;
extern "C" long long misaligned_loads() { return misaligned; }
template <class T> T __ldg(const T* p) {
  if (reinterpret_cast<uintptr_t>(p) % sizeof(T)) ++misaligned;
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
// cp.async: the copy done at once, the commit and the wait nothing
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
struct __nv_bfloat16 { unsigned short x; };
inline __nv_bfloat16 __ushort_as_bfloat16(unsigned short r) { return {r}; }
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
// a block's threads as coroutines: each round runs every thread on to its
// next __syncthreads (or its end), so no thread passes a barrier before all
// have reached it
struct Fiber { ucontext_t ctx; std::vector<char> stack; bool done; };
static ucontext_t fiber_main;
static std::vector<Fiber>* fibers;
static unsigned fiber_now;
static std::function<void()>* fiber_body;
static void fiber_entry() {
  (*fiber_body)();
  (*fibers)[fiber_now].done = true;
  swapcontext(&(*fibers)[fiber_now].ctx, &fiber_main);
}
inline void __syncthreads() { swapcontext(&(*fibers)[fiber_now].ctx, &fiber_main); }
template <class F> void run_grid(unsigned grid, unsigned threads, F body) {
  std::function<void()> fn(body);
  std::vector<Fiber> fs(threads);
  fibers = &fs;
  fiber_body = &fn;
  blockDim.x = threads;
  for (auto& f : fs) f.stack.resize(1 << 16);
  for (blockIdx.x = 0; blockIdx.x < grid; ++blockIdx.x) {
    for (auto& f : fs) {
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.data();
      f.ctx.uc_stack.ss_size = f.stack.size();
      f.ctx.uc_link = nullptr;
      makecontext(&f.ctx, fiber_entry, 0);
      f.done = false;
    }
    for (bool left = true; left;) {
      left = false;
      for (unsigned t = 0; t < threads; ++t) {
        if (fs[t].done) continue;
        fiber_now = t;
        threadIdx.x = t;
        swapcontext(&fiber_main, &fs[t].ctx);
        left = left || !fs[t].done;
      }
    }
  }
}
"""

# kernel<...><<<grid, threads, ...>>>(args); -> the grid walked by two loops, or
# by run_grid's coroutines where the source synchronises its blocks
LAUNCH = re.compile(r"(\w+(?:<[^;<>]*>)?)<<<([^,]+),\s*([^,]+),[^>]*>>>(\([^;]*\));")
CUDA_INCLUDES = "#include <cuda_runtime.h>\n#include <cuda_bf16.h>\n"


def _host_source(text: str) -> str:
    text = text.replace(CUDA_INCLUDES, '#include "cuda_stub.h"\n')
    text = text.replace("#include <cuda_pipeline.h>\n", "")
    if "__syncthreads" in text:
        return LAUNCH.sub(r"run_grid((unsigned)(\2), (unsigned)(\3), [&]() { \1\4; });", text)
    return LAUNCH.sub(r"blockDim.x = (\3); for (blockIdx.x = 0; blockIdx.x < (unsigned)(\2); "
                      r"++blockIdx.x) for (threadIdx.x = 0; threadIdx.x < blockDim.x; "
                      r"++threadIdx.x) \1\4;", text)


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel sources for the CPU")
    out = tmp_path_factory.mktemp("kernels")
    (out / "cuda_stub.h").write_text(STUB)
    for header in CSRC.glob("*.cuh"):
        (out / header.name).write_text(_host_source(header.read_text()))
    libs = {}
    for name, (source, functions) in csrc.KERNELS.items():
        src = out / Path(source).with_suffix(".cpp").name
        if not src.exists():
            text = (CSRC / source).read_text()
            assert len(LAUNCH.findall(text)) == 1, f"{source}: expected one kernel launch"
            src.write_text(_host_source(text))
        lib = src.with_suffix(".so")
        if not lib.exists():
            subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                            *csrc.DEFINES, "-o", str(lib), str(src)], check=True,
                           capture_output=True, text=True)
        libs[name] = ctypes.CDLL(str(lib))
        for fn in functions:
            getattr(libs[name], fn).argtypes = csrc.ARGTYPES[name]
            getattr(libs[name], fn).restype = ctypes.c_int
    return libs


def _run_kernel(lib, name, x):
    """The wrapper's launch sequence (``ops.blur._launch``) on the host."""
    n, c, h, w = x.shape
    out_shape = {"upsample2x_bilinear": (n, c, 2 * h, 2 * w), "blur3": (n, c, h, w),
                 "blur3_downsample2x": (n, c, h // 2, w // 2)}[name]
    y = torch.full(out_shape, float("nan"), dtype=x.dtype)
    size = x.element_size()
    fn = getattr(lib, f"{name}_{tblur._SUFFIX[x.dtype]}")
    vec, _, _, launches = tblur.launch_geometry(name, n * c, h, w, size, x.data_ptr() % 16,
                                                y.data_ptr() % 16)
    for p0, planes, blocks in launches:
        err = fn(x.data_ptr() + p0 * h * w * size,
                 y.data_ptr() + p0 * out_shape[2] * out_shape[3] * size,
                 planes, h, w, vec, blocks, 0, None)
        assert err == 0
    return y


SHAPES = {
    "upsample2x_bilinear": [(2, 3, 4, 4), (3, 5, 8, 8), (1, 3, 16, 16), (1, 2, 32, 32),
                            (2, 3, 4, 1), (2, 3, 4, 2), (2, 3, 3, 5), (2, 3, 1, 4),
                            (2, 3, 1, 1), (1, 2, 5, 12), (1, 2, 128, 128), (1, 2, 3, 128),
                            (1, 2, 128, 3)],
    "blur3": [(3, 3, 8, 8), (2, 3, 16, 16), (1, 3, 64, 64), (2, 5, 4, 4), (2, 3, 2, 2),
              (2, 3, 5, 7), (2, 3, 2, 6), (2, 3, 7, 3), (1, 1, 3, 20)],
    "blur3_downsample2x": [(2, 3, 64, 64), (2, 4, 4, 4), (2, 3, 2, 2), (2, 3, 6, 10),
                           (2, 3, 4, 12), (1, 1, 2, 16)],
}


@pytest.mark.parametrize("name,shape", [(n, s) for n, shapes in SHAPES.items() for s in shapes])
def test_kernel_source_matches_plain_version(libraries, name, shape):
    lib = libraries[name]
    plain = getattr(tblur, f"{name}_plain")
    rng = np.random.RandomState(sum(shape))
    for dtype in (torch.float32, torch.bfloat16):
        for offset in (0, 1):  # aligned, and one element into the storage
            numel = int(np.prod(shape))
            buf = torch.from_numpy(rng.randn(numel + offset).astype(np.float32)).to(dtype)
            x = buf[offset:].view(shape)
            before = lib.misaligned_loads()
            got = _run_kernel(lib, name, x)
            assert lib.misaligned_loads() == before, "a vector load was not aligned to its size"
            want = plain(x)
            assert torch.equal(got, want), (dtype, offset, (got.float() - want.float()).abs().max())


# (image shape, kernel, stride, padding, view): the step's kinds of window
# (3x3 stride 1 and 2, the fused downsample's 5x5 stride 2 unpadded, 1x1
# stride 2 and 1), odd and tiny planes, a wide plane, many channels, inputs
# seen through a slice, a transpose and a broadcast, and 7x7 windows (col2im
# unrolled over 4 windows an axis at stride 2, looped at stride 1)
COLUMN_CASES = [
    ((2, 3, 8, 10), 3, 1, 1, None), ((2, 3, 9, 7), 3, 2, 1, None), ((1, 2, 13, 13), 5, 2, 0, None),
    ((2, 4, 8, 8), 1, 2, 0, None), ((2, 3, 5, 6), 1, 1, 0, "slice"), ((1, 2, 7, 5), 5, 1, 2, None),
    ((2, 3, 2, 2), 3, 1, 1, None), ((1, 1, 3, 1400), 3, 1, 1, None),
    ((2, 2048, 4, 4), 3, 1, 1, None),
    ((2, 3, 9, 12), 3, 1, 1, "slice"), ((2, 3, 8, 8), 3, 2, 1, "transpose"),
    ((2, 3, 6, 6), 3, 1, 1, "broadcast"), ((1, 2, 6, 9), (3, 1), (2, 1), (1, 0), None),
    ((1, 2, 9, 10), 7, 2, 3, None), ((1, 2, 9, 10), 7, 1, 3, None),
]


def _column_input(shape, view, seed):
    rng = np.random.RandomState(seed)
    if view == "slice":  # every other row and a column cut off: strides (.., 2w+2, 1)
        n, c, h, w = shape
        big = torch.from_numpy(rng.randn(n, c, 2 * h, w + 2).astype(np.float32))
        return big[:, :, ::2, 1:w + 1]
    if view == "transpose":
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).transpose(2, 3)
    if view == "broadcast":
        return torch.from_numpy(rng.randn(shape[0], 1, *shape[2:]).astype(np.float32)).expand(shape)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("small_tiles", [False, True])
@pytest.mark.parametrize("shape,k,s,p,view", COLUMN_CASES)
def test_column_kernel_sources_match_plain_versions(libraries, shape, k, s, p, view,
                                                    small_tiles):
    """im2col from the image and col2im from a gradient of the columns, each
    through the C entry point with the wrapper's arguments (or the smallest
    tiles), bit for bit against the plain versions; col2im from a
    position-major gradient, a row-major one folded as the wrapper folds it,
    and a -0.0 gradient, whose sign unfold_backward keeps only where it
    copies."""
    k, s, p = tconv._pair(k), tconv._pair(s), tconv._pair(p)
    x = _column_input(shape, view, seed=sum(shape))
    n, c, h, w = x.shape
    cols, args = tconv.im2col_launch(x, k, s, p)
    if small_tiles:
        args.pb, args.ti, args.tj, args.vec = 1, min(args.ti, 3), min(args.tj, 5), 1
        args.blocks = n * c * -(-args.oh // args.ti) * -(-args.ow // args.tj)
    cols.fill_(float("nan"))
    before = libraries["im2col"].misaligned_loads()
    assert libraries["im2col"].im2col_f32(x.data_ptr(), cols.data_ptr(), ctypes.byref(args),
                                          0, None) == 0
    assert libraries["im2col"].misaligned_loads() == before
    want = tconv.im2col_plain(x, k, s, p)
    assert cols.shape == want.shape
    assert cols.stride()[1:] == (1, cols.shape[1])  # position-major
    assert torch.equal(cols, want), (cols - want).abs().max()

    rng = np.random.RandomState(sum(shape) + 1)
    g = torch.from_numpy(rng.randn(*want.shape).astype(np.float32))
    for grad in (g.mT.contiguous().mT, g, torch.full_like(g, -0.0)):
        grad = tconv._position_major(grad)
        dx, args = tconv.col2im_launch(grad, (h, w), k, s, p)
        if small_tiles:
            args.pb, args.ti, args.tj = 1, min(args.ti, 3), min(args.tj, 5)
            args.blocks = n * c * -(-h // args.ti) * -(-w // args.tj)
        dx.fill_(float("nan"))
        assert libraries["col2im"].col2im_f32(grad.data_ptr(), dx.data_ptr(), ctypes.byref(args),
                                              0, None) == 0
        want = tconv.col2im_plain(grad, (h, w), k, s, p)
        assert torch.equal(dx, want), (dx - want).abs().max()
        assert torch.equal(torch.signbit(dx), torch.signbit(want))


def _bn_operands(shape, residual: bool, seed: int, dtype=torch.float32, offset: int = 0):
    """y (``offset`` elements into its storage), its residual or None, and
    the channels' mean, scale (rsqrt(var + eps) * weight in ``dtype``, as
    the module computes it) and bias; y spread wide enough to reach both
    clamps."""
    rng = np.random.RandomState(seed)
    c = shape[1]
    numel = int(np.prod(shape))

    def draw(*size, spread=1.0, shift=0.0):
        return torch.from_numpy((spread * rng.randn(*size) + shift).astype(np.float32)).to(dtype)

    y = draw(numel + offset, spread=3.0)[offset:].view(shape)
    res = draw(*shape) if residual else None
    mean, var = draw(c), torch.from_numpy(rng.rand(c).astype(np.float32) + 0.25).to(dtype)
    weight, bias = draw(c), draw(c)
    return y, res, mean, torch.rsqrt(var + 1e-5) * weight, bias


def _bn_check(lib, y, res, mean, scale, bias, relu6, nan=False):
    before = lib.misaligned_loads()
    fn = getattr(lib, f"frozen_bn_{tbn._SUFFIX[y.dtype]}")
    got = tbn.launch(fn, y, mean, scale, bias, res, relu6, 0, None)
    assert lib.misaligned_loads() == before, "a vector load was not aligned to its size"
    want = tbn.frozen_bn_plain(y, mean, scale, bias, res, relu6)
    assert got.dtype == want.dtype and got.shape == want.shape
    if nan:  # NaN where the chain gives NaN, every other value equal
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    else:
        assert torch.equal(got, want), (got.float() - want.float()).abs().max()


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size,batch", [(64, 2), (256, 1)])
def test_frozen_bn_source_matches_plain_chain_at_mobilenet_shapes(libraries, size, batch,
                                                                  dtype):
    """Every batch norm of one MobileNetV2 forward, with its ReLU6 and its
    residual as the network hands them over, bit for bit."""
    import sys

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from chip_smoke import batch_norm_calls

    calls = batch_norm_calls((batch, 3, size, size))
    assert len(calls) == 52
    for i, (shape, relu6, residual) in enumerate(sorted(set(calls))):
        _bn_check(libraries["frozen_bn"], *_bn_operands(shape, residual, i, dtype), relu6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 3, 5, 7), (2, 5, 1, 1), (3, 4, 3, 3),
                                   (2, 6, 2, 3), (1, 2, 16, 16)])
@pytest.mark.parametrize("offset", [0, 1])
def test_frozen_bn_source_matches_plain_chain_at_ragged_planes(libraries, shape, offset, dtype):
    """Planes whose H * W is no multiple of the vector (each element its own
    channel, the tail one at a time), and an input one element into its
    storage (scalar accesses)."""
    for relu6 in (False, True):
        for residual in (False, True):
            _bn_check(libraries["frozen_bn"],
                      *_bn_operands(shape, residual, sum(shape), dtype, offset), relu6)


@pytest.mark.parametrize("shape", [(3, 5, 4, 4), (2, 3, 5, 7), (4, 3, 1, 2)])
def test_frozen_bn_source_channels_last(libraries, shape):
    """A channels-last input (the channel fastest in memory) keeps its
    layout, with a residual in either layout."""
    for dtype in DTYPES:
        y, res, mean, scale, bias = _bn_operands(shape, True, 3, dtype)
        y = y.contiguous(memory_format=torch.channels_last)
        for r in (res, res.contiguous(memory_format=torch.channels_last)):
            _bn_check(libraries["frozen_bn"], y, r, mean, scale, bias, True)
        got = tbn.launch(libraries["frozen_bn"].frozen_bn_f32 if dtype == torch.float32 else
                         libraries["frozen_bn"].frozen_bn_bf16, y, mean, scale, bias, None,
                         False, 0, None)
        assert got.stride() == y.stride()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 4, 8, 8), (2, 3, 5, 7)])
def test_frozen_bn_source_propagates_nan_and_inf(libraries, shape, dtype):
    """NaN and both infinities in y and in the residual, and a channel whose
    scale is 0 (inf * 0): NaN where the chain gives NaN, the clamp's 0 and 6
    for the infinities."""
    y, res, mean, scale, bias = _bn_operands(shape, True, 7, dtype)
    flat, rflat = y.view(-1), res.view(-1)
    flat[::5] = float("nan")
    flat[1::7] = float("inf")
    flat[2::7] = -float("inf")
    rflat[3::11] = float("inf")
    rflat[4::13] = float("nan")
    scale[1] = 0.0
    for relu6 in (False, True):
        for r in (None, res):
            _bn_check(libraries["frozen_bn"], y, r, mean, scale, bias, relu6, nan=True)
