"""The CUDA sources' thread-to-element map and arithmetic, run on the CPU.

There is no ``nvcc`` and no GPU on a CPU test host, so ``csrc/*.cu`` are
compiled here by the host's C++ compiler against a small header that stands
in for the few CUDA names the kernels use: the grid is walked by two loops,
``__ldg`` is a load that counts misaligned accesses, the round-to-nearest
float intrinsics are float operations with contraction off, and bfloat16 is
its bit pattern with round-to-nearest-even. Each kernel is launched through
its C entry point with the wrapper's own launch geometry
(``ops.blur.launch_geometry``) and held bit for bit against its plain
PyTorch version, float32 and bfloat16, at small, ragged and odd shapes and
on an input one element into its storage. It shows the sources' indexing,
edge handling and order of operations, not that ``nvcc`` accepts them or
how fast they run: that is ``chip_smoke.py``'s work on the card. Skips
where no C++ compiler is found.
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
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
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
"""

# kernel<...><<<grid, threads, ...>>>(args) -> the grid walked by two loops
LAUNCH = re.compile(r"(\w+<[^;<>]*>)<<<([^,]+),\s*([^,]+),[^>]*>>>")
CUDA_INCLUDES = "#include <cuda_runtime.h>\n#include <cuda_bf16.h>\n"


def _host_source(text: str) -> str:
    text = text.replace(CUDA_INCLUDES, '#include "cuda_stub.h"\n')
    return LAUNCH.sub(r"blockDim.x = (\3); for (blockIdx.x = 0; blockIdx.x < (unsigned)(\2); "
                      r"++blockIdx.x) for (threadIdx.x = 0; threadIdx.x < blockDim.x; "
                      r"++threadIdx.x) \1", text)


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
                            "-o", str(lib), str(src)], check=True, capture_output=True, text=True)
        libs[name] = ctypes.CDLL(str(lib))
        for fn in functions:
            getattr(libs[name], fn).argtypes = csrc._ARGTYPES
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
