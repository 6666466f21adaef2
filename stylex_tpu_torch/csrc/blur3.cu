// 3x3 binomial blur [1,2,1] x [1,2,1] / 16 with reflect padding (NCHW,
// contiguous, H and W at least 2), and the same blur fused with 2x
// decimation (even H and W), which keeps the even rows and columns.
//
// Replaces the Pallas kernels blur3_pallas and blur3_downsample2x_pallas
// (stylex_tpu/ops/pallas_blur.py, both via _blur_call, with down=False and
// down=True). Reflect indexing: row -1 reads row 1 and row H reads row H-2,
// likewise for columns. The vertical pass runs first, then the horizontal
// one, each as (0.25*lo + 0.5*mid) + 0.25*hi, which is the order of the JAX
// package's blur3_xla and of the plain PyTorch versions.
//
// Bound on this card: bytes. The blur reads and writes B*C*H*W elements, so
// the least time is 2*B*C*H*W*itemsize over the memory rate; the decimating
// blur reads B*C*H*W and writes a quarter of that, 1.25*B*C*H*W*itemsize.
// 9 multiply-adds per output are far below the card's arithmetic rate.
//
// Design: one thread per output element in a grid-stride loop with 64-bit
// indexing. Each thread reads its 3x3 reflect-indexed neighbourhood; the
// nine reads of neighbouring threads overlap, which L1 serves, so device
// memory sees each element about once. The decimating variant (DOWN) maps
// output (r, c) to input centre (2r, 2c) and writes only the kept outputs:
// the full-resolution blur never reaches device memory. Arithmetic is in
// float with explicit round-to-nearest operations (no fused multiply-add):
// the float result equals the plain version bit for bit, and the bfloat16
// result is that float value rounded once. Shared-memory tiles with a halo
// and vector loads are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// (0.25*lo + 0.5*mid) + 0.25*hi with every operation rounded on its own
__device__ __forceinline__ float tap3(float lo, float mid, float hi) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, lo), __fmul_rn(0.5f, mid)),
                   __fmul_rn(0.25f, hi));
}

// h, w: input size; the output is (h, w), or (h/2, w/2) when DOWN
template <typename T, bool DOWN>
__global__ void blur3_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t planes,
                             int h, int w) {
  const int ho = DOWN ? h / 2 : h, wo = DOWN ? w / 2 : w;
  const int64_t in_plane = (int64_t)h * w;
  const int64_t out_plane = (int64_t)ho * wo;
  const int64_t total = planes * out_plane;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const int64_t p = idx / out_plane;
    const int rem = (int)(idx - p * out_plane);
    const int ro = rem / wo;
    const int co = rem - ro * wo;
    const int r = DOWN ? 2 * ro : ro, c = DOWN ? 2 * co : co;
    const T* xp = x + p * in_plane;
    const T* row_lo = xp + (int64_t)reflect(r - 1, h) * w;
    const T* row_mid = xp + (int64_t)r * w;
    const T* row_hi = xp + (int64_t)reflect(r + 1, h) * w;
    const int cl = reflect(c - 1, w), cr = reflect(c + 1, w);
    const float v_l = tap3(load_f(row_lo + cl), load_f(row_mid + cl), load_f(row_hi + cl));
    const float v_c = tap3(load_f(row_lo + c), load_f(row_mid + c), load_f(row_hi + c));
    const float v_r = tap3(load_f(row_lo + cr), load_f(row_mid + cr), load_f(row_hi + cr));
    store_f(y + idx, tap3(v_l, v_c, v_r));
  }
}

template <typename T, bool DOWN>
int launch(const void* x, void* y, long long planes, int h, int w, int max_blocks,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long total = planes * (long long)(DOWN ? h / 2 : h) * (DOWN ? w / 2 : w);
  long long blocks = (total + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  blur3_kernel<T, DOWN><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)y, (int64_t)planes, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int blur3_f32(const void* x, void* y, long long planes, int h, int w,
                         int max_blocks, int device, void* stream) {
  return launch<float, false>(x, y, planes, h, w, max_blocks, device, stream);
}

extern "C" int blur3_bf16(const void* x, void* y, long long planes, int h, int w,
                          int max_blocks, int device, void* stream) {
  return launch<__nv_bfloat16, false>(x, y, planes, h, w, max_blocks, device, stream);
}

extern "C" int blur3_downsample2x_f32(const void* x, void* y, long long planes, int h, int w,
                                      int max_blocks, int device, void* stream) {
  return launch<float, true>(x, y, planes, h, w, max_blocks, device, stream);
}

extern "C" int blur3_downsample2x_bf16(const void* x, void* y, long long planes, int h,
                                       int w, int max_blocks, int device, void* stream) {
  return launch<__nv_bfloat16, true>(x, y, planes, h, w, max_blocks, device, stream);
}
