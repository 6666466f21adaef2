// Bilinear 2x upsample, half-pixel centres, edge clamp (NCHW, contiguous).
//
// Replaces the Pallas kernels upsample2x_bilinear_pallas_batched and
// upsample2x_bilinear_pallas (stylex_tpu/ops/pallas_upsample.py): the same
// function, for every batch and spatial size. Along each axis
//
//     out[2i]   = 0.25 * x[i-1] + 0.75 * x[i]      (i-1 clamped to 0)
//     out[2i+1] = 0.75 * x[i]   + 0.25 * x[i+1]    (i+1 clamped to n-1)
//
// rows first, then columns, as the Pallas kernel orders them.
//
// Bound on this card: bytes. Each output element costs 6 multiply-adds and
// the op reads B*C*H*W and writes 4*B*C*H*W elements, so the least time is
// 5*B*C*H*W*itemsize over the memory rate; the arithmetic is far below the
// card's rate.
//
// Design: one thread per output element in a grid-stride loop with 64-bit
// indexing (a sweep chunk holds more than 1e8 elements). Neighbouring threads
// write neighbouring output columns, so stores coalesce; the four input taps
// of a 2x2 output quad are the same elements, which L1 serves. Arithmetic is
// in float with explicit round-to-nearest operations (no fused multiply-add),
// so the float result equals the plain PyTorch version bit for bit and the
// bfloat16 result is that float value rounded once. Shared-memory tiles and
// 16-byte vector stores are left for later work.

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

// one tap pair: w_near * near + w_cur * cur, each product and the sum
// rounded separately, as two PyTorch elementwise ops round them
__device__ __forceinline__ float tap2(float w_a, float a, float w_b, float b) {
  return __fadd_rn(__fmul_rn(w_a, a), __fmul_rn(w_b, b));
}

template <typename T>
__global__ void upsample2x_bilinear_kernel(const T* __restrict__ x, T* __restrict__ y,
                                           int64_t planes, int h, int w) {
  const int oh = 2 * h, ow = 2 * w;
  const int64_t plane_out = (int64_t)oh * ow;
  const int64_t total = planes * plane_out;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const int64_t p = idx / plane_out;
    const int rem = (int)(idx - p * plane_out);
    const int oy = rem / ow;
    const int ox = rem - oy * ow;
    const int iy = oy >> 1, ix = ox >> 1;
    const int ny = (oy & 1) ? min(iy + 1, h - 1) : max(iy - 1, 0);
    const int nx = (ox & 1) ? min(ix + 1, w - 1) : max(ix - 1, 0);
    const T* xp = x + p * h * (int64_t)w;
    // rows: 0.75 on the centre row, 0.25 on the neighbour row
    const float r_c = tap2(0.25f, load_f(xp + (int64_t)ny * w + ix), 0.75f,
                           load_f(xp + (int64_t)iy * w + ix));
    const float r_n = tap2(0.25f, load_f(xp + (int64_t)ny * w + nx), 0.75f,
                           load_f(xp + (int64_t)iy * w + nx));
    // columns: the same weights across the two row results
    store_f(y + idx, tap2(0.25f, r_n, 0.75f, r_c));
  }
}

template <typename T>
int launch(const void* x, void* y, long long planes, int h, int w, int max_blocks,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long total = planes * 4LL * h * w;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  upsample2x_bilinear_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)y, (int64_t)planes, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int upsample2x_bilinear_f32(const void* x, void* y, long long planes, int h,
                                       int w, int max_blocks, int device, void* stream) {
  return launch<float>(x, y, planes, h, w, max_blocks, device, stream);
}

extern "C" int upsample2x_bilinear_bf16(const void* x, void* y, long long planes, int h,
                                        int w, int max_blocks, int device, void* stream) {
  return launch<__nv_bfloat16>(x, y, planes, h, w, max_blocks, device, stream);
}
