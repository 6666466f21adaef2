// Shared by the package's kernels: vector accesses of raw elements, and the
// conversions between raw elements and float. A thread moves N consecutive
// elements as accesses of L elements each; the wrapper (ops/blur.py,
// launch_geometry) keeps every access aligned to its size.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // per block; ops/blur.py sizes the grid for it

template <int BYTES> struct Word;
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

// N consecutive raw elements, moved as accesses of L elements each
// (L * sizeof(R) bytes, aligned to that)
template <int L, typename R, int N>
__device__ __forceinline__ void load_raw(const R* p, R (&out)[N]) {
  using W = typename Word<sizeof(R) * L>::type;
#pragma unroll
  for (int i = 0; i < N; i += L) {
    union { W w; R r[L]; } u;
    u.w = __ldg(reinterpret_cast<const W*>(p + i));
#pragma unroll
    for (int k = 0; k < L; ++k) out[i + k] = u.r[k];
  }
}

template <int L, typename R, int N>
__device__ __forceinline__ void store_raw(R* p, const R (&in)[N]) {
  using W = typename Word<sizeof(R) * L>::type;
#pragma unroll
  for (int i = 0; i < N; i += L) {
    union { W w; R r[L]; } u;
#pragma unroll
    for (int k = 0; k < L; ++k) u.r[k] = in[i + k];
    *reinterpret_cast<W*>(p + i) = u.w;
  }
}

// raw element <-> float: float is itself, bfloat16 its 16-bit pattern
__device__ __forceinline__ float to_f(float r) { return r; }
__device__ __forceinline__ float to_f(unsigned short r) {
  return __bfloat162float(__ushort_as_bfloat16(r));
}
__device__ __forceinline__ void from_f(float v, float& r) { r = v; }
__device__ __forceinline__ void from_f(float v, unsigned short& r) {
  r = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

}  // namespace
