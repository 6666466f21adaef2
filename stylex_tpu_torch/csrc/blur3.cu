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
// 9 multiply-adds per output are far below the card's arithmetic rate; what
// keeps a kernel from the bytes bound here is index math and narrow accesses.
//
// Design: one thread per segment of V output columns of one output row of
// one plane. It loads the three reflect-indexed input rows over the
// segment's input columns as one vector each (V columns, or 2V for the
// decimating blur), plus the reflect-indexed column on either side (L1 hits:
// the neighbouring thread loads them in its vector), runs the vertical pass
// once per column, then the horizontal pass, and writes its V outputs with
// one store. The decimating variant (DOWN) reads rows 2r-1, 2r, 2r+1 and
// input columns 2c0-1 .. 2c0+2V-1, and writes only the kept outputs: the
// full-resolution blur never reaches device memory. The plane, row and
// segment come from two 32-bit divisions per thread, not per element. Units
// are numbered with the segment fastest, so neighbouring threads touch
// neighbouring 16-byte pieces, and a block of 256 threads spans as many small
// planes as fit (the sweep's 3-channel maps of 8x8 to 64x64).
//
// V is chosen by the wrapper (ops/blur.py, launch_geometry): the largest of
// 16 bytes of input (bf16 8, f32 4; DOWN: bf16 4, f32 2), then halves, such
// that the output width is a multiple of V and both pointers are aligned to
// the vector accesses. Odd widths and an input at an odd element offset take
// V = 1 (scalar accesses, same arithmetic).
//
// Arithmetic is in float with explicit round-to-nearest operations (no fused
// multiply-add): the float result equals the plain version bit for bit, and
// the bfloat16 result is that float value rounded once. bfloat16 values move
// as their raw 16-bit patterns.

#include "vec.cuh"

namespace {

// (0.25*lo + 0.5*mid) + 0.25*hi with every operation rounded on its own
__device__ __forceinline__ float tap3(float lo, float mid, float hi) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, lo), __fmul_rn(0.5f, mid)),
                   __fmul_rn(0.25f, hi));
}

// the vertical pass at one input column c
template <typename R>
__device__ __forceinline__ float column(const R* lo, const R* mid, const R* hi, int c) {
  return tap3(to_f(__ldg(lo + c)), to_f(__ldg(mid + c)), to_f(__ldg(hi + c)));
}

// h, w: input size; the output is (h, w), or (h/2, w/2) when DOWN.
// planes * rows_out * (w_out / V) threads, one per (plane, output row,
// segment); the wrapper guarantees that product is below 2^31
template <typename R, int V, bool DOWN>
__global__ void __launch_bounds__(THREADS)
blur3_kernel(const R* __restrict__ x, R* __restrict__ y, int planes, int h, int w) {
  constexpr int N = DOWN ? 2 * V : V;      // input columns loaded as one vector
  constexpr int K = DOWN ? 2 * V + 1 : V + 2;  // columns of the vertical pass
  const int ho = DOWN ? h / 2 : h, wo = DOWN ? w / 2 : w;
  const int segs = wo / V;
  const unsigned unit = blockIdx.x * blockDim.x + threadIdx.x;
  if (unit >= (unsigned)(planes * ho * segs)) return;
  const int orow = (int)unit / segs;  // plane * ho + output row
  const int c0 = ((int)unit - orow * segs) * V;  // first output column
  const int p = orow / ho;
  const int r = DOWN ? 2 * (orow - p * ho) : orow - p * ho;  // input centre row
  const R* mid = x + ((int64_t)p * h + r) * w;
  const R* lo = r > 0 ? mid - w : mid + w;      // row -1 reads row 1
  const R* hi = r < h - 1 ? mid + w : mid - w;  // row h reads row h-2
  const int ci = DOWN ? 2 * c0 : c0;            // first input column of the vector
  // v[k]: the vertical pass at input column ci - 1 + k
  float v[K];
  {
    constexpr int L = V > 1 ? N : 1;  // V = 1: scalar accesses
    R rl[N], rm[N], rh[N];
    load_raw<L>(lo + ci, rl);
    load_raw<L>(mid + ci, rm);
    load_raw<L>(hi + ci, rh);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k + 1] = tap3(to_f(rl[k]), to_f(rm[k]), to_f(rh[k]));
  }
  v[0] = column(lo, mid, hi, ci > 0 ? ci - 1 : 1);  // column -1 reads column 1
  if (!DOWN) v[K - 1] = column(lo, mid, hi, ci + N < w ? ci + N : w - 2);  // w reads w-2
  R o[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int k = DOWN ? 2 * j : j;  // the output's centre column is v[k + 1]
    from_f(tap3(v[k], v[k + 1], v[k + 2]), o[j]);
  }
  store_raw<V>(y + (int64_t)orow * wo + c0, o);
}

template <typename R, int V, bool DOWN>
int launch(const void* x, void* y, int planes, int h, int w, int blocks, int device,
           void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  blur3_kernel<R, V, DOWN><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const R*)x, (R*)y, planes, h, w);
  return (int)cudaGetLastError();
}

// V up to 16 bytes of input per row
template <typename R, bool DOWN>
int dispatch(const void* x, void* y, int planes, int h, int w, int vec, int blocks,
             int device, void* stream) {
  constexpr int max_vec = 16 / (int)sizeof(R) / (DOWN ? 2 : 1);
  switch (vec) {
    case 1: return launch<R, 1, DOWN>(x, y, planes, h, w, blocks, device, stream);
    case 2: return launch<R, 2, DOWN>(x, y, planes, h, w, blocks, device, stream);
    case 4:
      if constexpr (max_vec >= 4) return launch<R, 4, DOWN>(x, y, planes, h, w, blocks, device, stream);
      break;
    case 8:
      if constexpr (max_vec >= 8) return launch<R, 8, DOWN>(x, y, planes, h, w, blocks, device, stream);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int blur3_f32(const void* x, void* y, int planes, int h, int w, int vec,
                         int blocks, int device, void* stream) {
  return dispatch<float, false>(x, y, planes, h, w, vec, blocks, device, stream);
}

extern "C" int blur3_bf16(const void* x, void* y, int planes, int h, int w, int vec,
                          int blocks, int device, void* stream) {
  return dispatch<unsigned short, false>(x, y, planes, h, w, vec, blocks, device, stream);
}

extern "C" int blur3_downsample2x_f32(const void* x, void* y, int planes, int h, int w,
                                      int vec, int blocks, int device, void* stream) {
  return dispatch<float, true>(x, y, planes, h, w, vec, blocks, device, stream);
}

extern "C" int blur3_downsample2x_bf16(const void* x, void* y, int planes, int h, int w,
                                       int vec, int blocks, int device, void* stream) {
  return dispatch<unsigned short, true>(x, y, planes, h, w, vec, blocks, device, stream);
}
