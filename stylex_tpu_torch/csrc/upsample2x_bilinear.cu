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
// Bound on this card: bytes. The op reads B*C*H*W and writes 4*B*C*H*W
// elements, so the least time is 5*B*C*H*W*itemsize over the memory rate;
// 6 multiply-adds per output are far below the card's arithmetic rate. What
// keeps a kernel from that bound here is instructions, not arithmetic: index
// math per element, and many narrow accesses.
//
// Design: one thread per segment of one output row of one plane: V input
// columns, 2V outputs. It loads its centre input row iy = oy/2 and the
// neighbour row (iy-1 for an even output row, iy+1 for an odd one,
// edge-clamped) over its V columns as one vector each, plus the clamped
// column on either side (L1 hits: the neighbouring thread loads them as part
// of its vector; at a plane's edge the clamp takes them from the vector
// itself), computes the vertical pass of its V+2 columns, then the
// horizontal pass, and writes its 2V outputs with one store (16 bytes at the
// widest V). Threads are numbered with the segment fastest, then the output
// row, then the plane, so a warp's stores cover one contiguous stretch of
// the output at every width. At W = 4 an output row is 16 bytes, and a
// thread that wrote both output rows under an input row (one 3-row load for
// two stores) left each store instruction writing half of every 32-byte
// sector; measured on the H100, that layout took 0.364 ms for the sweep
// chunk's upsamples, this one 0.292 ms. The plane, row and segment come from
// one 32-bit division and one remainder per thread, not per element, and a
// block of 256 threads spans as many small planes as fit.
//
// V is chosen by the wrapper (ops/blur.py, launch_geometry): the largest of
// 8 bytes of input (bf16 4, f32 2: a 16-byte store per output row), then
// halves, such that W is a multiple of V and both pointers are aligned to the
// vector accesses. Odd W and an input at an odd element offset take V = 1
// (scalar accesses, same arithmetic). The wrapper also splits a call whose
// thread count would pass 2^31 - 1 into several launches.
//
// Arithmetic is in float with explicit round-to-nearest operations (no fused
// multiply-add), in the plain version's order, so the float result equals
// the plain PyTorch version bit for bit and the bfloat16 result is that float
// value rounded once. bfloat16 values move as their raw 16-bit patterns.

#include "vec.cuh"

namespace {

// one tap pair: w_near * near + w_cur * cur, each product and the sum
// rounded separately, as two PyTorch elementwise ops round them
__device__ __forceinline__ float tap2(float w_a, float a, float w_b, float b) {
  return __fadd_rn(__fmul_rn(w_a, a), __fmul_rn(w_b, b));
}

// columns c0-1 .. c0+V of one input row (p points at column c0), clamped
// to the row, as floats
template <typename R, int V>
__device__ __forceinline__ void load_clamped(const R* p, int c0, int w, float (&v)[V + 2]) {
  R r[V];
  load_raw<V>(p, r);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i + 1] = to_f(r[i]);
  v[0] = c0 > 0 ? to_f(__ldg(p - 1)) : v[1];
  v[V + 1] = c0 + V < w ? to_f(__ldg(p + V)) : v[V];
}

// the output row from one row of vertical results (columns c0-1 .. c0+V)
template <typename R, int V>
__device__ __forceinline__ void store_row(R* out, const float (&r)[V + 2]) {
  R o[2 * V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    from_f(tap2(0.25f, r[j], 0.75f, r[j + 1]), o[2 * j]);
    from_f(tap2(0.25f, r[j + 2], 0.75f, r[j + 1]), o[2 * j + 1]);
  }
  store_raw<(V > 1 ? 2 * V : 1)>(out, o);  // V = 1: scalar accesses
}

// planes * 2h * (w / V) threads, one per (plane, output row, segment of V
// input columns); the wrapper guarantees that product is below 2^31
template <typename R, int V>
__global__ void __launch_bounds__(THREADS)
upsample2x_bilinear_kernel(const R* __restrict__ x, R* __restrict__ y, int planes, int h,
                           int w) {
  const int segs = w / V;
  const unsigned unit = blockIdx.x * blockDim.x + threadIdx.x;
  if (unit >= (unsigned)(planes * 2 * h * segs)) return;
  const int orow = (int)unit / segs;  // plane * 2h + output row
  const int c0 = ((int)unit - orow * segs) * V;
  const int row = orow >> 1;  // plane * h + input row iy
  const int iy = row % h;
  const R* centre = x + (int64_t)row * w + c0;
  // the neighbour row: iy-1 for an even output row, iy+1 for an odd one
  const R* near = (orow & 1) ? (iy < h - 1 ? centre + w : centre) : (iy > 0 ? centre - w : centre);
  float a[V + 2], m[V + 2];
  load_clamped<R, V>(near, c0, w, a);
  load_clamped<R, V>(centre, c0, w, m);
  // rows: 0.75 on the centre row, 0.25 on the neighbour row
  float r[V + 2];
#pragma unroll
  for (int j = 0; j < V + 2; ++j) r[j] = tap2(0.25f, a[j], 0.75f, m[j]);
  // columns: the same weights across the row's results
  store_row<R, V>(y + (int64_t)orow * 2 * w + 2 * c0, r);
}

template <typename R, int V>
int launch(const void* x, void* y, int planes, int h, int w, int blocks, int device,
           void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  upsample2x_bilinear_kernel<R, V><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const R*)x, (R*)y, planes, h, w);
  return (int)cudaGetLastError();
}

// V up to 8 bytes of input: a 16-byte store per output row
template <typename R>
int dispatch(const void* x, void* y, int planes, int h, int w, int vec, int blocks,
             int device, void* stream) {
  switch (vec) {
    case 1: return launch<R, 1>(x, y, planes, h, w, blocks, device, stream);
    case 2: return launch<R, 2>(x, y, planes, h, w, blocks, device, stream);
    case 4:
      if constexpr (sizeof(R) == 2) return launch<R, 4>(x, y, planes, h, w, blocks, device, stream);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int upsample2x_bilinear_f32(const void* x, void* y, int planes, int h, int w,
                                       int vec, int blocks, int device, void* stream) {
  return dispatch<float>(x, y, planes, h, w, vec, blocks, device, stream);
}

extern "C" int upsample2x_bilinear_bf16(const void* x, void* y, int planes, int h, int w,
                                        int vec, int blocks, int device, void* stream) {
  return dispatch<unsigned short>(x, y, planes, h, w, vec, blocks, device, stream);
}
