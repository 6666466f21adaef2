// im2col for float32 convolutions: from an image x (n, c, h, w), with any
// strides and with the zero padding read at its borders, write the columns
// (n, c * kh * kw, oh * ow): entry (ch * kh + ki) * kw + kj of position
// i * ow + j holds x[n, ch, i * sh + ki - ph, j * sw + kj - pw], or 0
// outside the image. These are the values of the plain version in
// ops/conv.py (pad, unfold, permute, one copy); the kernel moves values only.
// It writes them position-major (each position's c * kh * kw entries
// contiguous): the transpose that an ungrouped convolution's matmul folds the
// columns to. The plain version's row-major columns cost torch.matmul one
// more copy for that fold; written so, the matmul folds them as a view and
// calls the same GEMM on the same bytes. A grouped convolution's batched
// matmul copies them to its own layout, as the plain version's pad and copy
// did.
//
// Replaces no Pallas kernel: the JAX package's convolutions are XLA's. It
// exists because the port computes float32 training convolutions as im2col
// and a cuBLAS GEMM (cuDNN's float32 weight gradients stray from a float64
// witness; ops/conv.py), and the plain version's pad, strided copy and the
// matmul's transposing copy moved the columns at a fraction of the memory
// rate.
//
// Bound on this card: bytes, by the columns it writes: kh * kw / (sh * sw)
// times the image for a window that covers it, up to 25/4 (5x5 stride 2)
// and 9 (3x3 stride 1). The least time is (image read + columns written) *
// 4 bytes over the memory rate; there is no arithmetic.
//
// Design: a block owns a tile of output rows i0 .. i0 + ti - 1 and columns
// j0 .. j0 + tj - 1 of pb channels of one image (pb divides c). It copies
// the input rows and columns under the tile, with the window's halo, into
// shared memory once, with asynchronous copies (all in flight at once), the
// padding as zeros, reading through the image's strides (coalesced along w
// when its last stride is 1). Then each of the tile's positions takes one run
// of pb * kh * kw entries of the columns, V at a time, consecutive threads
// writing consecutive addresses. Every index comes from a multiply-and-shift
// division, not a hardware divide.
//
// The wrapper (ops/conv.py, columns_geometry) sizes the tile to TILE_FLOATS
// and chooses V, the store's width: the widest of 4 (16 bytes), 2 and 1 that
// divides pb * kh * kw and c * kh * kw (scalar stores at ragged runs). The
// columns are allocated by the wrapper, so they are aligned to the stores.

#include "vec.cuh"
#include "columns.cuh"

namespace {

// the launch's geometry in 32 bits, with its divisors prepared. rows and
// wt are a full tile's input rows and columns: a tile at the bottom or right
// edge keeps the full tile's layout and stores only its own outputs
struct Im2col {
  int c, h, w, kh, kw, sh, sw, ph, pw, oh, ow, pb, ti, tj, rows, wt;
  int64_t xs_n, xs_c, xs_h, xs_w;
  FastDiv by_c, by_kw, by_taps, by_col_tiles, by_row_tiles, by_wt, by_tile, by_piece, by_tj;
};

template <int V>
__global__ void __launch_bounds__(THREADS)
im2col_kernel(const float* __restrict__ x, float* __restrict__ cols, Im2col a) {
  __shared__ float tile[TILE_FLOATS];
  const int taps = a.kh * a.kw, rows = a.rows, wt = a.wt;
  // this block: planes p0 .. (channels c0 .. of image n), output rows
  // i0 .., output columns j0 ..
  const unsigned b = blockIdx.x;
  const unsigned bg_bi = div_by(b, a.by_col_tiles);
  const int bj = (int)(b - bg_bi * a.by_col_tiles.d);
  const unsigned bg = div_by(bg_bi, a.by_row_tiles);
  const int bi = (int)(bg_bi - bg * a.by_row_tiles.d);
  const int p0 = (int)bg * a.pb, i0 = bi * a.ti, j0 = bj * a.tj;
  const int tin = min(a.ti, a.oh - i0), tjn = min(a.tj, a.ow - j0);
  const int n = (int)div_by(p0, a.by_c), c0 = p0 - n * a.c;
  const int y0 = i0 * a.sh - a.ph, x0 = j0 * a.sw - a.pw;  // image position of tile[q][0][0]

  // the tile, copied asynchronously (every copy of the block in flight at
  // once, with no register held for it); the padding written as zeros
  const float* xp = x + n * a.xs_n + c0 * a.xs_c;
  for (int k = threadIdx.x; k < a.pb * rows * wt; k += THREADS) {
    const int q = (int)div_by(k, a.by_tile), rs = k - q * rows * wt;
    const int r = (int)div_by(rs, a.by_wt), s = rs - r * wt;
    const int y = y0 + r, xx = x0 + s;
    if (y >= 0 && y < a.h && xx >= 0 && xx < a.w)
      __pipeline_memcpy_async(tile + k, xp + q * a.xs_c + y * a.xs_h + xx * a.xs_w, 4);
    else
      tile[k] = 0.0f;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // each position's pb * taps entries are one run of the columns, written
  // by consecutive threads
  const int pvec = a.pb * taps / V;  // stores per position
  const int64_t kk = (int64_t)a.c * taps;
  float* cp = cols + (int64_t)n * a.oh * a.ow * kk + (int64_t)c0 * taps;
  for (int u = threadIdx.x; u < a.ti * a.tj * pvec; u += THREADS) {
    const int pos = (int)div_by(u, a.by_piece), e = (u - pos * pvec) * V;
    const int i = (int)div_by(pos, a.by_tj), j = pos - i * a.tj;
    if (i >= tin || j >= tjn) continue;  // past a ragged tile's edge
    int q = (int)div_by(e, a.by_taps), tap = e - q * taps;
    int ki = (int)div_by(tap, a.by_kw), kj = tap - ki * a.kw;
    float o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      o[v] = tile[(q * rows + i * a.sh + ki) * wt + j * a.sw + kj];
      if (++kj == a.kw) {
        kj = 0;
        if (++ki == a.kh) ki = 0, ++q;
      }
    }
    store_raw<V>(cp + ((int64_t)(i0 + i) * a.ow + j0 + j) * kk + e, o);
  }
}

template <int V>
int launch(const float* x, float* cols, const Im2col& g, unsigned blocks, int device,
           void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  im2col_kernel<V><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(x, cols, g);
  return (int)cudaGetLastError();
}

}  // namespace

// the columns must be position-major and dense: strides (oh * ow * c * kh *
// kw, 1, c * kh * kw); any other layout is refused
extern "C" int im2col_f32(const void* x, void* cols, const ColumnsArgs* a, int device,
                          void* stream) {
  const int kh = (int)a->kh, kw = (int)a->kw, sh = (int)a->sh, sw = (int)a->sw;
  const int oh = (int)a->oh, ow = (int)a->ow, ti = (int)a->ti, tj = (int)a->tj;
  const int vec = (int)a->vec, pb = (int)a->pb, taps = kh * kw;
  const int64_t kk = a->c * taps;
  const int rows = (ti - 1) * sh + kh, wt = (tj - 1) * sw + kw;
  if (vec < 1 || pb < 1 || (int64_t)pb * rows * wt > TILE_FLOATS || a->c % pb
      || pb * taps % vec || kk % vec || (a->gs_k != 1 && kk != 1) || a->gs_l != kk
      || a->gs_n != (int64_t)oh * ow * kk)
    return (int)cudaErrorInvalidValue;
  Im2col g = {(int)a->c, (int)a->h, (int)a->w, kh, kw, sh, sw, (int)a->ph, (int)a->pw, oh, ow,
              pb, ti, tj, rows, wt, a->xs_n, a->xs_c, a->xs_h, a->xs_w,
              fast_div((unsigned)a->c), fast_div((unsigned)kw), fast_div((unsigned)taps),
              fast_div((unsigned)((ow + tj - 1) / tj)), fast_div((unsigned)((oh + ti - 1) / ti)),
              fast_div((unsigned)wt), fast_div((unsigned)(rows * wt)),
              fast_div((unsigned)(pb * taps / vec)), fast_div((unsigned)tj)};
  const float* xp = (const float*)x;
  float* cp = (float*)cols;
  const unsigned blocks = (unsigned)a->blocks;
  switch (vec) {
    case 1: return launch<1>(xp, cp, g, blocks, device, stream);
    case 2: return launch<2>(xp, cp, g, blocks, device, stream);
    case 4: return launch<4>(xp, cp, g, blocks, device, stream);
  }
  return (int)cudaErrorInvalidValue;
}
