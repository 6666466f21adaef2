// col2im for float32 convolutions, im2col's adjoint: from a gradient g of
// the columns (n, c * kh * kw, oh * ow), position-major, write the image's
// gradient dx (n, c, h, w), contiguous, in one gather pass. Each thread owns
// one pixel of one channel and sums the at most ceil(kh / sh) * ceil(kw /
// sw) column entries that im2col copied it to, with no atomics.
//
// The sum is taken in the order of PyTorch's unfold_backward, which the
// plain version in ops/conv.py calls as autograd differentiates the plain
// im2col: first along the row (for each window row i, t_i = 0 + the
// entries of the windows j that cover the pixel, j ascending), then down the
// column (0 + t_i, i ascending). Where a window's step is at least its size
// (1x1 stride 2), unfold_backward copies instead of adding to zero, and so
// does this kernel: a -0.0 stays -0.0. The result equals the plain version
// bit for bit.
//
// Replaces no Pallas kernel: the JAX package's convolutions are XLA's. It
// exists for the same reason as im2col.cu: the plain version's two
// unfold_backward passes write and read again an intermediate kh times the
// size of the padded image, on top of a zero fill and the cut of the
// padding.
//
// Bound on this card: bytes, by the gradient of the columns it reads (up to
// 9 times the image at 3x3 stride 1, 25/4 at 5x5 stride 2); the least time is
// (columns read + image written) * 4 bytes over the memory rate. The adds
// are few.
//
// Design: g comes position-major (each position's c * kh * kw entries
// contiguous; what an ungrouped convolution's GEMM hands back, and what the
// wrapper folds any other gradient to). A block owns cb channels of one image
// and th x tw pixels. It copies the entries of those channels at every window
// over its pixels, one run of cb * kh * kw a window, into shared memory with
// asynchronous copies (every copy of the block in flight at once, no register
// held for it), runs an odd number of floats apart so that lanes reading
// neighbouring windows hit distinct banks; then each thread sums one pixel of
// one channel from the tile, the pixels column fastest so that the stores are
// coalesced. The windows at a tile's edges are read by its neighbours too;
// the wrapper (ops/conv.py, gather_geometry) picks the tile that reads the
// fewest sectors per pixel. The loops over the windows are unrolled to NW
// (ceil(k / s) of the wider axis, from the wrapper; loops above 5) and every
// read, predicated on its window being there, is issued before the first
// add. Every index comes from a multiply-and-shift division.

#include "vec.cuh"
#include "columns.cuh"

namespace {

// the launch's geometry in 32 bits: a block's cb channels and th x tw
// pixels, and the windows over them, pim x pjm at most, pitch floats apart in
// the tile
struct Col2im {
  int c, h, w, kh, kw, sh, sw, ph, pw, oh, ow, cb, th, tw, pim, pjm, pitch;
  int64_t gs_n, gs_l;
  FastDiv by_sh, by_sw, by_run, by_pjm, by_tw, by_th, by_tiles_x, by_tiles_y, by_groups;
};

// the first and last window (of size k, step s, n of them) that covers
// position z of the padded axis; first > last where none does
__device__ __forceinline__ void windows(int z, int k, int n, FastDiv by_s, int& first,
                                        int& last) {
  first = z - k + 1 > 0 ? (int)div_by(z - k + by_s.d, by_s) : 0;  // ceil((z - k + 1) / s)
  last = min((int)div_by(z, by_s), n - 1);
}

// The sum over windows i0..i1 x j0..j1 in unfold_backward's order, the
// entry of window (i, j) read by at(i, j). NW: the most windows that cover
// a pixel along either axis (ceil(k / s)); every read is issued before the
// first add. NW = 0 walks the windows in loops, for larger windows.
template <int NW, class At>
__device__ __forceinline__ float ordered_sum(int i0, int i1, int j0, int j1, bool copy_h,
                                             bool copy_w, At at) {
  float acc = 0.0f;
  if (NW > 0) {
    float v[NW > 0 ? NW : 1][NW > 0 ? NW : 1];
#pragma unroll
    for (int r = 0; r < NW; ++r)
#pragma unroll
      for (int q = 0; q < NW; ++q)
        v[r][q] = i0 + r <= i1 && j0 + q <= j1 ? at(i0 + r, j0 + q) : 0.0f;
#pragma unroll
    for (int r = 0; r < NW; ++r) {
      if (i0 + r > i1) break;
      float t = 0.0f;
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        if (j0 + q > j1) break;
        t = copy_w ? v[r][q] : __fadd_rn(t, v[r][q]);
      }
      acc = copy_h ? t : __fadd_rn(acc, t);
    }
  } else {
    for (int i = i0; i <= i1; ++i) {
      float t = 0.0f;
      for (int j = j0; j <= j1; ++j) t = copy_w ? at(i, j) : __fadd_rn(t, at(i, j));
      acc = copy_h ? t : __fadd_rn(acc, t);
    }
  }
  return acc;
}

template <int NW>
__global__ void __launch_bounds__(THREADS)
col2im_kernel(const float* __restrict__ g, float* __restrict__ dx, Col2im a) {
  __shared__ float tile[GATHER_FLOATS];
  const bool copy_h = a.sh >= a.kh, copy_w = a.sw >= a.kw;  // unfold_backward's copy
  const int taps = a.kh * a.kw;
  // this block: image n, channels c0 .., pixel rows y0 .., columns x0 ..
  const unsigned b = blockIdx.x;
  const unsigned b1 = div_by(b, a.by_tiles_x), b2 = div_by(b1, a.by_tiles_y);
  const int x0 = (int)(b - b1 * a.by_tiles_x.d) * a.tw;
  const int y0 = (int)(b1 - b2 * a.by_tiles_y.d) * a.th;
  const unsigned n = div_by(b2, a.by_groups);
  const int c0 = (int)(b2 - n * a.by_groups.d) * a.cb;
  const int thn = min(a.th, a.h - y0), twn = min(a.tw, a.w - x0);
  // the windows over the tile: rows ia .. ib, columns ja .. jb
  int ia, ib, ja, jb, unused;
  windows(y0 + a.ph, a.kh, a.oh, a.by_sh, ia, unused);
  windows(y0 + thn - 1 + a.ph, a.kh, a.oh, a.by_sh, unused, ib);
  windows(x0 + a.pw, a.kw, a.ow, a.by_sw, ja, unused);
  windows(x0 + twn - 1 + a.pw, a.kw, a.ow, a.by_sw, unused, jb);
  // their entries of channels c0 .. c0 + cb - 1, one run of cb * taps
  // a window, coalesced, copied to the tile asynchronously: every copy of
  // the block is in flight at once, with no register held for it
  const int run = a.cb * taps, total = a.pim * a.pjm * run;
  const float* gp = g + n * a.gs_n + (int64_t)c0 * taps;
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int pos = (int)div_by(e, a.by_run), t = e - pos * run;
    const int ii = (int)div_by(pos, a.by_pjm), jj = pos - ii * a.pjm;
    if (ia + ii <= ib && ja + jj <= jb)
      __pipeline_memcpy_async(tile + pos * a.pitch + t,
                              gp + ((int64_t)(ia + ii) * a.ow + ja + jj) * a.gs_l + t, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // one pixel of one channel a thread, column fastest: coalesced stores
  for (int u = threadIdx.x; u < a.cb * a.th * a.tw; u += THREADS) {
    const int r = (int)div_by(u, a.by_tw), x = u - r * a.tw;
    const int ch = (int)div_by(r, a.by_th), y = r - ch * a.th;
    if (y >= thn || x >= twn) continue;
    const int hp = y0 + y + a.ph, wp = x0 + x + a.pw;  // in the padded image
    int i0, i1, j0, j1;
    windows(hp, a.kh, a.oh, a.by_sh, i0, i1);
    windows(wp, a.kw, a.ow, a.by_sw, j0, j1);
    const float* base = tile + ch * taps;
    const float acc = ordered_sum<NW>(i0, i1, j0, j1, copy_h, copy_w, [&](int i, int j) {
      return base[((i - ia) * a.pjm + j - ja) * a.pitch + (hp - i * a.sh) * a.kw
                  + wp - j * a.sw];
    });
    dx[(((int64_t)n * a.c + c0 + ch) * a.h + y0 + y) * a.w + x0 + x] = acc;
  }
}

template <int NW>
int launch(const float* g, float* dx, const Col2im& a, unsigned blocks, int device,
           void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  col2im_kernel<NW><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(g, dx, a);
  return (int)cudaGetLastError();
}

}  // namespace

// g must be position-major (gs_k = 1, or one entry a position), any gs_n and
// gs_l; it is gathered by tiles of pb channels and ti x tj pixels
extern "C" int col2im_f32(const void* g, void* dx, const ColumnsArgs* a, int device,
                          void* stream) {
  const int kh = (int)a->kh, kw = (int)a->kw, sh = (int)a->sh, sw = (int)a->sw;
  const int cb = (int)a->pb, th = (int)a->ti, tw = (int)a->tj;
  const int run = cb * kh * kw;
  const int pim = (th + kh - 2) / sh + 1, pjm = (tw + kw - 2) / sw + 1, pitch = run | 1;
  if (cb < 1 || th < 1 || tw < 1 || a->c % cb || a->planes % a->c
      || (a->gs_k != 1 && a->c * kh * kw != 1) || (int64_t)pim * pjm * pitch > GATHER_FLOATS)
    return (int)cudaErrorInvalidValue;
  const unsigned tiles_x = (unsigned)((a->w + tw - 1) / tw);
  const unsigned tiles_y = (unsigned)((a->h + th - 1) / th);
  Col2im c = {(int)a->c, (int)a->h, (int)a->w, kh, kw, sh, sw, (int)a->ph, (int)a->pw,
              (int)a->oh, (int)a->ow, cb, th, tw, pim, pjm, pitch, a->gs_n, a->gs_l,
              fast_div((unsigned)sh), fast_div((unsigned)sw), fast_div((unsigned)run),
              fast_div((unsigned)pjm), fast_div((unsigned)tw), fast_div((unsigned)th),
              fast_div(tiles_x), fast_div(tiles_y), fast_div((unsigned)(a->c / cb))};
  const float* gp = (const float*)g;
  float* dp = (float*)dx;
  const unsigned blocks = (unsigned)a->blocks;
  switch ((int)a->vec) {
    case 0: return launch<0>(gp, dp, c, blocks, device, stream);
    case 1: return launch<1>(gp, dp, c, blocks, device, stream);
    case 2: return launch<2>(gp, dp, c, blocks, device, stream);
    case 3: return launch<3>(gp, dp, c, blocks, device, stream);
    case 4: return launch<4>(gp, dp, c, blocks, device, stream);
    case 5: return launch<5>(gp, dp, c, blocks, device, stream);
  }
  return (int)cudaErrorInvalidValue;
}
