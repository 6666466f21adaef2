// Shared by im2col.cu and col2im.cu: the geometry of one call, as
// ops/conv.py fills it (csrc.ColumnsArgs mirrors this struct field for
// field), and division by a divisor that is fixed for a launch.

#pragma once

#include <cuda_pipeline.h>
#include <stdint.h>

// im2col's shared input tile (TILE_FLOATS) and col2im's shared tile of
// position-major columns (GATHER_FLOATS), in floats, come from the build
// (csrc/__init__.py passes them to nvcc as -D defines, and ops/conv.py sizes
// the tiles to the same numbers)
#if !defined(TILE_FLOATS) || !defined(GATHER_FLOATS)
#error "build with -DTILE_FLOATS=... -DGATHER_FLOATS=... (csrc/__init__.py)"
#endif

// The image is (n, c, h, w), planes = n * c of them; the columns are
// (n, c * kh * kw, oh * ow), position-major: each position's c * kh * kw
// entries contiguous. All sizes and strides in elements.
struct ColumnsArgs {
  int64_t planes, c, h, w;
  int64_t xs_n, xs_c, xs_h, xs_w;   // the image's strides (im2col's input)
  int64_t gs_n, gs_k, gs_l;         // the columns' strides
  int64_t kh, kw, sh, sw, ph, pw, oh, ow;
  int64_t pb, ti, tj;               // a block's channels, output rows / pixel rows,
                                    // output columns / pixel columns
  int64_t vec;                      // im2col's store width; col2im's windows a pixel lies in
  int64_t blocks;                   // of THREADS threads
};

namespace {

// n / d for 0 <= n < 2^31 and d >= 1 by a multiply and a shift (the
// round-up reciprocal of PyTorch's IntDivider), set up on the host
struct FastDiv {
  unsigned d, m, s;
};

inline FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, (unsigned)m, s};
}

__device__ __forceinline__ unsigned div_by(unsigned n, FastDiv f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

}  // namespace
