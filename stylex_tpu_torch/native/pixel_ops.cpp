// Host pixel pipeline of the data loader: resize, center crop and uint8 ->
// float32 normalisation in one pass, written straight into the caller's
// buffer (a row of the batch), with no intermediate image objects.
//
// The resize is PIL's Image.resize(..., BILINEAR) computed the way PIL
// computes it, so the result equals the PIL path bit for bit: a separable
// triangle filter whose support scales with the downscale ratio, its
// weights normalised in double precision and then rounded to fixed point
// with 22 fraction bits; a horizontal pass over the source rows that the
// output needs, rounded and clipped to uint8, then a vertical pass, rounded
// and clipped to uint8 again. Only the output pixels inside the crop are
// computed: each depends on the source alone. The uint8 result is divided
// by 255 in float32 (as numpy's x / 255.0 does), then normalised by an
// optional per-channel mean and std. Channels are independent, so 1 to 8
// interleaved channels work alike (PIL premultiplies alpha before resizing
// RGBA images; callers keep those on the PIL path).
//
// A C ABI for ctypes; no Python.h.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

struct Filter {
  std::vector<int> first;   // first source index of each output index
  std::vector<int> count;   // number of taps
  std::vector<int32_t> k;   // fixed-point taps, ksize per output index
  int ksize = 0;
};

double triangle(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

// PIL's precompute_coeffs and normalize_coeffs_8bpc for BILINEAR over the
// whole input (box 0..in_size).
Filter make_filter(int in_size, int out_size) {
  Filter f;
  const double scale = static_cast<double>(static_cast<float>(in_size)) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;
  f.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  f.first.resize(out_size);
  f.count.resize(out_size);
  f.k.assign(static_cast<size_t>(out_size) * f.ksize, 0);
  std::vector<double> w(f.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      w[x] = triangle((x + xmin - center + 0.5) * ss);
      ww += w[x];
    }
    for (int x = 0; x < xmax; ++x) {
      const double v = ww != 0.0 ? w[x] / ww : w[x];
      f.k[static_cast<size_t>(xx) * f.ksize + x] =
          static_cast<int32_t>(v < 0 ? -0.5 + v * (1 << kPrecisionBits)
                                     : 0.5 + v * (1 << kPrecisionBits));
    }
    f.first[xx] = xmin;
    f.count[xx] = xmax;
  }
  return f;
}

inline uint8_t clip8(int32_t v) {
  const int32_t s = v >> kPrecisionBits;
  return static_cast<uint8_t>(s < 0 ? 0 : (s > 255 ? 255 : s));
}

}  // namespace

extern "C" {

// (in_h, in_w, ch) uint8 -> resize to (out_h, out_w) -> center crop
// (crop_h, crop_w) -> float32 in [0, 1], then (v - mean[c]) / std[c] where
// both are given; hflip mirrors the crop. dst holds crop_h * crop_w * ch
// floats. Returns 0, or 1 on invalid sizes.
int resize_crop_normalize_u8(const uint8_t* src, int in_h, int in_w, int ch, int out_h,
                             int out_w, int crop_h, int crop_w, const float* mean,
                             const float* stddev, int hflip, float* dst) {
  if (in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 || crop_h <= 0 || crop_w <= 0 ||
      crop_h > out_h || crop_w > out_w || ch <= 0 || ch > 8)
    return 1;
  const Filter fy = make_filter(in_h, out_h);
  const Filter fx = make_filter(in_w, out_w);
  const int y0 = (out_h - crop_h) / 2;
  const int x0 = (out_w - crop_w) / 2;

  // the source rows that the crop's output rows read
  const int row_lo = fy.first[y0];
  const int row_hi = fy.first[y0 + crop_h - 1] + fy.count[y0 + crop_h - 1];
  const int n_rows = row_hi - row_lo;

  // horizontal pass: those rows, the crop's columns, uint8
  std::vector<uint8_t> hpass(static_cast<size_t>(n_rows) * crop_w * ch);
  for (int y = 0; y < n_rows; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(row_lo + y) * in_w * ch;
    uint8_t* hrow = hpass.data() + static_cast<size_t>(y) * crop_w * ch;
    for (int ox = 0; ox < crop_w; ++ox) {
      const int sx = x0 + ox;
      const int first = fx.first[sx];
      const int count = fx.count[sx];
      const int32_t* k = &fx.k[static_cast<size_t>(sx) * fx.ksize];
      for (int c = 0; c < ch; ++c) {
        int32_t acc = 1 << (kPrecisionBits - 1);
        for (int i = 0; i < count; ++i) acc += srow[(first + i) * ch + c] * k[i];
        hrow[ox * ch + c] = clip8(acc);
      }
    }
  }

  // vertical pass, then the float conversion
  for (int oy = 0; oy < crop_h; ++oy) {
    const int sy = y0 + oy;
    const int first = fy.first[sy] - row_lo;
    const int count = fy.count[sy];
    const int32_t* k = &fy.k[static_cast<size_t>(sy) * fy.ksize];
    float* drow = dst + static_cast<size_t>(oy) * crop_w * ch;
    for (int ox = 0; ox < crop_w; ++ox) {
      const int dx = hflip ? crop_w - 1 - ox : ox;
      for (int c = 0; c < ch; ++c) {
        int32_t acc = 1 << (kPrecisionBits - 1);
        for (int i = 0; i < count; ++i)
          acc += hpass[(static_cast<size_t>(first + i) * crop_w + ox) * ch + c] * k[i];
        float v = static_cast<float>(clip8(acc)) / 255.0f;
        if (mean != nullptr && stddev != nullptr) v = (v - mean[c]) / stddev[c];
        drow[dx * ch + c] = v;
      }
    }
  }
  return 0;
}

// (h, w, ch) uint8 -> float32 in [0, 1], normalised and mirrored as above.
int normalize_u8(const uint8_t* src, int h, int w, int ch, const float* mean,
                 const float* stddev, int hflip, float* dst) {
  if (h <= 0 || w <= 0 || ch <= 0) return 1;
  for (int y = 0; y < h; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * w * ch;
    float* drow = dst + static_cast<size_t>(y) * w * ch;
    for (int x = 0; x < w; ++x) {
      const int sx = hflip ? w - 1 - x : x;
      for (int c = 0; c < ch; ++c) {
        float v = static_cast<float>(srow[sx * ch + c]) / 255.0f;
        if (mean != nullptr && stddev != nullptr) v = (v - mean[c]) / stddev[c];
        drow[x * ch + c] = v;
      }
    }
  }
  return 0;
}

}  // extern "C"
