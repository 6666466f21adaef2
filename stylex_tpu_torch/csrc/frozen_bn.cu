// Eval-mode batch norm with its ReLU6 and its residual add, in one pass
// (4-d, float32 or bfloat16, NCHW or channels-last, dense).
//
// Replaces no Pallas kernel: the JAX package's classifiers are XLA's. It
// stands in for the chain that models/classifiers.py (FrozenBatchNorm2d)
// runs as separate PyTorch kernels wherever autograd records nothing:
//
//     t = ((y - mean[c]) * scale[c]) + bias[c]
//     t = min(max(t, 0), 6)          (RELU6; NaN passes through)
//     out = residual + t             (RES: InvertedResidual's x + out)
//
// scale[c] is rsqrt(var + eps) * weight, computed by the caller with the
// torch ops the plain chain uses, in the operands' dtype. PyTorch computes
// each of those ops in float and rounds the result to the tensor's dtype;
// so does this kernel: each operation is rounded to float on its own
// (__fsub_rn, __fmul_rn, __fadd_rn: nothing contracts into a fused
// multiply-add), in the plain chain's order, then to the dtype (a no-op for
// float32, round to nearest even for bfloat16), and the clamp is PyTorch's
// (NaN first, then fmaxf and fminf, exact in either dtype). The result
// equals the separate kernels bit for bit.
//
// Bound on this card: bytes. The pass reads y (and the residual) once and
// writes the output once, so the least time is (2 or 3) * numel * itemsize
// over the memory rate. The plain chain moves y through three broadcast
// kernels, then the clamp and the add: 6 to 9 accesses of the tensor for
// every 2 or 3 here.
//
// Design: one thread per V consecutive elements of the flat tensor, as one
// 16-byte load of y (and of the residual) and one 16-byte store at V = 16 /
// itemsize (4 float32, 8 bfloat16). Elements are numbered in 64 bits, so
// one launch covers any tensor. Element e lies in channel (e / hw) % c,
// where hw is the plane's H * W for NCHW and 1 for channels-last (the
// channel fastest). Where hw is a multiple of V, the V elements share one
// channel: one division and one remainder per thread give it, and the
// channel's three parameters are read once (L1 hits: a warp's threads read
// the same few). Otherwise each element finds its own channel. The last
// thread takes the elements past the last whole vector one at a time. The
// wrapper (ops/frozen_bn.py) asks for V = 16 / itemsize where every pointer
// is aligned to 16 bytes, else for scalar accesses (V = 1, same arithmetic).

#include "vec.cuh"

namespace {

// v rounded to the raw type R and back: the float value a tensor of R holds
template <typename R>
__device__ __forceinline__ float rnd(float v) {
  R r;
  from_f(v, r);
  return to_f(r);
}

// PyTorch's clamp of hardtanh(0, 6): NaN kept, then ::min(::max(v, 0), 6)
__device__ __forceinline__ float relu6(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 6.0f);
}

template <typename R, bool RELU6, bool RES>
__device__ __forceinline__ R one(R v, R r, R m, R s, R b) {
  float t = rnd<R>(__fsub_rn(to_f(v), to_f(m)));
  t = rnd<R>(__fmul_rn(t, to_f(s)));
  t = rnd<R>(__fadd_rn(t, to_f(b)));
  if (RELU6) t = relu6(t);
  if (RES) t = __fadd_rn(to_f(r), t);
  R out;
  from_f(t, out);
  return out;
}

// ceil(n / V) threads
template <typename R, int V, bool RELU6, bool RES>
__global__ void __launch_bounds__(THREADS)
frozen_bn_kernel(const R* __restrict__ y, const R* __restrict__ res, R* __restrict__ out,
                 const R* __restrict__ mean, const R* __restrict__ scale,
                 const R* __restrict__ bias, long long n, int c, int hw) {
  const long long e0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (e0 >= n) return;
  if (e0 + V > n) {  // the elements past the last whole vector
    for (long long e = e0; e < n; ++e) {
      const int ch = (int)(e / hw % c);
      out[e] = one<R, RELU6, RES>(__ldg(y + e), RES ? __ldg(res + e) : R(), __ldg(mean + ch),
                                  __ldg(scale + ch), __ldg(bias + ch));
    }
    return;
  }
  R v[V], r[V], o[V];
  load_raw<V>(y + e0, v);
  if (RES) load_raw<V>(res + e0, r);
  if (hw % V == 0) {  // one plane, one channel
    const int ch = (int)(e0 / hw % c);
    const R m = __ldg(mean + ch), s = __ldg(scale + ch), b = __ldg(bias + ch);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = one<R, RELU6, RES>(v[k], RES ? r[k] : R(), m, s, b);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int ch = (int)((e0 + k) / hw % c);
      o[k] = one<R, RELU6, RES>(v[k], RES ? r[k] : R(), __ldg(mean + ch), __ldg(scale + ch),
                                __ldg(bias + ch));
    }
  }
  store_raw<V>(out + e0, o);
}

template <typename R, int V, bool RELU6, bool RES>
int launch(const void* y, const void* res, void* out, const void* mean, const void* scale,
           const void* bias, long long n, int c, int hw, int device, void* stream) {
  const long long blocks = (n + (long long)V * THREADS - 1) / ((long long)V * THREADS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  frozen_bn_kernel<R, V, RELU6, RES><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const R*)y, (const R*)res, (R*)out, (const R*)mean, (const R*)scale, (const R*)bias, n,
      c, hw);
  return (int)cudaGetLastError();
}

template <typename R, int V>
int variant(const void* y, const void* res, void* out, const void* mean, const void* scale,
            const void* bias, long long n, int c, int hw, int act, int device, void* stream) {
  if (act && res)
    return launch<R, V, true, true>(y, res, out, mean, scale, bias, n, c, hw, device, stream);
  if (act)
    return launch<R, V, true, false>(y, res, out, mean, scale, bias, n, c, hw, device, stream);
  if (res)
    return launch<R, V, false, true>(y, res, out, mean, scale, bias, n, c, hw, device, stream);
  return launch<R, V, false, false>(y, res, out, mean, scale, bias, n, c, hw, device, stream);
}

// 16-byte accesses where aligned, else scalar ones
template <typename R>
int dispatch(const void* y, const void* res, void* out, const void* mean, const void* scale,
             const void* bias, long long n, int c, int hw, int act, int aligned, int device,
             void* stream) {
  if (aligned)
    return variant<R, 16 / (int)sizeof(R)>(y, res, out, mean, scale, bias, n, c, hw, act,
                                           device, stream);
  return variant<R, 1>(y, res, out, mean, scale, bias, n, c, hw, act, device, stream);
}

}  // namespace

// res may be null (no residual add); act 1 applies ReLU6; aligned 1 where
// y, res and out all lie on 16-byte boundaries
extern "C" int frozen_bn_f32(const void* y, const void* res, void* out, const void* mean,
                             const void* scale, const void* bias, long long n, int c, int hw,
                             int act, int aligned, int device, void* stream) {
  return dispatch<float>(y, res, out, mean, scale, bias, n, c, hw, act, aligned, device,
                         stream);
}

extern "C" int frozen_bn_bf16(const void* y, const void* res, void* out, const void* mean,
                              const void* scale, const void* bias, long long n, int c, int hw,
                              int act, int aligned, int device, void* stream) {
  return dispatch<unsigned short>(y, res, out, mean, scale, bias, n, c, hw, act, aligned,
                                  device, stream);
}
