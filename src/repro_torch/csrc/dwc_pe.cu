// DWC PE on Hopper: k x k depthwise convolution over a pre-padded NHWC int8
// map, int32 accumulation, per-channel dequant, bias, act and requant; and
// the causal temporal (1-D) depthwise conv of the mamba mixer, in f32.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dwc_pe.py:
//   dwc2d, _dwc2d_kernel (:40)                 -> dwc_pe_dwc2d
//   dwc1d_causal, _dwc1d_kernel (:157)         -> dwc_pe_dwc1d
//
// What bounds it on the H100: a depthwise conv does 2*k*k ops per output
// and has no reduction over channels, so it cannot use the tensor cores and
// is bound by bytes -- the int8 input map read once and the int8 output
// written once.  The design keeps the traffic at that: one thread per output
// (n, ho, wo, c) with channels innermost, so a warp reads 32 neighbouring
// channels of one tap (a coalesced line) and writes 32 neighbouring int8
// codes; the k*k taps of neighbouring outputs overlap and are served from L1
// / L2 rather than device memory.  The accumulator stays in a register and
// the whole epilogue runs on it, so no int32 or f32 map is ever written.
// Channels are not padded: the TPU's 128-lane padding has no counterpart.
//
// The 1-D causal conv is bytes-bound too (2*k flops per output, no channel
// reduction): the f32 input [B, L, C] read once and the f32 output written
// once.  One thread owns one channel of TCH consecutive time steps of one
// sequence, channels innermost, so a warp's loads and stores are 32
// neighbouring floats; the k-1 steps of causal history a thread re-reads
// come from L1 / L2.  No pad is materialized: a tap before t = 0 reads a
// zero.  The arithmetic is the plain version's (ref.dwc1d_causal): taps in
// order, acc = acc + x * w rounded at every step (__fmul_rn / __fadd_rn),
// then + bias, then the act, with silu as torch's CUDA F.silu computes it,
// x / (1 + expf(-x)) (full-precision expf, IEEE division).
#include "epilogue.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dwc_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ bias, const float* __restrict__ w_scale,
           float a_scale, void* __restrict__ out, int n, int hp, int wp,
           int c, int k, int stride, int ho, int wo, int act, int out_int8,
           float os) {
  const size_t idx = blockIdx.x * (size_t)THREADS + threadIdx.x;
  const size_t total = (size_t)n * ho * wo * c;
  if (idx >= total) return;
  const int ch = static_cast<int>(idx % c);
  size_t t = idx / c;
  const int ow = static_cast<int>(t % wo);
  t /= wo;
  const int oh = static_cast<int>(t % ho);
  const int b = static_cast<int>(t / ho);
  const int8_t* xb =
      x + (((size_t)b * hp + (size_t)oh * stride) * wp +
           (size_t)ow * stride) * c + ch;
  int acc = 0;
  for (int kh = 0; kh < k; ++kh)
    for (int kw = 0; kw < k; ++kw)
      acc += static_cast<int>(xb[((size_t)kh * wp + kw) * c]) *
             static_cast<int>(w[(kh * k + kw) * c + ch]);
  const float v = dequant_bias_act(acc, a_scale, w_scale[ch], bias, ch, act);
  if (out_int8)
    static_cast<int8_t*>(out)[idx] = static_cast<int8_t>(qdq_code(v, os));
  else
    static_cast<float*>(out)[idx] = v;
}

constexpr int TCH = 8;          // time steps per thread (dwc1d)

__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
}

__global__ void __launch_bounds__(THREADS)
dwc1d_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ out, int b,
             int l, int c, int k, int silu_act) {
  const int chunks = (l + TCH - 1) / TCH;
  const size_t idx = blockIdx.x * (size_t)THREADS + threadIdx.x;
  if (idx >= (size_t)b * chunks * c) return;
  const int ch = static_cast<int>(idx % c);
  const size_t r = idx / c;
  const int t0 = static_cast<int>(r % chunks) * TCH;
  const size_t base = (r / chunks) * (size_t)l * c + ch;
  const int t1 = min(t0 + TCH, l);
  for (int t = t0; t < t1; ++t) {
    float acc = 0.f;
    for (int i = 0; i < k; ++i) {
      const int src = t - (k - 1) + i;
      const float xv = src >= 0 ? x[base + (size_t)src * c] : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(xv, w[i * c + ch]));
    }
    if (bias != nullptr) acc = __fadd_rn(acc, bias[ch]);
    out[base + (size_t)t * c] = silu_act ? silu(acc) : acc;
  }
}

}  // namespace

// out[N, Ho, Wo, C] = epilogue(depthwise(x[N, Hp, Wp, C], w[k, k, C])).
// Returns cudaGetLastError().
extern "C" int dwc_pe_dwc2d(const void* x, const void* w, const void* bias,
                            const void* w_scale, float a_scale, void* out,
                            int n, int hp, int wp, int c, int k, int stride,
                            int ho, int wo, int act, int out_int8, float os,
                            void* stream) {
  const size_t total = (size_t)n * ho * wo * c;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) /
                                                THREADS);
  dwc_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(w_scale),
      a_scale, out, n, hp, wp, c, k, stride, ho, wo, act, out_int8, os);
  return static_cast<int>(cudaGetLastError());
}

// out[B, L, C] = act(causal_depthwise(x[B, L, C], w[k, C]) + bias), f32.
// silu_act: 0 none, 1 silu.  Returns cudaGetLastError().
extern "C" int dwc_pe_dwc1d(const void* x, const void* w, const void* bias,
                            void* out, int b, int l, int c, int k,
                            int silu_act, void* stream) {
  const size_t total = (size_t)b * ((l + TCH - 1) / TCH) * c;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) /
                                                THREADS);
  dwc1d_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), b, l, c, k,
      silu_act);
  return static_cast<int>(cudaGetLastError());
}
