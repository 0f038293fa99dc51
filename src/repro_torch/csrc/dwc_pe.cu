// DWC PE on Hopper: k x k depthwise convolution over a pre-padded NHWC int8
// map, int32 accumulation, per-channel dequant, bias, act and requant.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dwc_pe.py::dwc2d,
// _dwc2d_kernel (:40).
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
