// Low-Channel Conv Unit on Hopper: the first-layer conv with a small input
// channel count (3 for RGB), k x k taps read straight from the pre-padded
// NHWC int8 image -- no im2col tensor in memory -- then per-OC dequant,
// bias, act and requant.
//
// Replaces the Pallas TPU kernel src/repro/kernels/low_channel.py::
// low_channel_conv, _kernel (:33).
//
// What bounds it on the H100: IC = 3 makes the reduction k*k*3 deep (27 for
// MobileNetV2's 3x3 stem), far too shallow for a tensor-core tile, and the
// unit moves few bytes (a 224x224x3 int8 image in, a 112x112x32 int8 map
// out), so it is bound by bytes and by latency.  The design: the whole
// filter bank (k*k*IC*OC bytes, 864 for the stem) is staged in shared memory
// once per block; each thread computes one output pixel for one output
// channel, with output channels innermost so a warp writes contiguous codes
// and reads the same input pixel (a broadcast).  The im2col window is read
// in place, so the k*k-inflated patch tensor never exists.
#include "epilogue.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
low_channel_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ w_scale, float a_scale,
                   void* __restrict__ out, int n, int hp, int wp, int ic,
                   int oc, int k, int stride, int ho, int wo, int act,
                   int out_int8, float os) {
  extern __shared__ int8_t ws[];   // [k, k, IC, OC]
  const int wn = k * k * ic * oc;
  for (int i = threadIdx.x; i < wn; i += THREADS) ws[i] = w[i];
  __syncthreads();
  const size_t idx = blockIdx.x * (size_t)THREADS + threadIdx.x;
  const size_t total = (size_t)n * ho * wo * oc;
  if (idx >= total) return;
  const int o = static_cast<int>(idx % oc);
  size_t t = idx / oc;
  const int ow = static_cast<int>(t % wo);
  t /= wo;
  const int oh = static_cast<int>(t % ho);
  const int b = static_cast<int>(t / ho);
  const int8_t* xb =
      x + (((size_t)b * hp + (size_t)oh * stride) * wp +
           (size_t)ow * stride) * ic;
  int acc = 0;
  for (int kh = 0; kh < k; ++kh)
    for (int kw = 0; kw < k; ++kw) {
      const int8_t* xp = xb + ((size_t)kh * wp + kw) * ic;
      const int8_t* wt = ws + (kh * k + kw) * ic * oc + o;
      for (int c = 0; c < ic; ++c)
        acc += static_cast<int>(xp[c]) * static_cast<int>(wt[c * oc]);
    }
  const float v = dequant_bias_act(acc, a_scale, w_scale[o], bias, o, act);
  if (out_int8)
    static_cast<int8_t*>(out)[idx] = static_cast<int8_t>(qdq_code(v, os));
  else
    static_cast<float*>(out)[idx] = v;
}

}  // namespace

// out[N, Ho, Wo, OC] = epilogue(conv(x[N, Hp, Wp, IC], w[k, k, IC, OC])).
// The filter bank must fit the 48 KB of static-sized shared memory (the
// wrapper checks).  Returns cudaGetLastError().
extern "C" int low_channel_conv(const void* x, const void* w,
                                const void* bias, const void* w_scale,
                                float a_scale, void* out, int n, int hp,
                                int wp, int ic, int oc, int k, int stride,
                                int ho, int wo, int act, int out_int8,
                                float os, void* stream) {
  const size_t total = (size_t)n * ho * wo * oc;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) /
                                                THREADS);
  const size_t smem = (size_t)k * k * ic * oc;
  low_channel_kernel<<<blocks, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(w_scale),
      a_scale, out, n, hp, wp, ic, oc, k, stride, ho, wo, act, out_int8, os);
  return static_cast<int>(cudaGetLastError());
}
