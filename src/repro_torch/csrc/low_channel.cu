// Low-Channel Conv Unit on Hopper: the first-layer conv with a small input
// channel count (3 for RGB), k x k taps read straight from the pre-padded
// NHWC int8 image -- no im2col tensor in memory -- then per-OC dequant,
// bias, act and requant.
//
// Replaces the Pallas TPU kernel src/repro/kernels/low_channel.py::
// low_channel_conv, _kernel (:33), with and without its max-pool tail.
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
//
// The max-pool tail (ResNet's 7x7/2 stem -> 3x3/2 max pool) has overlapping
// windows, so a thread per pooled output would compute most conv outputs
// 2.25 times.  Instead a block owns a tile of TP x TP pooled outputs for OCB
// output channels: it computes the conv outputs under the tile, halo
// included, once each into shared memory (after bias, act and, for a static
// chain, the qdq at the pre-pool edge scale), then takes each window's max
// from there.  Only the pooled map is written: for ResNet50 that is 55x55
// instead of 112x112 per channel.
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

// Max-pool tail: grid (pooled tiles, OC / OCB, N); dynamic shared memory
// holds the block's filter slice [k*k*IC, OCB] int8 after the conv tile
// [CH * CW, OCB] float32, CH = (TP - 1) * ps + pk (likewise CW).
__global__ void __launch_bounds__(THREADS)
low_channel_max_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ w_scale, float a_scale,
                       void* __restrict__ out, int hp, int wp, int ic, int oc,
                       int k, int stride, int act, int has_mid,
                       float mid_scale, int pk, int ps, int pho, int pwo,
                       int tp, int ocb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cmax = (tp - 1) * ps + pk;
  float* tile = reinterpret_cast<float*>(smem);
  int8_t* ws = reinterpret_cast<int8_t*>(tile + cmax * cmax * ocb);
  const int tiles_w = (pwo + tp - 1) / tp;
  const int ph0 = (blockIdx.x / tiles_w) * tp;
  const int pw0 = (blockIdx.x % tiles_w) * tp;
  const int oc0 = blockIdx.y * ocb, b = blockIdx.z;
  const int th = min(tp, pho - ph0), tw = min(tp, pwo - pw0);
  const int ch = (th - 1) * ps + pk, cw = (tw - 1) * ps + pk;
  const int taps = k * k * ic;
  for (int i = threadIdx.x; i < taps * ocb; i += THREADS) {
    const int o = oc0 + i % ocb;
    ws[i] = o < oc ? w[(size_t)(i / ocb) * oc + o] : int8_t(0);
  }
  __syncthreads();
  // the conv outputs under the tile, each computed once
  for (int i = threadIdx.x; i < ch * cw * ocb; i += THREADS) {
    const int o = i % ocb, p = i / ocb;
    if (oc0 + o >= oc) continue;
    const int r = ph0 * ps + p / cw, c = pw0 * ps + p % cw;
    const int8_t* xb =
        x + (((size_t)b * hp + (size_t)r * stride) * wp +
             (size_t)c * stride) * ic;
    int acc = 0;
    for (int kh = 0; kh < k; ++kh)
      for (int kw = 0; kw < k; ++kw) {
        const int8_t* xp = xb + ((size_t)kh * wp + kw) * ic;
        const int8_t* wt = ws + (kh * k + kw) * ic * ocb + o;
        for (int q = 0; q < ic; ++q)
          acc += static_cast<int>(xp[q]) * static_cast<int>(wt[q * ocb]);
      }
    const float v = dequant_bias_act(acc, a_scale, w_scale[oc0 + o], bias,
                                     oc0 + o, act);
    tile[p * ocb + o] = has_mid ? qdq_code(v, mid_scale) : v;
  }
  __syncthreads();
  // each pooled output: the max over its window, taps in (kh, kw) order
  for (int i = threadIdx.x; i < th * tw * ocb; i += THREADS) {
    const int o = i % ocb, p = i / ocb;
    if (oc0 + o >= oc) continue;
    const int pr = p / tw, pc = p % tw;
    float m = tile[((pr * ps) * cw + pc * ps) * ocb + o];
    for (int kh = 0; kh < pk; ++kh)
      for (int kw = 0; kw < pk; ++kw)
        m = fmaxf(m, tile[((pr * ps + kh) * cw + pc * ps + kw) * ocb + o]);
    const size_t idx =
        (((size_t)b * pho + ph0 + pr) * pwo + pw0 + pc) * oc + oc0 + o;
    if (has_mid)
      static_cast<int8_t*>(out)[idx] = static_cast<int8_t>(m);
    else
      static_cast<float*>(out)[idx] = m;
  }
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

// out[N, PHo, PWo, OC] = VALID pk x pk / ps max pool of the stem's
// epilogue(conv(x[N, Hp, Wp, IC], w[k, k, IC, OC])): int8 codes at
// mid_scale when has_mid (the static chain; the scale passes through the
// max), else f32.  tp x tp pooled outputs and ocb channels per block; smem
// is the wrapper's count of the dynamic shared memory that takes.  Returns
// cudaGetLastError().
extern "C" int low_channel_conv_max(
    const void* x, const void* w, const void* bias, const void* w_scale,
    float a_scale, void* out, int n, int hp, int wp, int ic, int oc, int k,
    int stride, int act, int has_mid, float mid_scale, int pk, int ps,
    int pho, int pwo, int tp, int ocb, int smem, void* stream) {
  const dim3 grid(((pho + tp - 1) / tp) * ((pwo + tp - 1) / tp),
                  (oc + ocb - 1) / ocb, n);
  low_channel_max_kernel<<<grid, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(w_scale),
      a_scale, out, hp, wp, ic, oc, k, stride, act, has_mid, mid_scale, pk,
      ps, pho, pwo, tp, ocb);
  return static_cast<int>(cudaGetLastError());
}
