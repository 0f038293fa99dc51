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
// once.  The input is the mamba mixer's x half of in_proj's output, a view
// [B, L, C] of rows 2C long, read in place: the kernel takes its batch and
// row strides (channels contiguous), so no copy precedes the call.  The
// vector route (C % 4 == 0, k = VK = 4 as the served mamba mixers have, a
// 16-byte aligned view): a thread owns four neighbouring channels (float4)
// of a run of VT = 2 consecutive steps of one sequence; it loads its k
// weights and the bias once into registers, loads the k - 1 steps of
// history before its run and the run's steps once, and slides the taps over
// them in registers (the history steps come again from L1 / L2 for the
// neighbouring run).  Channels are innermost, so a warp's loads and stores
// are 512 contiguous bytes of one step.  VT = 2 ran fastest of 1, 2, 4, 8
// and 16 steps a thread at the falcon-mamba prefill (PERF.md, row 10).  The
// scalar route (any C, k, alignment): one thread owns one channel of TCH
// steps and reads its taps again from L1 / L2.  No pad is materialized: a
// tap before t = 0 reads a zero.  The arithmetic is the plain version's
// (ref.dwc1d_causal) on both routes: taps in order, acc = acc + x * w
// rounded at every step (__fmul_rn / __fadd_rn), then + bias, then the
// act, with silu as torch's CUDA F.silu computes it, x / (1 + expf(-x))
// (full-precision expf, IEEE division).
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

constexpr int TCH = 8;          // time steps per thread (scalar dwc1d)

__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
}

// out = act(acc + bias); has_bias 0: acc alone
__device__ __forceinline__ float finish(float acc, bool has_bias, float bv,
                                        int silu_act) {
  if (has_bias) acc = __fadd_rn(acc, bv);
  return silu_act ? silu(acc) : acc;
}

__global__ void __launch_bounds__(THREADS)
dwc1d_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ out, int b,
             int l, int c, int k, long long sb, long long sl, int silu_act) {
  const int chunks = (l + TCH - 1) / TCH;
  const size_t idx = blockIdx.x * (size_t)THREADS + threadIdx.x;
  if (idx >= (size_t)b * chunks * c) return;
  const int ch = static_cast<int>(idx % c);
  const size_t r = idx / c;
  const int t0 = static_cast<int>(r % chunks) * TCH;
  const size_t bi = r / chunks;
  const float* xb = x + bi * sb + ch;
  float* ob = out + bi * (size_t)l * c + ch;
  const int t1 = min(t0 + TCH, l);
  for (int t = t0; t < t1; ++t) {
    float acc = 0.f;
    for (int i = 0; i < k; ++i) {
      const int src = t - (k - 1) + i;
      const float xv = src >= 0 ? xb[src * sl] : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(xv, w[i * c + ch]));
    }
    ob[(size_t)t * c] = finish(acc, bias != nullptr,
                               bias != nullptr ? bias[ch] : 0.f, silu_act);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// acc += x * w on each of the four channels, rounded at every step
__device__ __forceinline__ void tap(float4& acc, const float4& x,
                                    const float4& w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(x.x, w.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(x.y, w.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(x.z, w.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(x.w, w.w));
}

constexpr int VK = 4;           // taps of the vector route
constexpr int VT = 2;           // time steps per thread (vector dwc1d)

__global__ void __launch_bounds__(THREADS)
dwc1d_vec_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int b, int l, int c, long long sb, long long sl,
                 int silu_act) {
  const int c4 = c >> 2;
  const int runs = (l + VT - 1) / VT;
  const size_t idx = blockIdx.x * (size_t)THREADS + threadIdx.x;
  if (idx >= (size_t)b * runs * c4) return;
  const int ch = static_cast<int>(idx % c4) * 4;
  const size_t r = idx / c4;
  const int t0 = static_cast<int>(r % runs) * VT;
  const size_t bi = r / runs;
  const float* xb = x + bi * sb + ch;
  float* ob = out + bi * (size_t)l * c + ch;
  float4 wv[VK];
#pragma unroll
  for (int i = 0; i < VK; ++i) wv[i] = ld4(w + i * c + ch);
  const bool has_bias = bias != nullptr;
  const float4 bv = has_bias ? ld4(bias + ch) : make_float4(0.f, 0.f, 0.f,
                                                            0.f);
  // xs[i] = x at step t0 - (VK - 1) + i: the history, then the run
  float4 xs[VK - 1 + VT];
#pragma unroll
  for (int i = 0; i < VK - 1 + VT; ++i) {
    const int t = t0 - (VK - 1) + i;
    xs[i] = t >= 0 && t < l ? ld4(xb + t * sl) : make_float4(0.f, 0.f, 0.f,
                                                             0.f);
  }
#pragma unroll
  for (int u = 0; u < VT; ++u) {
    if (t0 + u < l) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < VK; ++i) tap(acc, xs[u + i], wv[i]);
      float4 o;
      o.x = finish(acc.x, has_bias, bv.x, silu_act);
      o.y = finish(acc.y, has_bias, bv.y, silu_act);
      o.z = finish(acc.z, has_bias, bv.z, silu_act);
      o.w = finish(acc.w, has_bias, bv.w, silu_act);
      *reinterpret_cast<float4*>(ob + (size_t)(t0 + u) * c) = o;
    }
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

// out[B, L, C] = act(causal_depthwise(x[B, L, C], w[k, C]) + bias), f32;
// x element (n, t, ch) at x + n * sb + t * sl + ch (channels contiguous),
// out contiguous.  vec: the float4 route, refused unless C % 4 == 0, k = 4,
// and x, sb and sl keep every float4 16-byte aligned; else the scalar
// route.
// silu_act: 0 none, 1 silu.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a refused route).
extern "C" int dwc_pe_dwc1d(const void* x, const void* w, const void* bias,
                            void* out, int b, int l, int c, int k,
                            long long sb, long long sl, int vec,
                            int silu_act, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto wf = static_cast<const float*>(w);
  auto bf = static_cast<const float*>(bias);
  auto of = static_cast<float*>(out);
  if (vec) {
    if (c % 4 || k != VK || sb % 4 || sl % 4 ||
        reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(w) % 16 ||
        reinterpret_cast<uintptr_t>(bias) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t total = (size_t)b * ((l + VT - 1) / VT) * (c / 4);
    const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) /
                                                  THREADS);
    dwc1d_vec_kernel<<<blocks, THREADS, 0, st>>>(xf, wf, bf, of, b, l, c, sb,
                                                 sl, silu_act);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t total = (size_t)b * ((l + TCH - 1) / TCH) * c;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) /
                                                THREADS);
  dwc1d_kernel<<<blocks, THREADS, 0, st>>>(xf, wf, bf, of, b, l, c, k, sb, sl,
                                           silu_act);
  return static_cast<int>(cudaGetLastError());
}
