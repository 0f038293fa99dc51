// MISC core on Hopper: the standalone residual add and the VALID average
// pool of an unfused program.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/misc_pe.py:
//   _add_kernel (:22) of misc_add        -> misc_add
//   _avgpool_kernel (:62) of avgpool2d   -> misc_avgpool2d
//
// What bounds it on the H100: both are one pass with a handful of flops per
// byte (the add reads two int8 codes and writes one), so they are bound by
// bytes.  The design reads each operand once and keeps everything between
// in registers: one thread per output element, consecutive threads on
// consecutive elements (channels innermost for the pool), so a warp's loads
// and stores are contiguous.  The TPU kernel's flattening to 128-lane rows
// and its padding to whole blocks are layout for the TPU and are gone: the
// kernel indexes the flat tensor and masks the tail.
#include "epilogue.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;

__device__ __forceinline__ float load_f(const int8_t* p, size_t i) {
  return static_cast<float>(p[i]);
}
__device__ __forceinline__ float load_f(const float* p, size_t i) {
  return p[i];
}

// out = act(a * sa + b * sb), requantized at os when out_int8.  Each
// operand is int8 codes or f32 on its own, as the TPU kernel casts each:
// an LM add of the f32 residual stream and an int8 edge mixes them.
template <typename TA, typename TB>
__global__ void __launch_bounds__(THREADS)
add_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
           void* __restrict__ out, size_t n, float sa, float sb, int act,
           int out_int8, float os) {
  const size_t stride = (size_t)gridDim.x * THREADS;
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < n;
       i += stride) {
    const float x = apply_act(
        __fadd_rn(__fmul_rn(load_f(a, i), sa), __fmul_rn(load_f(b, i), sb)),
        act);
    if (out_int8)
      static_cast<int8_t*>(out)[i] = static_cast<int8_t>(qdq_code(x, os));
    else
      static_cast<float*>(out)[i] = x;
  }
}

// out[N, Ho, Wo, C] = (sum over the k x k taps, in (kh, kw) order from
// zero) / (k * k), in float32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
avgpool_kernel(const T* __restrict__ x, float* __restrict__ out, int h,
               int w, int c, int k, int stride, int ho, int wo,
               size_t total) {
  const size_t idx = blockIdx.x * (size_t)THREADS + threadIdx.x;
  if (idx >= total) return;
  const int ch = static_cast<int>(idx % c);
  size_t t = idx / c;
  const int ow = static_cast<int>(t % wo);
  t /= wo;
  const int oh = static_cast<int>(t % ho);
  const size_t b = t / ho;
  const T* xb = x + ((b * h + (size_t)oh * stride) * w +
                     (size_t)ow * stride) * c + ch;
  float s = 0.f;
  for (int kh = 0; kh < k; ++kh)
    for (int kw = 0; kw < k; ++kw)
      s = __fadd_rn(s, load_f(xb, ((size_t)kh * w + kw) * c));
  out[idx] = __fdiv_rn(s, static_cast<float>(k * k));
}

unsigned blocks_for(size_t n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace

template <typename TA, typename TB>
void launch_add(const void* a, const void* b, void* out, size_t n,
                unsigned grid, cudaStream_t s, float sa, float sb, int act,
                int out_int8, float os) {
  add_kernel<TA, TB><<<grid, THREADS, 0, s>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), out, n, sa, sb,
      act, out_int8, os);
}

// out[n] = act(a[n] * sa + b[n] * sb) (+ requant at os when out_int8); a
// is int8 (a_f32 = 0) or f32, and so, on its own, is b.  Returns
// cudaGetLastError().
extern "C" int misc_add(const void* a, const void* b, void* out, long long n,
                        int a_f32, int b_f32, float sa, float sb, int act,
                        int out_int8, float os, void* stream) {
  if (n <= 0) return 0;
  // a grid-stride loop: enough blocks to fill the card, no more
  const unsigned grid = blocks_for(n) < 132u * 16u ? blocks_for(n)
                                                   : 132u * 16u;
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t m = static_cast<size_t>(n);
  if (a_f32 && b_f32)
    launch_add<float, float>(a, b, out, m, grid, s, sa, sb, act, out_int8, os);
  else if (a_f32)
    launch_add<float, int8_t>(a, b, out, m, grid, s, sa, sb, act, out_int8,
                              os);
  else if (b_f32)
    launch_add<int8_t, float>(a, b, out, m, grid, s, sa, sb, act, out_int8,
                              os);
  else
    launch_add<int8_t, int8_t>(a, b, out, m, grid, s, sa, sb, act, out_int8,
                               os);
  return static_cast<int>(cudaGetLastError());
}

// out[N, Ho, Wo, C] f32 = VALID k x k / stride average of x[N, H, W, C]
// (int8 codes when in_f32 = 0, else f32).  Returns cudaGetLastError().
extern "C" int misc_avgpool2d(const void* x, void* out, int n, int h, int w,
                              int c, int k, int stride, int ho, int wo,
                              int in_f32, void* stream) {
  const size_t total = (size_t)n * ho * wo * c;
  if (total == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (in_f32)
    avgpool_kernel<float><<<blocks_for(total), THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), h, w, c, k,
        stride, ho, wo, total);
  else
    avgpool_kernel<int8_t><<<blocks_for(total), THREADS, 0, s>>>(
        static_cast<const int8_t*>(x), static_cast<float*>(out), h, w, c, k,
        stride, ho, wo, total);
  return static_cast<int>(cudaGetLastError());
}
