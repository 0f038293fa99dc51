// MISC core on Hopper: the standalone residual add and the VALID average
// pool of an unfused program.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/misc_pe.py:
//   _add_kernel (:22) of misc_add        -> misc_add
//   _avgpool_kernel (:62) of avgpool2d   -> misc_avgpool2d
//
// What bounds it on the H100: both are one pass with a handful of flops per
// byte (the add reads two int8 codes and writes one), so they are bound by
// bytes, and at the sizes the models give them (0.1-10 MB a call) by how
// many bytes a warp keeps in flight and how few instructions an element
// costs.  The TPU kernel's flattening to 128-lane rows and its padding to
// whole blocks are layout for the TPU and are gone: the kernels index the
// flat tensor and mask the tail.
//
// misc_add, two routes (kernels/misc_pe.plan_add picks one):
//   * add_vec_kernel<TA, TB, OUT8, ACT, V>, where a, b and out start on 16
//     bytes: a thread takes one group of V elements a grid step, each
//     operand's group as whole words (16 int8 codes as one uint4 when both
//     operands are int8, V = 16; else V = 4: four f32 as one float4, four
//     codes as one 32-bit word), and loads the next step's words before
//     this step's adds.  int8 codes become floats without a conversion
//     instruction (one byte permute and one add a code), the act is a
//     template argument, the requant multiplies by the reciprocal of the
//     scale, a group with a value near a tie redone by one FMA a value
//     (epilogue.cuh requant_biased / qdq_biased_exact, bitwise the
//     division for 2^-100 <= os <= 2^100; the planner sends other scales
//     to the scalar route; a branch to the division had cost a group
//     several us: PERF.md section 6), and codes are packed into words by
//     byte permutes.  The grid fills the card once (kernels/misc_pe.
//     plan_add; scripts/cnn_probe.py --misc times its caps); the first
//     block takes the n % V tail.
//   * add_kernel<TA, TB>: one element a thread, any alignment (a view with
//     a storage offset): the first port's kernel, kept as it was.
//
// avgpool2d: avgpool_kernel<T, L, K>, one output position and L channels a
// thread (L = 4: one float4 or one 32-bit word of codes; L = 1 where C % 4
// or the map's alignment forbids it, or where four would leave the card
// idle), the window K a template argument for the repo's windows (2, 3, 5,
// 7; K = 0 reads it at run time): the taps are unrolled and a window row's
// loads are issued before its adds (the scheduler may hoist later rows'
// loads too), so a thread waits out K memory latencies or fewer, not
// K * K.  The sum keeps the reference's order: from zero, one __fadd_rn a
// tap in (kh, kw) order, then __fdiv_rn by K * K (no reciprocal: the
// output is the f32 quotient itself).
#include <type_traits>

#include "epilogue.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;          // the add's blocks, both routes

__device__ __forceinline__ float load_f(const int8_t* p, size_t i) {
  return static_cast<float>(p[i]);
}
__device__ __forceinline__ float load_f(const float* p, size_t i) {
  return p[i];
}

// ---------------------------------------------------------------------------
// misc_add, scalar route
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// misc_add, vector route
// ---------------------------------------------------------------------------

template <int BYTES> struct WordOf;
template <> struct WordOf<4> { using type = unsigned; };
template <> struct WordOf<8> { using type = uint2; };
template <> struct WordOf<16> { using type = uint4; };

// V elements of T as whole words: one word of V * sizeof(T) bytes up to 16,
// else 16-byte words.
template <typename T, int V>
struct Pack {
  static constexpr int BYTES = V * static_cast<int>(sizeof(T));
  static constexpr int WB = BYTES < 16 ? BYTES : 16;
  static constexpr int NW = BYTES / WB;
  using W = typename WordOf<WB>::type;
  W w[NW];

  __device__ __forceinline__ void load(const T* p) {
    const W* q = reinterpret_cast<const W*>(p);
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = q[i];
  }
  __device__ __forceinline__ void store(T* p) const {
    W* q = reinterpret_cast<W*>(p);
#pragma unroll
    for (int i = 0; i < NW; ++i) q[i] = w[i];
  }
  __device__ __forceinline__ unsigned u32(int j) const {
    return reinterpret_cast<const unsigned*>(w)[j];
  }
  __device__ __forceinline__ void set_u32(int j, unsigned v) {
    reinterpret_cast<unsigned*>(w)[j] = v;
  }
};

// The value of code i (0..3) of word x, with x ^ 0x80808080 given: the
// bits 0x4B0000uu are 2^23 + u for u = code + 128, and 2^23 + 128 taken
// off leaves the code; both steps are exact, so it equals
// static_cast<float>(code), without a conversion instruction.
__device__ __forceinline__ float code_at(unsigned flipped, int i) {
  return __fsub_rn(__int_as_float(static_cast<int>(
                       __byte_perm(flipped, 0x4B000000u, 0x7440u + i))),
                   8388736.f);
}

// Element e of a pack as a float.
template <int V>
__device__ __forceinline__ float elem(const Pack<float, V>& p, int e) {
  return __uint_as_float(p.u32(e));
}
template <int V>
__device__ __forceinline__ float elem(const Pack<int8_t, V>& p, int e) {
  return code_at(p.u32(e / 4) ^ 0x80808080u, e % 4);
}

// act(a * sa + b * sb) of element e of a group.
template <int ACT, int V, typename TA, typename TB>
__device__ __forceinline__ float add_value(const Pack<TA, V>& pa,
                                           const Pack<TB, V>& pb, int e,
                                           float sa, float sb) {
  return apply_act(
      __fadd_rn(__fmul_rn(elem(pa, e), sa), __fmul_rn(elem(pb, e), sb)),
      ACT);
}

// Four code words (low bytes) as one 32-bit word.
__device__ __forceinline__ unsigned pack4(const unsigned (&c)[4]) {
  return __byte_perm(__byte_perm(c[0], c[1], 0x0040u),
                     __byte_perm(c[2], c[3], 0x0040u), 0x5410u);
}

// One group, stored as one pack of out: f32, or codes requantized at os
// (rcp = __frcp_rn(os)) by the multiply, packed four to a word.  A value
// near a tie is redone after the store by epilogue.cuh's qdq_biased_exact
// (bitwise the division; one FMA, no division) from its operands at a / b
// and its byte rewritten, so the unrolled loop holds no branch and the
// redo's code stays one small loop.
template <bool OUT8, int ACT, int V, typename TA, typename TB, typename TO>
__device__ __forceinline__ void add_group(TO* o, const TA* a, const TB* b,
                                          const Pack<TA, V>& pa,
                                          const Pack<TB, V>& pb, float sa,
                                          float sb, float os, float rcp) {
  Pack<TO, V> po;
  if constexpr (OUT8) {
    unsigned ties = 0, bytes[4];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      bool near;
      bytes[e % 4] = __float_as_uint(
          requant_biased(add_value<ACT>(pa, pb, e, sa, sb), rcp, near));
      ties |= near ? 1u << e : 0u;
      if (e % 4 == 3) po.set_u32(e / 4, pack4(bytes));
    }
    po.store(o);
    for (; ties; ties &= ties - 1) {
      const int e = __ffs(ties) - 1;
      const float x = apply_act(__fadd_rn(__fmul_rn(load_f(a, e), sa),
                                          __fmul_rn(load_f(b, e), sb)),
                                ACT);
      o[e] = static_cast<int8_t>(__float_as_uint(qdq_biased_exact(x, os,
                                                                  rcp)));
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      po.set_u32(e, __float_as_uint(add_value<ACT>(pa, pb, e, sa, sb)));
    po.store(o);
  }
}

// A thread takes one group a grid step, consecutive threads consecutive
// groups; the next step's words are loaded before this step's adds, so a
// thread keeps two words of each operand in flight while the grid strides
// (two groups a step, each step's loads before its adds, measured slower:
// PERF.md section 6).
template <typename TA, typename TB, bool OUT8, int ACT, int V>
__global__ void __launch_bounds__(THREADS)
add_vec_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
               void* __restrict__ out, size_t n, float sa, float sb,
               float os) {
  using TO = typename std::conditional<OUT8, int8_t, float>::type;
  TO* o = static_cast<TO*>(out);
  const size_t groups = n / V;
  const float rcp = OUT8 ? __frcp_rn(os) : 0.f;
  const size_t step = (size_t)gridDim.x * THREADS;
  size_t g = blockIdx.x * (size_t)THREADS + threadIdx.x;
  Pack<TA, V> pa;
  Pack<TB, V> pb;
  if (g < groups) {
    pa.load(a + g * V);
    pb.load(b + g * V);
  }
  for (; g < groups; g += step) {
    Pack<TA, V> na;
    Pack<TB, V> nb;
    if (g + step < groups) {
      na.load(a + (g + step) * V);
      nb.load(b + (g + step) * V);
    }
    add_group<OUT8, ACT>(o + g * V, a + g * V, b + g * V, pa, pb, sa, sb,
                         os, rcp);
    pa = na;
    pb = nb;
  }
  // the n % V elements past the last whole group
  const size_t i = groups * V + threadIdx.x;
  if (blockIdx.x == 0 && i < n) {
    const float x = apply_act(
        __fadd_rn(__fmul_rn(load_f(a, i), sa), __fmul_rn(load_f(b, i), sb)),
        ACT);
    if constexpr (OUT8)
      o[i] = static_cast<int8_t>(__float_as_uint(qdq_biased_exact(x, os,
                                                                   rcp)));
    else
      o[i] = x;
  }
}

// ---------------------------------------------------------------------------
// avgpool2d
// ---------------------------------------------------------------------------

// L channels of a tap as floats.
template <int L> struct Lanes { float v[L]; };

__device__ __forceinline__ Lanes<1> load_lanes1(const float* p) {
  return {{__ldg(p)}};
}
__device__ __forceinline__ Lanes<1> load_lanes1(const int8_t* p) {
  return {{static_cast<float>(__ldg(p))}};
}
__device__ __forceinline__ Lanes<4> load_lanes4(const float* p) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  return {{f.x, f.y, f.z, f.w}};
}
__device__ __forceinline__ Lanes<4> load_lanes4(const int8_t* p) {
  const unsigned fl = __ldg(reinterpret_cast<const unsigned*>(p)) ^
                      0x80808080u;
  return {{code_at(fl, 0), code_at(fl, 1), code_at(fl, 2), code_at(fl, 3)}};
}
template <int L, typename T>
__device__ __forceinline__ Lanes<L> load_lanes(const T* p) {
  if constexpr (L == 4) return load_lanes4(p);
  else return load_lanes1(p);
}

// One window row of R taps (R a template argument: loads first, then the
// adds in order).
template <int L, int R, typename T>
__device__ __forceinline__ void add_row(float (&s)[L], const T* row,
                                        int c) {
  Lanes<L> v[R];
#pragma unroll
  for (int kw = 0; kw < R; ++kw) v[kw] = load_lanes<L>(row + kw * c);
#pragma unroll
  for (int kw = 0; kw < R; ++kw)
#pragma unroll
    for (int l = 0; l < L; ++l) s[l] = __fadd_rn(s[l], v[kw].v[l]);
}

// out[N, Ho, Wo, C] = (sum over the k x k taps, in (kh, kw) order from
// zero) / (k * k), in float32; `threads` = N * Ho * Wo * C / L.
template <typename T, int L, int K>
__global__ void __launch_bounds__(256)
avgpool_kernel(const T* __restrict__ x, float* __restrict__ out, int h,
               int w, int c, int k_rt, int stride, int ho, int wo,
               unsigned threads) {
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= threads) return;
  const unsigned cl = static_cast<unsigned>(c / L);
  const int ch = static_cast<int>(idx % cl) * L;
  unsigned t = idx / cl;
  const int ow = static_cast<int>(t % static_cast<unsigned>(wo));
  t /= static_cast<unsigned>(wo);
  const int oh = static_cast<int>(t % static_cast<unsigned>(ho));
  const size_t bi = t / static_cast<unsigned>(ho);
  const T* xb = x + ((bi * h + (size_t)oh * stride) * w +
                     (size_t)ow * stride) * c + ch;
  const size_t row = (size_t)w * c;
  const int k = K > 0 ? K : k_rt;
  float s[L];
#pragma unroll
  for (int l = 0; l < L; ++l) s[l] = 0.f;
  if constexpr (K > 0) {
#pragma unroll
    for (int kh = 0; kh < K; ++kh) add_row<L, K>(s, xb + kh * row, c);
  } else {
    for (int kh = 0; kh < k; ++kh)
      for (int kw = 0; kw < k; ++kw) {
        const Lanes<L> v = load_lanes<L>(xb + kh * row + (size_t)kw * c);
#pragma unroll
        for (int l = 0; l < L; ++l) s[l] = __fadd_rn(s[l], v.v[l]);
      }
  }
  const float kk = static_cast<float>(k * k);
  float* o = out + (size_t)idx * L;
  if constexpr (L == 4) {
    *reinterpret_cast<float4*>(o) =
        make_float4(__fdiv_rn(s[0], kk), __fdiv_rn(s[1], kk),
                    __fdiv_rn(s[2], kk), __fdiv_rn(s[3], kk));
  } else {
    o[0] = __fdiv_rn(s[0], kk);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

template <typename TA, typename TB>
int launch_add(const void* a, const void* b, void* out, size_t n, int vec,
               unsigned grid, cudaStream_t s, float sa, float sb, int act,
               int out_int8, float os) {
  const auto pa = static_cast<const TA*>(a);
  const auto pb = static_cast<const TB*>(b);
  if (vec == 1) {
    add_kernel<TA, TB><<<grid, THREADS, 0, s>>>(pa, pb, out, n, sa, sb, act,
                                                out_int8, os);
    return 0;
  }
  // 16 codes a word with two int8 operands, else four elements a word
  constexpr int V = sizeof(TA) == 1 && sizeof(TB) == 1 ? 16 : 4;
  // qdq_biased_exact's range of scales
  if (vec != V || (out_int8 && !(os >= 0x1p-100f && os <= 0x1p100f)))
    return static_cast<int>(cudaErrorInvalidValue);
#define MISC_ADD_VEC(OUT8, ACT)                                             \
  if (!out_int8 == !OUT8 && act == ACT) {                                   \
    add_vec_kernel<TA, TB, OUT8, ACT, V><<<grid, THREADS, 0, s>>>(          \
        pa, pb, out, n, sa, sb, os);                                        \
    return 0;                                                               \
  }
  MISC_ADD_VEC(true, ACT_NONE)
  MISC_ADD_VEC(true, ACT_RELU)
  MISC_ADD_VEC(true, ACT_RELU6)
  MISC_ADD_VEC(false, ACT_NONE)
  MISC_ADD_VEC(false, ACT_RELU)
  MISC_ADD_VEC(false, ACT_RELU6)
#undef MISC_ADD_VEC
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[n] = act(a[n] * sa + b[n] * sb) (+ requant at os when out_int8); a
// is int8 (a_f32 = 0) or f32, and so, on its own, is b.  The plan
// (kernels/misc_pe.plan_add): vec = 1 the scalar route; else the vector
// route at vec elements a group (16 with two int8 operands, else 4; a, b
// and out on 16 bytes; an int8 out at 2^-100 <= os <= 2^100); `blocks`
// blocks of 256 threads.  Returns
// cudaErrorInvalidValue for a plan it has no kernel for, else
// cudaGetLastError().
extern "C" int misc_add(const void* a, const void* b, void* out, long long n,
                        int a_f32, int b_f32, float sa, float sb, int act,
                        int out_int8, float os, int vec, int blocks,
                        void* stream) {
  if (n <= 0) return 0;
  const auto off16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (blocks <= 0 || (vec > 1 && (off16(a) || off16(b) || off16(out))))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t m = static_cast<size_t>(n);
  const unsigned g = static_cast<unsigned>(blocks);
  int err;
  if (a_f32 && b_f32)
    err = launch_add<float, float>(a, b, out, m, vec, g, s, sa, sb, act,
                                   out_int8, os);
  else if (a_f32)
    err = launch_add<float, int8_t>(a, b, out, m, vec, g, s, sa, sb, act,
                                    out_int8, os);
  else if (b_f32)
    err = launch_add<int8_t, float>(a, b, out, m, vec, g, s, sa, sb, act,
                                    out_int8, os);
  else
    err = launch_add<int8_t, int8_t>(a, b, out, m, vec, g, s, sa, sb, act,
                                     out_int8, os);
  return err ? err : static_cast<int>(cudaGetLastError());
}

template <typename T, int L>
int launch_pool(const void* x, void* out, int h, int w, int c, int k,
                int kt, int stride, int ho, int wo, unsigned threads,
                int block, int blocks, cudaStream_t s) {
  const auto px = static_cast<const T*>(x);
  const auto po = static_cast<float*>(out);
#define MISC_POOL(K)                                                        \
  if (kt == K) {                                                            \
    avgpool_kernel<T, L, K><<<blocks, block, 0, s>>>(px, po, h, w, c, k,    \
                                                     stride, ho, wo,        \
                                                     threads);              \
    return 0;                                                               \
  }
  MISC_POOL(0)
  MISC_POOL(2)
  MISC_POOL(3)
  MISC_POOL(5)
  MISC_POOL(7)
#undef MISC_POOL
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[N, Ho, Wo, C] f32 = VALID k x k / stride average of x[N, H, W, C]
// (int8 codes when in_f32 = 0, else f32).  The plan
// (kernels/misc_pe.plan_avgpool): `lanes` channels a thread (4: C % 4 == 0
// and x on 16 bytes for f32, 4 for int8; else 1), the window's
// instantiation `kt` (k itself for 2, 3, 5, 7; 0 reads k at run time),
// `blocks` blocks of `block` threads (64 to 256).  Returns
// cudaErrorInvalidValue for a plan it has no kernel for, else
// cudaGetLastError().
extern "C" int misc_avgpool2d(const void* x, void* out, int n, int h, int w,
                              int c, int k, int stride, int ho, int wo,
                              int in_f32, int lanes, int kt, int block,
                              int blocks, void* stream) {
  const size_t total = (size_t)n * ho * wo * c;
  if (total == 0) return 0;
  if ((lanes != 1 && lanes != 4) || c % lanes || (kt != 0 && kt != k) ||
      block < 32 || block > 256 || block % 32 || blocks <= 0 ||
      total / lanes > 0x7fffffffull ||
      (size_t)blocks * block < total / lanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned threads = static_cast<unsigned>(total / lanes);
  int err;
  if (in_f32)
    err = lanes == 4
              ? launch_pool<float, 4>(x, out, h, w, c, k, kt, stride, ho, wo,
                                      threads, block, blocks, s)
              : launch_pool<float, 1>(x, out, h, w, c, k, kt, stride, ho, wo,
                                      threads, block, blocks, s);
  else
    err = lanes == 4
              ? launch_pool<int8_t, 4>(x, out, h, w, c, k, kt, stride, ho,
                                       wo, threads, block, blocks, s)
              : launch_pool<int8_t, 1>(x, out, h, w, c, k, kt, stride, ho,
                                       wo, threads, block, blocks, s);
  return err ? err : static_cast<int>(cudaGetLastError());
}
