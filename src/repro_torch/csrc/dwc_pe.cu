// DWC PE on Hopper: k x k depthwise convolution over an NHWC int8 map with
// its SAME halo read in place, int32 accumulation, per-channel dequant,
// bias, act and requant; and the causal temporal (1-D) depthwise conv of
// the mamba mixer, in f32.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dwc_pe.py:
//   dwc2d, _dwc2d_kernel (:40)                 -> dwc_pe_dwc2d
//   dwc1d_causal, _dwc1d_kernel (:157)         -> dwc_pe_dwc1d
//
// What bounds it on the H100: a depthwise conv does 2*k*k ops per output
// and has no reduction over channels, so it cannot use the tensor cores and
// is bound by bytes -- the int8 input map read once and the int8 output
// written once (MobileNetV2's 17 layers: 0.0073 ms at 3.35 TB/s).  Every
// layer is a small grid, so the launch (~1.2 us) and the instructions per
// output set the time, and the design cuts the instructions:
// * The map is read UNPADDED: the SAME pads (top, left) come in as
//   arguments and a tap outside the map reads zero by predication (a halo
//   row is skipped whole), so no padded copy is made ahead of the call.
// * Grid (channel groups x W runs, Ho, N): the output row and the image come
//   from blockIdx.y / .z, the channel group and the run from one 32-bit
//   divide a thread -- no 64-bit divide or mod per output.
// * The vector route (k 3 or 5, stride 1 or 2, C % 4 == 0): a thread owns 4
//   neighbouring channels (one 32-bit word) of a run of R consecutive
//   outputs along W.  For each of the k input rows it loads the (R - 1) * S
//   + k words of its run once, with that row's k weight words, and slides
//   the taps over them in registers.  A tap of channel e is one __dp4a of
//   the packed input word against the weight word with every byte but e's
//   masked to zero (__dp4a sign-extends the bytes itself), so no byte is
//   unpacked.  Its bias and w_scale load once; the int32 sums stay in
//   registers, the epilogue runs on them and each output goes out as one
//   32-bit store (f32: one float4).  Channels are innermost, so
//   neighbouring threads read and write neighbouring words; an input row
//   serves k output rows of other blocks through L1 / L2.
//   kernels/dwc_pe.plan_dwc2d picks R at k 3: the longest run (1, 2 or 4)
//   whose grid keeps 48 Ki threads, so the large early layers reuse each
//   loaded word over 4 outputs and the small late ones keep the SMs busy.
//   k 5 takes run 1 alone: no probe has timed a longer one there.  Four
//   channels a thread beat sixteen (16-byte vectors) at every MobileNetV2
//   layer but one, by up to 2x on the small ones (scripts/cnn_probe.py).
// * The scalar route (any C, k, stride, alignment): one channel of one
//   output a thread, taps and weights read through L1.
// * The epilogue is epilogue.cuh's arithmetic, bit for bit, at a third of
//   its cost: no conversion instruction (small_int2float, code_int; the
//   conversion pipe runs at an eighth of the FP32 rate), and the requant's
//   IEEE division -- 30% of the kernel's time at MobileNetV2's shapes --
//   a multiply by the reciprocal wherever that cannot move the code
//   (qdq_code_rcp).
// Channels are not padded: the TPU's 128-lane padding has no counterpart.
// The integer sums are exact in any order and the epilogue gives the
// plain version's bits on both routes.
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

constexpr int THREADS = 256;    // dwc1d's blocks
constexpr int DW_THREADS = 128; // dwc2d's blocks (DWC2D_THREADS)

// One dwc2d call: x [N, H, W, C] and out [N, Ho, Wo, C] NHWC, w [k, k, C];
// pt / pl the SAME pads before the first row / column (the bottom and
// right halo follow from Ho / Wo).
struct Dwc2d {
  const int8_t* x;
  const int8_t* w;
  const float* bias;      // [C] or nullptr
  const float* w_scale;   // [C]
  float a_scale;
  void* out;              // int8 codes at os, or f32
  int h, wd, c, ho, wo, pt, pl, act, out_int8;
  float os;
};

// dequant, bias, act in dequant_bias_act's order (|acc| <= 25 * 127^2)
__device__ __forceinline__ float dwc_value(int acc, float a_scale, float ws,
                                           bool has_bias, float bv,
                                           int act) {
  float v = __fmul_rn(__fmul_rn(small_int2float(acc), a_scale), ws);
  if (has_bias) v = __fadd_rn(v, bv);
  return apply_act(v, act);
}

// grid (ceil(C / 4 * ceil(Wo / R) / DW_THREADS), Ho, N).  Thread: channels
// [ch0, ch0 + 4) of outputs wo0 .. wo0 + R - 1 of row oh of image b; K x K
// taps at stride S.
template <int K, int S, int R>
__global__ void __launch_bounds__(DW_THREADS)
dwc_vec_kernel(const Dwc2d p) {
  constexpr int COLS = (R - 1) * S + K;
  const int groups = p.c / 4;
  const int idx = blockIdx.x * DW_THREADS + threadIdx.x;
  if (idx >= groups * ((p.wo + R - 1) / R)) return;
  const int ch0 = idx % groups * 4, wo0 = idx / groups * R;
  const int oh = blockIdx.y, b = blockIdx.z;
  int acc[R][4];
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0;
  const int col0 = wo0 * S - p.pl;
#pragma unroll
  for (int kh = 0; kh < K; ++kh) {
    const int ih = oh * S - p.pt + kh;
    if (ih < 0 || ih >= p.h) continue;          // a halo row: all zero
    const int8_t* row = p.x + ((size_t)b * p.h + ih) * p.wd * p.c + ch0;
    unsigned xv[COLS], wv[K];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int col = col0 + j;
      xv[j] = col >= 0 && col < p.wd
                  ? __ldg(reinterpret_cast<const unsigned*>(row + col * p.c))
                  : 0u;
    }
#pragma unroll
    for (int kw = 0; kw < K; ++kw)
      wv[kw] = __ldg(reinterpret_cast<const unsigned*>(
          p.w + (kh * K + kw) * p.c + ch0));
#pragma unroll
    for (int j = 0; j < COLS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int kw = j - u * S;
          if (kw >= 0 && kw < K)
            acc[u][e] = __dp4a(static_cast<int>(xv[j]),
                               static_cast<int>(wv[kw] & (0xffu << 8 * e)),
                               acc[u][e]);
        }
  }
  float ws[4], bv[4];
  const bool has_bias = p.bias != nullptr;
  const float rcp = requant_rcp(p.os);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ws[e] = __ldg(p.w_scale + ch0 + e);
    bv[e] = has_bias ? __ldg(p.bias + ch0 + e) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int ow = wo0 + u;
    if (ow >= p.wo) break;
    const size_t o = (((size_t)b * p.ho + oh) * p.wo + ow) * p.c + ch0;
    if (p.out_int8) {
      unsigned pk = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int code = code_int(qdq_code_rcp(
            dwc_value(acc[u][e], p.a_scale, ws[e], has_bias, bv[e], p.act),
            p.os, rcp));
        pk |= (static_cast<unsigned>(code) & 0xffu) << (8 * e);
      }
      *reinterpret_cast<unsigned*>(static_cast<int8_t*>(p.out) + o) = pk;
    } else {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[e] = dwc_value(acc[u][e], p.a_scale, ws[e], has_bias, bv[e],
                         p.act);
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + o) =
          make_float4(f[0], f[1], f[2], f[3]);
    }
  }
}

// The scalar route: any C, k and stride; one channel of one output a
// thread, its taps and weights read through L1.  grid (ceil(C * Wo /
// DW_THREADS), Ho, N).
__global__ void __launch_bounds__(DW_THREADS)
dwc_scalar_kernel(const Dwc2d p, int k, int stride) {
  const int idx = blockIdx.x * DW_THREADS + threadIdx.x;
  if (idx >= p.c * p.wo) return;
  const int ch = idx % p.c, ow = idx / p.c;
  const int oh = blockIdx.y, b = blockIdx.z;
  int acc = 0;
  for (int kh = 0; kh < k; ++kh) {
    const int ih = oh * stride - p.pt + kh;
    if (ih < 0 || ih >= p.h) continue;
    const int8_t* row = p.x + ((size_t)b * p.h + ih) * p.wd * p.c + ch;
    for (int kw = 0; kw < k; ++kw) {
      const int iw = ow * stride - p.pl + kw;
      if (iw >= 0 && iw < p.wd)
        acc += static_cast<int>(__ldg(row + iw * p.c)) *
               static_cast<int>(__ldg(p.w + (kh * k + kw) * p.c + ch));
    }
  }
  const float v = dequant_bias_act(acc, p.a_scale, __ldg(p.w_scale + ch),
                                   p.bias, ch, p.act);
  const size_t o = (((size_t)b * p.ho + oh) * p.wo + ow) * p.c + ch;
  if (p.out_int8)
    static_cast<int8_t*>(p.out)[o] = static_cast<int8_t>(qdq_code(v, p.os));
  else
    static_cast<float*>(p.out)[o] = v;
}

template <int K, int S, int R>
int launch_dwc(const Dwc2d& p, int n, cudaStream_t st) {
  const int threads = p.c / 4 * ((p.wo + R - 1) / R);
  const dim3 grid((threads + DW_THREADS - 1) / DW_THREADS, p.ho, n);
  dwc_vec_kernel<K, S, R><<<grid, DW_THREADS, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// k 3 at runs 1, 2 and 4; k 5 at run 1 alone (DWC2D_RUNS)
template <int S>
int launch_dwc_r(const Dwc2d& p, int n, int k, int r, cudaStream_t st) {
  if (k == 3 && r == 1) return launch_dwc<3, S, 1>(p, n, st);
  if (k == 3 && r == 2) return launch_dwc<3, S, 2>(p, n, st);
  if (k == 3 && r == 4) return launch_dwc<3, S, 4>(p, n, st);
  if (k == 5 && r == 1) return launch_dwc<5, S, 1>(p, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
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

// out[N, Ho, Wo, C] = epilogue(depthwise(SAME-padded x[N, H, W, C],
// w[k, k, C])), the pads pt (top) and pl (left) read as zeros in place.
// v: 4, the vector route (k 3 or 5, stride 1 or 2, C % 4 == 0, x and w on
// 4 bytes), r outputs a thread (k 3: 1, 2 or 4; k 5: 1); v = 1 (r = 1):
// the scalar route, any C, k and stride.  Returns cudaErrorInvalidValue for
// a plan it does not take, else cudaGetLastError().
extern "C" int dwc_pe_dwc2d(const void* x, const void* w, const void* bias,
                            const void* w_scale, float a_scale, void* out,
                            int n, int h, int wd, int c, int k, int stride,
                            int ho, int wo, int pt, int pl, int v, int r,
                            int act, int out_int8, float os, void* stream) {
  constexpr int bad = static_cast<int>(cudaErrorInvalidValue);
  const Dwc2d p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                static_cast<const float*>(bias),
                static_cast<const float*>(w_scale), a_scale, out, h, wd, c,
                ho, wo, pt, pl, act, out_int8, os};
  const auto st = static_cast<cudaStream_t>(stream);
  if (n < 1 || ho < 1 || wo < 1 || c < 1 || ho > 65535 || n > 65535)
    return bad;
  if (v == 1) {
    if (r != 1) return bad;
    const dim3 grid((c * wo + DW_THREADS - 1) / DW_THREADS, ho, n);
    dwc_scalar_kernel<<<grid, DW_THREADS, 0, st>>>(p, k, stride);
    return static_cast<int>(cudaGetLastError());
  }
  if (v != 4 || c % 4 || reinterpret_cast<uintptr_t>(x) % 4 ||
      reinterpret_cast<uintptr_t>(w) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return bad;
  if (stride == 1) return launch_dwc_r<1>(p, n, k, r, st);
  if (stride == 2) return launch_dwc_r<2>(p, n, k, r, st);
  return bad;
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
