// Conv PE on Hopper, int4 weight-only variant: int8 activations times
// packed int4 weights, with the fused NL epilogue (plain and residual).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/conv_pe.py::
// matmul_int4_fused: _kernel_w4 (:189) and _kernel_w4_res (:208)
//                                                        -> conv_pe_w4
//
// Operands: A [M, K] int8 (row-major), P [K/2, N] uint8 (code of row 2i in
// the low nibble of byte-row i, row 2i+1 in the high nibble), per-group f16
// scale S and zero Z [G, N] (G = K / gs).  The value is
//
//   x[m, n] = sum_g S[g, n] * (A[m, g] . codes[g, n])        (acc_s)
//           + sum_g Z[g, n] * sum(A[m, g])                   (acc_z)
//
// then * a_scale, + bias, act, [qdq at mid_scale, + r * res_scale,
// add_act], requant -- kernels/ref.py::int4_group_dot and the epilogue of
// matmul_int8_fused.  Each group's integer dot is exact in int32; the f32
// combine runs group by group, g = 0, 1, ..., G-1, with explicitly rounded
// __fmul_rn / __fadd_rn (and --fmad=false), which is the order the plain
// version fixes, so the kernel equals it bit for bit.
//
// What bounds it on the H100: at decode M is the batch (4), so each packed
// weight byte feeds 8 MACs per row: the launch is bound by the weight
// bytes (packed codes + f16 scales and zeros).  At prefill M = batch x
// prompt, and the same weights serve M / 8 row tiles out of L2.  The design:
// a block owns 32 columns (one per lane, so a warp reads 32 contiguous
// bytes of a packed row) and 8 rows; the 8 warps split the K groups, and
// each unpacks nibbles in registers into int8x4 words that __dp4a
// multiplies with the staged activation words.  The groups' int32 parts go
// to shared memory, where one thread per (row, column) folds them in group
// order into its f32 sums.  Activations are staged a chunk of whole groups
// at a time (at most 1024 K values).  wgmma, TMA and split-K are later
// work; ragged M and N are masked.
#include <cuda_fp16.h>

#include "epilogue.cuh"

namespace {

using namespace repro;

constexpr int BN = 32;                  // columns per block, one per lane
constexpr int BM = 8;                   // rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;     // == BM * BN: the combine's threads
constexpr int KC = 1024;                // K values staged per chunk
constexpr int GC = 16;                  // groups per chunk at most

struct Epi {
  const float* a_scale;   // [M] per-row activation scale, or nullptr
  float a_scale_val;      // the static per-tensor scale otherwise
  const float* bias;      // [N] or nullptr
  int act;
  int out_int8;           // 1: requant to int8, 0: f32 out
  const float* os_vec;    // [N] per-column requant scale, or nullptr
  float os_val;
  const void* res;        // [M, N] residual operand (int8 or f32)
  int res_f32;
  float res_scale;
  int has_mid;            // static chain: qdq at mid_scale before the add
  float mid_scale;
  int add_act;
};

template <bool HAS_RES>
__global__ void __launch_bounds__(THREADS)
w4_kernel(const int8_t* __restrict__ A, const uint8_t* __restrict__ P,
          const __half* __restrict__ S, const __half* __restrict__ Z,
          void* __restrict__ C, int M, int N, int K, int gs, int gc_max,
          Epi e) {
  __shared__ int As[BM][KC / 4];        // staged activation words
  __shared__ int part[GC][BM][BN];      // per-group int32 dots
  __shared__ int asum[GC][BM];          // per-group activation sums
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n = n0 + lane;
  const int G = K / gs, wpg = gs / 4;   // groups; A words per group
  const int cm = tid / BN, cn = tid % BN;   // combine role
  float acc_s = 0.f, acc_z = 0.f;

  for (int g0 = 0; g0 < G; g0 += gc_max) {
    const int gc = min(gc_max, G - g0);
    const int words = gc * wpg;
    for (int i = tid; i < BM * words; i += THREADS) {
      const int r = i / words, c = i % words, gm = m0 + r;
      As[r][c] = gm < M
          ? reinterpret_cast<const int*>(A + (size_t)gm * K)[g0 * wpg + c]
          : 0;
    }
    __syncthreads();
    for (int gl = warp; gl < gc; gl += WARPS) {
      int acc[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) acc[m] = 0;
      if (n < N) {
        const uint8_t* col = P + (size_t)((g0 + gl) * gs / 2) * N + n;
        for (int kk = 0; kk < gs; kk += 4) {
          const unsigned b0 = col[(size_t)(kk / 2) * N];
          const unsigned b1 = col[(size_t)(kk / 2 + 1) * N];
          const int codes = static_cast<int>(
              (b0 & 15u) | ((b0 >> 4) << 8) | ((b1 & 15u) << 16) |
              ((b1 >> 4) << 24));
          const int w = gl * wpg + kk / 4;
#pragma unroll
          for (int m = 0; m < BM; ++m) acc[m] = __dp4a(As[m][w], codes, acc[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) part[gl][m][lane] = acc[m];
    }
    for (int i = tid; i < BM * gc; i += THREADS) {
      const int r = i / gc, gl = i % gc;
      int s = 0;
      for (int w = 0; w < wpg; ++w) s = __dp4a(As[r][gl * wpg + w], 0x01010101, s);
      asum[gl][r] = s;
    }
    __syncthreads();
    if (m0 + cm < M && n0 + cn < N) {
      for (int gl = 0; gl < gc; ++gl) {
        const size_t gi = (size_t)(g0 + gl) * N + n0 + cn;
        acc_s = __fadd_rn(acc_s, __fmul_rn(__int2float_rn(part[gl][cm][cn]),
                                           __half2float(S[gi])));
        acc_z = __fadd_rn(acc_z, __fmul_rn(__int2float_rn(asum[gl][cm]),
                                           __half2float(Z[gi])));
      }
    }
    __syncthreads();
  }

  const int m = m0 + cm, nn = n0 + cn;
  if (m >= M || nn >= N) return;
  const size_t idx = (size_t)m * N + nn;
  float x = __fadd_rn(acc_s, acc_z);
  x = __fmul_rn(x, e.a_scale != nullptr ? e.a_scale[m] : e.a_scale_val);
  if (e.bias != nullptr) x = __fadd_rn(x, e.bias[nn]);
  x = apply_act(x, e.act);
  if (HAS_RES) {
    if (e.has_mid) x = __fmul_rn(qdq_code(x, e.mid_scale), e.mid_scale);
    const float r = e.res_f32
        ? static_cast<const float*>(e.res)[idx]
        : static_cast<float>(static_cast<const int8_t*>(e.res)[idx]);
    x = apply_act(__fadd_rn(x, __fmul_rn(r, e.res_scale)), e.add_act);
  }
  if (e.out_int8) {
    const float s = e.os_vec != nullptr ? e.os_vec[nn] : e.os_val;
    static_cast<int8_t*>(C)[idx] = static_cast<int8_t>(qdq_code(x, s));
  } else {
    static_cast<float*>(C)[idx] = x;
  }
}

}  // namespace

// C = epilogue(A[M,K] x unpack(P)[K,N]) with per-group scale / zero.  gs is
// the group size (a multiple of 4, at most 1024; the wrapper checks it);
// pointers are device pointers (nullptr for an absent operand); the launch
// goes on `stream`.  Returns cudaGetLastError().
extern "C" int conv_pe_w4(const void* A, const void* P, const void* S,
                          const void* Z, void* C, int M, int N, int K, int gs,
                          const void* a_scale, float a_scale_val,
                          const void* bias, int act, int out_int8,
                          const void* os_vec, float os_val, const void* res,
                          int res_f32, float res_scale, int has_mid,
                          float mid_scale, int add_act, void* stream) {
  Epi e{static_cast<const float*>(a_scale), a_scale_val,
        static_cast<const float*>(bias), act, out_int8,
        static_cast<const float*>(os_vec), os_val, res, res_f32, res_scale,
        has_mid, mid_scale, add_act};
  const int gc_max = min(GC, KC / gs);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int8_t*>(A);
  const auto* p = static_cast<const uint8_t*>(P);
  const auto* sc = static_cast<const __half*>(S);
  const auto* z = static_cast<const __half*>(Z);
  if (res != nullptr)
    w4_kernel<true><<<grid, THREADS, 0, s>>>(a, p, sc, z, C, M, N, K, gs,
                                             gc_max, e);
  else
    w4_kernel<false><<<grid, THREADS, 0, s>>>(a, p, sc, z, C, M, N, K, gs,
                                              gc_max, e);
  return static_cast<int>(cudaGetLastError());
}
