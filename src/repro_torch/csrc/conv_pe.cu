// Conv PE on Hopper: int8 GEMM with int32 accumulation and the fused NL
// epilogue (plain and residual variants), plus the pooled-epilogue GEMM.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/conv_pe.py:
//   _kernel (:37) and _kernel_res (:69) of matmul_int8_fused   -> conv_pe_gemm
//   _kernel_pool (:311) of matmul_int8_pool, with and without its
//   residual operand (has_res)                                 -> conv_pe_pool
//
// What bounds it on the H100: the 1x1 convolutions of MobileNetV2 have
// K = 16..960, so a 64x64 output tile does 2*64*64*K int8 ops per
// (64 + 64)*K bytes it loads -- at most ~64 ops/byte, far under the ~590
// int8 ops/byte where the tensor cores would become the limit.  The GEMMs
// are bound by bytes (activations in, int8 codes out), and the design spends
// its effort there: the K loop runs inside the block with both operand tiles
// staged once in shared memory, the epilogue (dequant, bias, act, residual
// qdq + add, requant) runs in registers on the int32 accumulators, and only
// int8 codes are written back.  The pooled variant goes further: one block
// owns one image's ho*wo rows for 64 columns, requantizes every row in
// registers, sums the codes in int32 and writes one pooled int8 value per
// column -- the pre-pool feature map never reaches device memory.
//
// The product uses __dp4a (four int8 MACs into int32 per instruction) on
// CUDA cores; wgmma / TMA tiles come in a later change.  Ragged M / N / K
// edges are masked with zeros when the tiles are staged (a zero code adds
// nothing to an int32 sum), so nothing is padded in device memory.
#include "epilogue.cuh"

namespace {

using namespace repro;

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDS = BK + 4;     // 36-byte rows = 9 words: conflict-free
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each

struct Epi {
  const float* a_scale;   // [M] per-row activation scale, or nullptr
  float a_scale_val;      // the static per-tensor scale otherwise
  const float* w_scale;   // [N]
  const float* bias;      // [N] or nullptr
  int act;
  int out_int8;           // 1: requant to int8, 0: f32 out
  const float* os_vec;    // [N] per-column requant scale, or nullptr
  float os_val;           // the per-tensor requant scale otherwise
  const void* res;        // [M, N] residual operand (int8 or f32)
  int res_f32;
  float res_scale;
  int has_mid;            // static chain: qdq at mid_scale before the add
  float mid_scale;
  int add_act;
};

template <bool HAS_RES>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
            void* __restrict__ C, int M, int N, int K, Epi e) {
  __shared__ __align__(16) int8_t As[BM][LDS];   // As[m][k]
  __shared__ __align__(16) int8_t Bs[BN][LDS];   // Bs[n][k] (transposed)
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK, gm = m0 + r, gk = k0 + c;
      As[r][c] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : int8_t(0);
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN, gk = k0 + r, gn = n0 + c;
      Bs[c][r] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : int8_t(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const int*>(&As[ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const int*>(&Bs[tx + 16 * j][kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float asc = e.a_scale != nullptr ? e.a_scale[m] : e.a_scale_val;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const size_t idx = (size_t)m * N + n;
      float x = dequant_bias_act(acc[i][j], asc, e.w_scale[n], e.bias, n,
                                 e.act);
      if (HAS_RES) {
        if (e.has_mid) x = __fmul_rn(qdq_code(x, e.mid_scale), e.mid_scale);
        const float r = e.res_f32
            ? static_cast<const float*>(e.res)[idx]
            : static_cast<float>(static_cast<const int8_t*>(e.res)[idx]);
        x = apply_act(__fadd_rn(x, __fmul_rn(r, e.res_scale)), e.add_act);
      }
      if (e.out_int8) {
        const float s = e.os_vec != nullptr ? e.os_vec[n] : e.os_val;
        static_cast<int8_t*>(C)[idx] = static_cast<int8_t>(qdq_code(x, s));
      } else {
        static_cast<float*>(C)[idx] = x;
      }
    }
  }
}

// Pooled epilogue: grid (N / PN, G); block = PN columns x PG row groups.
// HAS_RES: the bottleneck's shortcut R [G, rows, N] int8 is added before
// the pool (qdq at mid_scale, + r * res_scale, add_act, qdq at add_scale).
constexpr int PN = 64, PG = 4, PR = 16, PKC = 64;
constexpr int PROWS = PG * PR;  // rows staged per pass

template <bool HAS_RES>
__global__ void __launch_bounds__(PN * PG)
pool_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
            void* __restrict__ C, int rows, int N, int K, float a_scale,
            const float* __restrict__ w_scale,
            const float* __restrict__ bias, int act, float mid_scale,
            const int8_t* __restrict__ R, float res_scale, int add_act,
            float add_scale, float gap_scale, int out_int8, float os_val) {
  __shared__ __align__(16) int8_t As[PROWS][PKC + 4];
  __shared__ int part[PG][PN];
  const int tx = threadIdx.x % PN, ty = threadIdx.x / PN;
  const int g = blockIdx.y, n = blockIdx.x * PN + tx;
  const int8_t* Ag = A + (size_t)g * rows * K;
  int total = 0;   // int32 sum of this thread's rows' requantized codes
  for (int r0 = 0; r0 < rows; r0 += PROWS) {
    int acc[PR];
#pragma unroll
    for (int i = 0; i < PR; ++i) acc[i] = 0;
    for (int k0 = 0; k0 < K; k0 += PKC) {
      for (int i = threadIdx.x; i < PROWS * PKC; i += PN * PG) {
        const int r = i / PKC, c = i % PKC, gr = r0 + r, gk = k0 + c;
        As[r][c] = (gr < rows && gk < K) ? Ag[(size_t)gr * K + gk]
                                          : int8_t(0);
      }
      __syncthreads();
      if (n < N) {
        for (int kk = 0; kk < PKC; kk += 4) {
          unsigned b = 0;   // four int8 codes of column n, packed
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int gk = k0 + kk + q;
            const unsigned v =
                gk < K ? static_cast<uint8_t>(B[(size_t)gk * N + n]) : 0u;
            b |= v << (8 * q);
          }
#pragma unroll
          for (int i = 0; i < PR; ++i)
            acc[i] = __dp4a(
                *reinterpret_cast<const int*>(&As[ty + PG * i][kk]),
                static_cast<int>(b), acc[i]);
        }
      }
      __syncthreads();
    }
    if (n < N) {
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        const int row = r0 + ty + PG * i;
        if (row >= rows) break;
        const float x = dequant_bias_act(acc[i], a_scale, w_scale[n], bias,
                                         n, act);
        float code = qdq_code(x, mid_scale);
        if (HAS_RES) {
          const float r = static_cast<float>(
              R[((size_t)g * rows + row) * N + n]);
          const float y = apply_act(
              __fadd_rn(__fmul_rn(code, mid_scale), __fmul_rn(r, res_scale)),
              add_act);
          code = qdq_code(y, add_scale);
        }
        total += static_cast<int>(code);
      }
    }
  }
  part[ty][tx] = total;
  __syncthreads();
  if (ty == 0 && n < N) {
    const int s = part[0][tx] + part[1][tx] + part[2][tx] + part[3][tx];
    const float y = __fmul_rn(__int2float_rn(s), gap_scale);
    const size_t idx = (size_t)g * N + n;
    if (out_int8)
      static_cast<int8_t*>(C)[idx] = static_cast<int8_t>(qdq_code(y, os_val));
    else
      static_cast<float*>(C)[idx] = y;
  }
}

}  // namespace

// C = epilogue(A[M,K] @ B[K,N]).  Pointers are device pointers (nullptr for
// an absent operand); the launch goes on `stream`.  Returns
// cudaGetLastError() so the caller sees a refused launch.
extern "C" int conv_pe_gemm(const void* A, const void* B, void* C, int M,
                            int N, int K, const void* a_scale,
                            float a_scale_val, const void* w_scale,
                            const void* bias, int act, int out_int8,
                            const void* os_vec, float os_val, const void* res,
                            int res_f32, float res_scale, int has_mid,
                            float mid_scale, int add_act, void* stream) {
  Epi e{static_cast<const float*>(a_scale), a_scale_val,
        static_cast<const float*>(w_scale), static_cast<const float*>(bias),
        act, out_int8, static_cast<const float*>(os_vec), os_val, res,
        res_f32, res_scale, has_mid, mid_scale, add_act};
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int8_t*>(A);
  const auto* b = static_cast<const int8_t*>(B);
  if (res != nullptr)
    gemm_kernel<true><<<grid, THREADS, 0, s>>>(a, b, C, M, N, K, e);
  else
    gemm_kernel<false><<<grid, THREADS, 0, s>>>(a, b, C, M, N, K, e);
  return static_cast<int>(cudaGetLastError());
}

// C[G, N] = global-pool(qdq(epilogue(A[g] @ B))) per image g, static chain:
// codes at mid_scale, int32 sum over the rows, times gap_scale (the host's
// pre-pool scale / rows rounded once to f32), requant at os_val when
// out_int8.  With R [G, rows, N] int8 (else nullptr) the residual add runs
// first and the pre-pool scale is add_scale.
extern "C" int conv_pe_pool(const void* A, const void* B, void* C, int G,
                            int rows, int N, int K, float a_scale,
                            const void* w_scale, const void* bias, int act,
                            float mid_scale, const void* R, float res_scale,
                            int add_act, float add_scale, float gap_scale,
                            int out_int8, float os_val, void* stream) {
  const dim3 grid((N + PN - 1) / PN, G);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int8_t*>(A);
  const auto* b = static_cast<const int8_t*>(B);
  const auto* ws = static_cast<const float*>(w_scale);
  const auto* bs = static_cast<const float*>(bias);
  const auto* r = static_cast<const int8_t*>(R);
  if (R != nullptr)
    pool_kernel<true><<<grid, PN * PG, 0, s>>>(
        a, b, C, rows, N, K, a_scale, ws, bs, act, mid_scale, r, res_scale,
        add_act, add_scale, gap_scale, out_int8, os_val);
  else
    pool_kernel<false><<<grid, PN * PG, 0, s>>>(
        a, b, C, rows, N, K, a_scale, ws, bs, act, mid_scale, r, res_scale,
        add_act, add_scale, gap_scale, out_int8, os_val);
  return static_cast<int>(cudaGetLastError());
}
