// Conv PE float GEMM on Hopper: out = act(A @ B + bias) with f32
// accumulation, the training path's projection GEMM (forward and backward).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/conv_pe.py::
// matmul_f_fused (_kernel_f :429, pallas_call :460)        -> gemm_f_kernel
//
// What it computes is _kernel_f's function, not its blocking:
// out[m, n] = act(sum_k f32(A[m, k]) * f32(B[k, n]) + bias[n]), cast to the
// output type.  A and B are both f32 or both bf16, widened to f32 when a
// tile is staged; bias is f32 [N] or absent; the output is f32 or bf16
// (round to nearest even).  The act runs in f32 on the accumulator and is
// any of the reference's seven (ref.act_fn): none, relu, relu6, relu2,
// silu (x / (1 + expf(-x)), torch's CUDA F.silu), gelu with the tanh
// approximation (0.5 x (1 + tanhf(sqrt(2/pi) (x + 0.044715 x^3))), torch's
// spelling) and hardswish (x * min(max(x + 3, 0), 6) / 6).  M, N and K are
// any sizes: the TPU kernel's 128 / 512 multiples were its tiling; here
// ragged tiles are staged with zeros (which add nothing to a sum) and the
// ragged outputs are not stored.
//
// Numerics.  Each output is one fused multiply-add chain in k order from 0
// (__fmaf_rn: the sources build with --fmad=false, so every fusion is
// written out).  For bf16 operands each product is exact in f32, so the
// chain equals a multiply then an add; for f32 operands it rounds once per
// step, as cuBLAS's FFMA does.  cuBLAS sums in another order, so the plain
// version (torch.matmul in full f32, TF32 off) agrees to f32 rounding of
// the K-sum, not bitwise; at bf16 output the two can be one bf16 ulp apart.
//
// What bounds it on the H100: a full-width qwen2-1.5b step multiplies
// [1024, 1536] x [1536, 2048] up to [1024, 8960] x [8960, 1536] (2 M N K
// flops against (M K + K N + M N) operand bytes: hundreds of flops per
// byte), so the bound is the card's matrix rate, 989 TFLOP/s in bf16 on
// the tensor cores.  This kernel is the simple one that is right: it runs
// on the CUDA cores' FFMA pipe (67 TFLOP/s peak in f32), one block of 256
// threads per 64x64 output tile, K staged through shared memory 32 at a
// time (A transposed to k-major so each thread reads its four rows and its
// four columns as one float4 each), 4x4 outputs per thread in registers,
// the bias and act applied in registers before the one store.  wgmma on
// bf16 tiles fed by TMA, and transposed operand loads for the backward
// (which now copies A^T and B^T), are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int LDA = BM + 4;     // k-major rows stay 16-byte aligned
constexpr int LDB = BN + 4;

// the float epilogue's act table (kernels/_build.py F_ACT_CODES)
enum FAct : int {
  F_NONE = 0, F_RELU = 1, F_RELU6 = 2, F_RELU2 = 3, F_SILU = 4, F_GELU = 5,
  F_HARDSWISH = 6
};

__device__ __forceinline__ float act_f(float x, int act) {
  switch (act) {
    case F_RELU: return fmaxf(x, 0.f);
    case F_RELU6: return fminf(fmaxf(x, 0.f), 6.f);
    case F_RELU2: {
      const float r = fmaxf(x, 0.f);
      return __fmul_rn(r, r);
    }
    case F_SILU: return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
    case F_GELU: {
      const float kBeta = 0.7978845608028654f;   // sqrt(2 / pi)
      const float kKappa = 0.044715f;
      const float cube = __fmul_rn(__fmul_rn(x, x), x);
      const float inner = __fmul_rn(kBeta, __fadd_rn(x, __fmul_rn(kKappa,
                                                                  cube)));
      return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, tanhf(inner)));
    }
    case F_HARDSWISH:
      return __fdiv_rn(__fmul_rn(x, fminf(fmaxf(__fadd_rn(x, 3.f), 0.f),
                                          6.f)), 6.f);
    default: return x;
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
gemm_f_kernel(const TI* __restrict__ A, const TI* __restrict__ B,
              const float* __restrict__ bias, TO* __restrict__ C, int M,
              int N, int K, int act) {
  __shared__ __align__(16) float As[BK][LDA];   // As[k][m]
  __shared__ __align__(16) float Bs[BK][LDB];   // Bs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // consecutive threads read consecutive k of one A row, consecutive n
    // of one B row: both loads coalesce
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK, gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? widen(A[(size_t)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN, gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? widen(B[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j],
                                                          acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float x = acc[i][j];
      if (bias != nullptr) x = __fadd_rn(x, bias[n]);
      put(&C[(size_t)m * N + n], act_f(x, act));
    }
  }
}

template <typename TI, typename TO>
int launch(const void* A, const void* B, const void* bias, void* C, int M,
           int N, int K, int act, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_f_kernel<TI, TO><<<grid, THREADS, 0, s>>>(
      static_cast<const TI*>(A), static_cast<const TI*>(B),
      static_cast<const float*>(bias), static_cast<TO*>(C), M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C[M, N] = act(A[M, K] @ B[K, N] + bias[N]); A / B f32 (in_bf16 = 0) or
// bf16 (1), C f32 (out_bf16 = 0) or bf16 (1); bias f32 or nullptr; all
// row-major and contiguous.  Returns cudaGetLastError().
extern "C" int conv_pe_f_gemm(const void* A, const void* B, const void* bias,
                              void* C, int M, int N, int K, int act,
                              int in_bf16, int out_bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (in_bf16)
    return out_bf16 ? launch<bf, bf>(A, B, bias, C, M, N, K, act, s)
                    : launch<bf, float>(A, B, bias, C, M, N, K, act, s);
  return out_bf16 ? launch<float, bf>(A, B, bias, C, M, N, K, act, s)
                  : launch<float, float>(A, B, bias, C, M, N, K, act, s);
}
