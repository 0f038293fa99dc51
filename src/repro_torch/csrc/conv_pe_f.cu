// Conv PE float GEMM on Hopper: out = act(A @ B + bias) with f32
// accumulation, the training path's projection GEMM (forward and backward).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/conv_pe.py::
// matmul_f_fused (_kernel_f :429, pallas_call :460)
//   -> gemm_tc_kernel (+ reduce_kernel for a split K): bf16 operands
//   -> gemm_f_kernel: f32 operands, and bf16 ones TMA cannot describe
//
// What it computes is _kernel_f's function, not its blocking:
// out[m, n] = act(sum_k f32(A[m, k]) * f32(B[k, n]) + bias[n]), cast to the
// output type.  A and B are both f32 or both bf16; bias is f32 [N] or
// absent; the output is f32 or bf16 (round to nearest even).  The act runs
// in f32 on the complete sum and is any of the reference's seven
// (ref.act_fn): none, relu, relu6, relu2, silu (x / (1 + expf(-x)), torch's
// CUDA F.silu), gelu with the tanh approximation (0.5 x (1 + tanhf(sqrt(2/pi)
// (x + 0.044715 x^3))), torch's spelling) and hardswish (x * min(max(x + 3,
// 0), 6) / 6).  M, N and K are any sizes.
//
// What bounds it on the H100: a full-width qwen2-1.5b step multiplies
// [1024, 1536] x [1536, 256] up to [1024, 8960] x [8960, 1536], hundreds of
// flops per operand byte, so the bound is the card's bf16 matrix rate, 989
// TFLOP/s, which only wgmma reaches.  Every product of the step has bf16
// operands.  kernels/conv_pe.py::plan_f picks, per product, the route, the
// K split and the reduction pass; nothing here picks or falls back.
//
// * bf16 operands that TMA can describe (16-byte aligned bases, row strides
//   a multiple of 16 bytes), N a multiple of 8 -- gemm_tc_kernel.  Output
//   tiles of 128 x 128, each with one K slice; the grid is persistent (at
//   most one block an SM, walking units blockIdx.x, + gridDim.x, ...).
//   Warp specialised: one thread of the producer warpgroup keeps TMA loads
//   of 128 x 64 A and B tiles (64 bf16 = one 128-byte swizzle row of K) in
//   flight through a 4-stage ring paced by full / empty mbarriers; the two
//   consumer warpgroups take the block's units in turn (ping-pong), each
//   running a whole tile with two wgmma.mma_async m64n128k16 (f32 += bf16
//   x bf16) a k16 step, one wgmma group kept in flight while the next is
//   issued, so one warpgroup's epilogue runs while the other's products
//   keep the tensor cores busy.  setmaxnreg moves registers from the
//   producer (40) to the consumers (232: 128 accumulators a thread).  Each
//   operand is read in the layout autograd holds it: A as [M, K] (K
//   contiguous) or as the transposed view of a stored [K, M]; B as [K, N]
//   (N contiguous, the forward's weight) or as the transposed view of a
//   stored [N, K].  TMA copies each tile in its stored layout and the
//   wgmma descriptors' major (transpose) bits read it, so the backward's
//   dz @ b^T and a^T @ dz copy nothing.  Ragged M, N and K edges are
//   zero-filled by TMA (zeros add nothing) and masked at the store.
//   Unsplit, and for the acts without a division or a libm call (none,
//   relu, relu6, relu2: ptxas serializes every wgmma of a function that
//   holds a call, and an IEEE division calls its slow path), the epilogue
//   (bias, act, cast) runs in the kernel on the complete sums: 64 rows of
//   the accumulators at a time are staged in shared memory and a loop,
//   unrolled and templated on output type and act, writes whole rows with
//   16- or 8-byte stores (stored straight from the fragments, 8 rows a
//   warp's store, every step shape was slower).
//   Split along K (where the tiles leave SMs idle), and for silu, gelu and
//   hardswish, each slice writes its f32 sums to a scratch [splits, M, N]
//   and reduce_kernel adds the slices in slice order, then runs the
//   epilogue with act_f: no atomics, so every run gives the same bits.
//   (Measured on the H100 by scripts/conv_pe_probe.py --float: 128 x 256
//   and cooperative 256 x 128 tiles, deeper rings and a promoted second
//   accumulator were slower at every step shape but one; the unpromoted
//   sums stay within the float bar.)
// * f32 operands, and bf16 ones TMA cannot describe (the ragged shapes of
//   the tests; no product of the training step) -- gemm_f_kernel, on the
//   CUDA cores' FFMA pipe (67 TFLOP/s peak in f32), contiguous row-major
//   operands only: one block of 256 threads per 64x64 output tile, K
//   staged through shared memory 32 at a time, 4x4 outputs per thread, the
//   bias and act applied in registers before the one store.  f32 stays
//   here because the tensor cores' f32 path (TF32) rounds the inputs to 10
//   mantissa bits; each output is one __fmaf_rn chain in k order (the
//   sources build with --fmad=false).
//
// Numerics.  bf16 products are exact in f32.  The tensor cores sum them in
// another order than the plain version (torch.matmul in full f32, TF32 off)
// with their own rounding of the f32 accumulator, so the two agree to f32
// rounding of the K-sum, not bitwise; at bf16 output they can be one bf16
// ulp apart.
//
// The tensor maps are encoded on the host per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (so the
// library links without -lcuda), and passed as __grid_constant__ params.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// the acts the tensor-core kernel applies itself (act_tc): no division and
// no libm call (an IEEE division calls a slow-path subroutine, and ptxas
// serializes every wgmma of a function that holds a call); silu, gelu and
// hardswish run in reduce_kernel's pass
__host__ __device__ constexpr bool act_in_tc(int act) {
  return act == F_NONE || act == F_RELU || act == F_RELU6 || act == F_RELU2;
}

// act_f of an act_in_tc act known at compile time: the switch folds away
template <int ACT>
__device__ __forceinline__ float act_tc(float x) {
  static_assert(act_in_tc(ACT), "an act the tiles do not apply");
  return act_f(x, ACT);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// gemm_f_kernel: FFMA tiles (f32 operands, unaligned bf16)
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int LDA = BM + 4;     // k-major rows stay 16-byte aligned
constexpr int LDB = BN + 4;

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

// ---------------------------------------------------------------------------
// gemm_tc_kernel: bf16 wgmma tiles fed by TMA
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128;                  // tile rows
constexpr int TC_BN = 128;                  // tile columns
constexpr int TC_BK = 64;                   // K a stage: one 128-byte row
constexpr int TC_STAGES = 4;
constexpr int TC_THREADS = 384;             // producer + two consumers
constexpr int CHUNK = 64 * TC_BK * 2;       // one 64 x 64 bf16 box, 8 KB
constexpr int A_STAGE = TC_BM * TC_BK * 2;  // 16 KB
constexpr int B_STAGE = TC_BN * TC_BK * 2;  // 16 KB
constexpr int EPI_ROWS = 64;                // rows a consumer stages at once
constexpr int EPI_LD = TC_BN + 4;           // staged row, floats (2-way
                                            // bank conflicts at most)
constexpr int EPI_BYTES = EPI_ROWS * EPI_LD * 4;
// the ring, each consumer's epilogue staging, the full / empty barriers,
// the consumers' two turn barriers, and room to align the base to the 1024
// bytes of a 128-byte swizzle atom
constexpr int TC_SMEM = TC_STAGES * (A_STAGE + B_STAGE) + 2 * EPI_BYTES +
                        16 * TC_STAGES + 16 + 1024;
// epilogue modes: a K slice's raw f32 sums, f32 output, bf16 output
enum EpiMode : int { EPI_RAW = 0, EPI_F32 = 1, EPI_BF16 = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// waits for the phase of parity `parity` to complete; a wait that spins
// 2^26 times (seconds) is a fault, and traps rather than hangs the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// one 2-D TMA tile (inner coordinate c0, row c1) into shared memory at dst,
// completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1) : "memory");
}

// a wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// the descriptor of k step kk (16 deep) of a tile at `tile`.  K-major: rows
// of 128 bytes (64 k), 8-row groups 1024 bytes apart, the step 32 bytes into
// the row.  MN-major: 64 x 64 boxes 8 KB apart along M / N, each 64 k rows
// of 128 bytes (64 m or n), 8-k groups 1024 bytes apart, the step 16 rows on.
template <int MN>
__device__ __forceinline__ uint64_t step_desc(uint32_t tile, int kk) {
  return MN ? desc(tile + kk * 2048, CHUNK, 1024)
            : desc(tile + kk * 32, 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void pin(float (&d)[2][64]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[h][i])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)
#define F64(i) F16(i), F16(i + 16), F16(i + 32), F16(i + 48)

// d[64] += A (64 x 16, desc da) x B (16 x 128, desc db) (scale-d, a
// predicate, set).  TA / TB: the operand is MN-major (wgmma's transpose
// bit).
template <int TA, int TB>
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : F64(0)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

#undef F64
#undef F16
#undef F4

// The epilogue of one 128 x 128 tile from a consumer warpgroup's
// accumulators (this thread holds, in half h2 (rows 64 h2..) and fragment j
// (columns 8j..), the columns 8j + fc + {0, 1} of two rows 8 apart; warp w
// holds rows 16w..16w+15 of each half), EPI_ROWS rows at a time: the warps
// holding them put their fragments in the warpgroup's staging buffer `buf`;
// then each warp takes whole rows, each lane four neighbouring columns
// (store_rows), adds the bias, runs the act and writes 16 (f32) or 8
// (bf16) bytes a lane, a warp's row contiguous.  EPI_RAW stores the raw
// f32 sums (a K slice's partials, or the sums an act outside act_in_tc
// waits for in reduce_kernel).  N is a multiple of 8 (plan_f).
//
// One warp a scheduler runs the rows, so nothing hides an instruction's
// latency but the warp's own independent work: the mode and the act are
// template arguments (one branch a call, not one an output) and the loop
// is unrolled by four (run on the H100 by scripts/conv_pe_probe.py
// --float: a rolled loop with a runtime act switch took 4.5 us of a
// 7.3 us bf16 tile of the step's K / V da).
template <int MODE, int ACT>
__device__ __forceinline__ void store_rows(const float* buf, int w, int cl,
                                           const float (&bv)[4],
                                           bool has_bias, void* out, int M,
                                           int N, int row0, int col) {
#pragma unroll 4
  for (int r = w; r < EPI_ROWS; r += 4) {
    const int row = row0 + r;
    if (row >= M) break;
    const float4 v = *reinterpret_cast<const float4*>(buf + r * EPI_LD + cl);
    const size_t at = static_cast<size_t>(row) * N + col;
    if (MODE == EPI_RAW) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + at) = v;
      continue;
    }
    float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (has_bias) x[e] = __fadd_rn(x[e], bv[e]);
      x[e] = act_tc<ACT>(x[e]);
    }
    if (MODE == EPI_BF16) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + at) = u;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + at) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

template <int MODE>
__device__ __forceinline__ void store_rows_act(int act, const float* buf,
                                               int w, int cl,
                                               const float (&bv)[4],
                                               bool has_bias, void* out,
                                               int M, int N, int row0,
                                               int col) {
  switch (act) {
    case F_RELU:
      store_rows<MODE, F_RELU>(buf, w, cl, bv, has_bias, out, M, N, row0,
                               col);
      break;
    case F_RELU6:
      store_rows<MODE, F_RELU6>(buf, w, cl, bv, has_bias, out, M, N, row0,
                                col);
      break;
    case F_RELU2:
      store_rows<MODE, F_RELU2>(buf, w, cl, bv, has_bias, out, M, N, row0,
                                col);
      break;
    default:
      store_rows<MODE, F_NONE>(buf, w, cl, bv, has_bias, out, M, N, row0,
                               col);
  }
}

__device__ __forceinline__ void epilogue(const float (&acc)[2][64],
                                         float* buf, int c, int t,
                                         const float* __restrict__ bias,
                                         void* __restrict__ out, int M, int N,
                                         int m0, int n0, int act, int mode) {
  const int w = t / 32, fc = 2 * (t % 4);
  const int cl = 4 * (t % 32), col = n0 + cl;
  float bv[4] = {0.f, 0.f, 0.f, 0.f};
  if (mode != EPI_RAW && bias != nullptr && col < N) {
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = bias[col + e];
  }
#pragma unroll
  for (int q = 0; q < TC_BM / EPI_ROWS; ++q) {   // rows q EPI_ROWS.. of
    constexpr int H = 64;                        // the tile
    const int h2 = q * EPI_ROWS / H;
    // this warp's 16 rows of the half, counted from the chunk's first
    const int r0 = H * h2 + 16 * w - q * EPI_ROWS;
    if (r0 >= 0 && r0 < EPI_ROWS) {
      const int fr = r0 + (t % 32) / 4;
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(buf + (fr + 8 * h) * EPI_LD + 8 * j +
                                     fc) =
              make_float2(acc[h2][4 * j + 2 * h],
                          acc[h2][4 * j + 2 * h + 1]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    if (col < N) {
      const int row0 = m0 + EPI_ROWS * q;
      const bool has_bias = bias != nullptr;
      if (mode == EPI_RAW)
        store_rows<EPI_RAW, F_NONE>(buf, w, cl, bv, false, out, M, N, row0,
                                    col);
      else if (mode == EPI_BF16)
        store_rows_act<EPI_BF16>(act, buf, w, cl, bv, has_bias, out, M, N,
                                 row0, col);
      else
        store_rows_act<EPI_F32>(act, buf, w, cl, bv, has_bias, out, M, N,
                                row0, col);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
  }
}

// Units: output tile u % tiles (m tiles vary fastest, so the blocks in
// flight share B's column tiles) and K slice u / tiles.  A: TA 0 -> [M, K]
// map (box 64 k x 128 rows); TA 1 -> stored [K, M] (boxes 64 m x 64 k).
// B: TB 0 -> stored [N, K] (box 64 k x 128 rows); TB 1 -> stored [K, N]
// (boxes 64 n x 64 k).  The producer loads the block's units in order
// through one ring; consumer warpgroup c runs the block's units c, c + 2,
// ... whole (two m64n128k16 a k16 step, one per 64-row half), so one
// warpgroup's epilogue overlaps the other's products.  A warpgroup starts
// a unit's steps only once the other has issued its previous unit's last
// (turn barriers): a ring slot's full barrier is then at most one phase
// behind the step waiting on it, which its parity wait needs (two phases
// behind, the parity of the older phase would pass).  `part` non-null: the
// raw f32 sums of K slice z go to part[z] for reduce_kernel.
template <int TA, int TB>
__global__ void __launch_bounds__(TC_THREADS, 1)
gemm_tc_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b,
               const float* __restrict__ bias, void* __restrict__ C,
               float* __restrict__ part, int M, int N, int tiles_m,
               int tiles, int units, int nk, int kps, int act,
               int out_bf16) {
  constexpr int ST = TC_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sa = base, sb = base + ST * A_STAGE;
  const uint32_t epi = sb + ST * B_STAGE;   // two staging buffers
  const uint32_t full = epi + 2 * EPI_BYTES;
  const uint32_t empty = full + 8 * ST;
  const uint32_t turn = empty + 8 * ST;     // one a consumer
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    // the tensor maps' fetch overlaps the barriers' set-up
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_a)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_b)) : "memory");
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);           // the producer's expect_tx
      mbar_init(empty + 8 * s, 1);          // the consuming warpgroup
    }
    mbar_init(turn, 1);                     // the other warpgroup
    mbar_init(turn + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // -- producer: one thread keeps the ring full --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int tile = u % tiles, z = u / tiles;
      const int m0 = (tile % tiles_m) * TC_BM, n0 = (tile / tiles_m) * TC_BN;
      const int kb1 = min(nk, (z + 1) * kps);
      for (int kb = z * kps; kb < kb1; ++kb) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, A_STAGE + B_STAGE);
        const uint32_t a = sa + stage * A_STAGE, b = sb + stage * B_STAGE;
        const int k0 = kb * TC_BK;
        if (TA) {
          tma_load(a, &map_a, m0, k0, bar);
          tma_load(a + CHUNK, &map_a, m0 + 64, k0, bar);
        } else {
          tma_load(a, &map_a, k0, m0, bar);
        }
        if (TB) {
          tma_load(b, &map_b, n0, k0, bar);
          tma_load(b + CHUNK, &map_b, n0 + 64, k0, bar);
        } else {
          tma_load(b, &map_b, k0, n0, bar);
        }
        if (++stage == ST) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // -- consumers: warpgroup c runs every other unit of the block -----------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, t = threadIdx.x % 128;
  const bool lead = t == 0;
  int stage = 0;
  uint32_t phase = 0, turn_phase = 0;
  int i = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int tile = u % tiles, z = u / tiles;
    const int kb0 = z * kps, kb1 = min(nk, kb0 + kps);
    if ((i & 1) != c) {                     // the other warpgroup's unit
      stage += kb1 - kb0;
      phase ^= (stage / ST) & 1;
      stage %= ST;
      continue;
    }
    if (i > 0) {                            // the block's first unit waits
      mbar_wait(turn + 8 * c, turn_phase);  // for no one
      turn_phase ^= 1;
    }
    const int m0 = (tile % tiles_m) * TC_BM, n0 = (tile / tiles_m) * TC_BN;
    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[h][r] = 0.f;
    // a stage's wgmma group stays in flight while the next stage's is
    // issued; a stage is released once the group reading it is complete
    int held = -1;
    for (int kb = kb0; kb < kb1; ++kb) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t a = sa + stage * A_STAGE, b = sb + stage * B_STAGE;
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        const uint64_t db = step_desc<TB>(b, kk);
        wgmma128<TA, TB>(acc[0], step_desc<TA>(a, kk), db);
        wgmma128<TA, TB>(acc[1], step_desc<TA>(a + CHUNK, kk), db);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (lead && held >= 0) mbar_arrive(empty + 8 * held);
      held = stage;
      if (++stage == ST) { stage = 0; phase ^= 1; }
    }
    if (lead) mbar_arrive(turn + 8 * (1 - c));   // the other's turn
    wgmma_wait<0>();
    pin(acc);
    if (lead && held >= 0) mbar_arrive(empty + 8 * held);

    float* buf = reinterpret_cast<float*>(smem_raw + (epi - smem_u32(
                                              smem_raw)) + c * EPI_BYTES);
    if (part != nullptr)
      epilogue(acc, buf, c, t, nullptr,
               part + static_cast<size_t>(z) * M * N, M, N, m0, n0, 0,
               EPI_RAW);
    else
      epilogue(acc, buf, c, t, bias, C, M, N, m0, n0, act,
               out_bf16 ? EPI_BF16 : EPI_F32);
  }
}

// C = act(sum over slices of part + bias): the slices added in slice order
// with __fadd_rn, four neighbouring outputs a thread (N is a multiple of
// 8).  A thread issues the loads of RED_BATCH slices before adding them,
// so it waits on the memory once a batch, not once a slice.
constexpr int RED_BATCH = 4;

__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ part, int splits, int M, int N,
              const float* __restrict__ bias, int act, void* __restrict__ C,
              int out_bf16) {
  const size_t mn = static_cast<size_t>(M) * N;
  for (size_t g = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       g < mn / 4; g += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t i0 = 4 * g;
    float x[4];
    for (int z0 = 0; z0 < splits; z0 += RED_BATCH) {
      float4 q[RED_BATCH];
#pragma unroll
      for (int j = 0; j < RED_BATCH; ++j)
        if (z0 + j < splits)
          q[j] = *reinterpret_cast<const float4*>(part + (z0 + j) * mn + i0);
#pragma unroll
      for (int j = 0; j < RED_BATCH; ++j) {
        if (z0 + j == 0) {
          x[0] = q[0].x; x[1] = q[0].y; x[2] = q[0].z; x[3] = q[0].w;
        } else if (z0 + j < splits) {
          x[0] = __fadd_rn(x[0], q[j].x);
          x[1] = __fadd_rn(x[1], q[j].y);
          x[2] = __fadd_rn(x[2], q[j].z);
          x[3] = __fadd_rn(x[3], q[j].w);
        }
      }
    }
    const int n0 = static_cast<int>(i0 % N);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y = x[e];
      if (bias != nullptr) y = __fadd_rn(y, bias[n0 + e]);
      y = act_f(y, act);
      if (out_bf16) static_cast<__nv_bfloat16*>(C)[i0 + e] =
          __float2bfloat16_rn(y);
      else static_cast<float*>(C)[i0 + e] = y;
    }
  }
}

// cuTensorMapEncodeTiled's signature (cuda.h), called through the driver
// entry point so the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// error codes beside cudaGetLastError()'s: no encoder, a refused map, a
// plan the kernels cannot run (N off 8, or no pass where its split or act
// needs one)
constexpr int ERR_NO_ENCODER = 9000;
constexpr int ERR_ENCODE = 9100;
constexpr int ERR_PLAN = 9200;

// the encoder is a driver call, which needs a context current on the
// calling thread; a thread whose first CUDA work is this product (autograd's
// device thread, running a backward) has none until a runtime call binds
// the device's primary context, as cudaFree(nullptr) does: once a thread
int bind_context() {
  thread_local bool bound = false;
  if (!bound) {
    const cudaError_t e = cudaFree(nullptr);
    if (e != cudaSuccess) return static_cast<int>(e);
    bound = true;
  }
  return 0;
}

// a bf16 matrix of `outer` rows of `inner` contiguous elements, rows `ld`
// apart, read in boxes of 64 x box_rows with the 128-byte swizzle; reads
// past an edge fill zeros
int encode(CUtensorMap* map, const void* p, int inner, int outer, int ld,
           int box_rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(p), dims, strides, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(r);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int TA, int TB>
int launch_tc(const CUtensorMap& ma, const CUtensorMap& mb, const float* bias,
              void* C, float* part, int M, int N, int K, int splits, int kps,
              int act, int out_bf16, cudaStream_t s) {
  constexpr int smem = TC_SMEM;
  auto kernel = gemm_tc_kernel<TA, TB>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const int tiles_m = (M + TC_BM - 1) / TC_BM;
  const int tiles = tiles_m * ((N + TC_BN - 1) / TC_BN);
  const int units = tiles * splits;
  const int grid = units < sm_count() ? units : sm_count();
  kernel<<<grid, TC_THREADS, smem, s>>>(
      ma, mb, bias, C, part, M, N, tiles_m, tiles, units,
      (K + TC_BK - 1) / TC_BK, kps, act, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C[M, N] = act(A[M, K] @ B[K, N] + bias[N]); A / B f32 (in_bf16 = 0) or
// bf16 (1), C f32 (out_bf16 = 0) or bf16 (1); bias f32 or nullptr; all
// row-major and contiguous.  The FFMA route.  Returns cudaGetLastError().
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

// The tensor-core route, bf16 operands.  a_mn 0: A is [M, K] with rows K
// apart; 1: A is the transposed view of a stored [K, M] (rows M apart).
// b_mn 1: B is [K, N] with rows N apart; 0: B is the transposed view of a
// stored [N, K] (rows K apart).  Tiles of 128 x 128, K in `splits` slices
// of kps 64-deep steps (the last may be short, none empty); N a multiple
// of 8.  part non-null (the planner's pass: kernels/conv_pe.py::plan_f):
// the tiles leave f32 sums in part ([splits, M, N]) for reduce_kernel,
// which adds the slices in order and runs bias, act and cast; null: the
// tiles run the epilogue, which a split K or an act they do not apply
// (silu, gelu, hardswish: act_in_tc) cannot take (ERR_PLAN).  Returns
// cudaGetLastError(), or ERR_* if the plan is refused or a tensor map
// cannot be made.
extern "C" int conv_pe_f_tc(const void* A, const void* B, const void* bias,
                            void* C, void* part, int M, int N, int K,
                            int a_mn, int b_mn, int splits, int kps,
                            int act, int out_bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bool pass = part != nullptr;
  if (N % 8 != 0 || (!pass && (splits > 1 || !act_in_tc(act))))
    return ERR_PLAN;
  int err = bind_context();
  if (err != 0) return err;
  CUtensorMap ma, mb;
  err = a_mn ? encode(&ma, A, M, K, M, 64) : encode(&ma, A, K, M, K, TC_BM);
  if (err == 0)
    err = b_mn ? encode(&mb, B, N, K, N, 64)
               : encode(&mb, B, K, N, K, TC_BN);
  if (err != 0) return err;
  const auto* bs = static_cast<const float*>(bias);
  auto* ps = static_cast<float*>(part);
  using Launch = int (*)(const CUtensorMap&, const CUtensorMap&,
                         const float*, void*, float*, int, int, int, int,
                         int, int, int, cudaStream_t);
  const Launch run = a_mn ? (b_mn ? &launch_tc<1, 1> : &launch_tc<1, 0>)
                          : (b_mn ? &launch_tc<0, 1> : &launch_tc<0, 0>);
  err = run(ma, mb, bs, C, ps, M, N, K, splits, kps, act, out_bf16, s);
  if (err != 0 || !pass) return err;
  const size_t want = (static_cast<size_t>(M) * N / 4 + 255) / 256;
  const int blocks = static_cast<int>(
      want < static_cast<size_t>(8 * sm_count()) ? want : 8 * sm_count());
  reduce_kernel<<<blocks, 256, 0, s>>>(ps, splits, M, N, bs, act, C,
                                       out_bf16);
  return static_cast<int>(cudaGetLastError());
}
