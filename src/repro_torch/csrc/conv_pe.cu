// Conv PE on Hopper: int8 GEMM with int32 accumulation and the fused NL
// epilogue (plain and residual variants), plus the pooled-epilogue GEMM.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/conv_pe.py:
//   _kernel (:37) and _kernel_res (:69) of matmul_int8_fused   -> conv_pe_gemm
//   _kernel_pool (:311) of matmul_int8_pool, with and without its
//   residual operand (has_res)                                 -> conv_pe_pool
//
// conv_pe_gemm runs one of two kernels, chosen per (M, N, K) by the planner
// in kernels/conv_pe.py::plan and passed in as (path, tile, K split, copy
// widths, epilogue placement); nothing here picks or falls back.
//
// * Few rows and many weights (M <= 4 and K x N >= 16 MiB: the 4-slot LM
//   decode step's in_proj, out_proj, gate/up) -- stream_kernel.  Each
//   weight byte is used M times, so the product is bound by reading B
//   [K, N] once from HBM (in_proj, 67 MB: 20 us at 3.35 TB/s).  A block
//   owns 128 columns and one K slice; its 256 threads are 8 column threads
//   x 32 k lanes, each column thread reading 16 neighbouring columns of 4 k
//   rows as one 16-byte vector per row, so a warp reads whole 128-byte row
//   segments, two 4-row groups in flight a lane.  A 4x4 byte transpose in
//   registers (__byte_perm) turns 4 rows x 4 columns into 4 columns x 4 k,
//   which __dp4a multiplies with the block's A slice, staged once in shared
//   memory.  K is split only as far as the column tiles leave SMs idle.
// * Everything else (LM prefill, the other decode projections, every CNN
//   GEMM and head) -- mma_kernel.  128-row tiles of 128, 64 or 32 columns
//   (so N = 16..24 is not mostly padding), K steps of 64,
//   mma.sync.m16n8k32 s8 x s8 -> s32 on the tensor cores (the 1,979 dense
//   int8 TOPS are out of reach of __dp4a on the CUDA cores).  A and B
//   stream through a 4-stage cp.async ring, zero-filled at ragged edges;
//   the copies are 16, 8 or 4 bytes wide (bytes where K or N is odd), as
//   the planner finds K, N and the pointers aligned, so no copy reads past
//   a row.  int8 MMA wants B K-major and the weights are N-major [K, N]:
//   each stage is transposed in shared memory (4x4 byte transposes,
//   __byte_perm) into a swizzled K-major tile that ldmatrix reads without
//   bank conflicts.  Where the tiles fall under the SM count (x_proj at M =
//   256: 2 x 3 tiles; M = 4 decode shapes: one row of tiles), K is split.
//
// The epilogue (dequant, bias, act, residual qdq + add, requant;
// epilogue.cuh's arithmetic) runs once per output on the complete int32
// sum, as the plain version does, and costs ~40 instructions an output
// with its IEEE division.  Each thread keeps one column and runs four rows
// side by side, so each option branch is taken once for four independent
// chains.  Its acts are none, relu, relu6 and tanh-gelu (act4;
// epilogue.cuh gelu_tanh, torch's CUDA formula with its one FMA:
// recurrentgemma's in_gate and the GeGLU gates).  gelu runs in the
// epilogue pass alone, on every route (a plan that would fuse the
// epilogue leaves its sums in the scratch instead): compiled into the
// product kernels and the pass, the tanhf branch slowed their relu / none
// epilogues 2-6% (scripts/conv_pe_probe.py --gelu --parent), so only
// epilogue_pass<true> holds it.  Inside a tensor-core kernel only 8-16 warps an SM share a 128 x
// 128 tile's 16,384 outputs, which measured slower than a pass of its own:
// so the planner fuses the epilogue only into unsplit narrow tiles and the
// stream kernel; otherwise the product leaves its int32 sums in a scratch
// [M, N] (allocated by the wrapper) and epilogue_pass runs over the whole
// card.  A split K adds its slices into that scratch, zeroed, with
// atomicAdd: an int32 sum is exact in any order, so every plan gives the
// same bits.
//
// The pooled variant (the CNN head: a 1x1 conv whose static global-pool
// tail folds in) does a few MFLOP on ~1 MB of weights, so a block's latency
// chain sets its time, not bytes or ops.  pool_kernel: one block owns one
// image g and a strip of PBN output columns.  It stages the image's rows x
// K of A (rows zero-filled to 16s, K to 64s), B's K x PBN strip and, for
// the residual variant, R's rows x PBN strip into shared memory with 16-byte
// cp.async copies (narrower where a row is not 16-byte aligned), all in
// flight before one wait (a head past the shared memory: passes of 64 rows
// and slices of K, pool_plan); transposes B into K-major 64-byte tiles as
// mma_kernel does; and multiplies on the int8 tensor cores (mma.sync
// m16n8k32 through ldmatrix), each warp 16 rows x 32 columns at a time.
// The epilogue runs on the fragments: dequant, bias, act, codes at
// mid_scale (then for the residual variant + r * res_scale, add_act, codes
// at add_scale; each requant a multiply by the reciprocal where that
// cannot move the code, epilogue.cuh's qdq_code_rcp), and each column's
// int32 sum over the image's real rows (padded rows left out) through warp
// shuffles and one shared array; then * gap_scale and the requant.  The
// pre-pool feature map never reaches device memory.
#include "epilogue.cuh"
#include "mma_s8.cuh"

namespace {

using namespace repro;

struct Epi {
  const float* a_scale;   // [M] per-row activation scale, or nullptr
  float a_scale_val;      // the static per-tensor scale otherwise
  const float* w_scale;   // [N]
  const float* bias;      // [N] or nullptr
  int act;
  int out_int8;           // 1: requant to int8, 0: f32 out
  const float* os_vec;    // [N] per-column requant scale, or nullptr
  float os_val;           // the per-tensor requant scale otherwise
  const void* res;        // [M, N] residual operand (int8 or f32), or nullptr
  int res_f32;
  float res_scale;
  int has_mid;            // static chain: qdq at mid_scale before the add
  float mid_scale;
  int add_act;
};

// Column n's epilogue operands, loaded once by the thread that owns the
// column (both kernels keep a thread on one column of its tile).
struct Col {
  float w_scale, bias, os;
};

__device__ __forceinline__ Col col_of(const Epi& e, int n) {
  return {e.w_scale[n], e.bias != nullptr ? e.bias[n] : 0.f,
          e.os_vec != nullptr ? e.os_vec[n] : e.os_val};
}

template <bool GELU>
__device__ __forceinline__ void act4(float (&x)[4], int act) {
  if (act == ACT_RELU) {
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = fmaxf(x[q], 0.f);
  } else if (act == ACT_RELU6) {
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = fminf(fmaxf(x[q], 0.f), 6.f);
  } else if (GELU && act == ACT_GELU) {
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = gelu_tanh(x[q]);
  }
}

// The epilogue of outputs (m[q], n), q < cnt (cnt >= 1), each on its
// complete int32 sum: dequant, bias and act in dequant_bias_act's order,
// the residual tail, the requant -- apply_act / qdq_code's arithmetic, four
// outputs at a time, so each branch on the options is taken once for four
// independent chains.
template <bool GELU>
__device__ __forceinline__ void store4(const Epi& e, const Col& c,
                                       const int (&acc)[4], const int (&m)[4],
                                       int cnt, int n, int N, void* C) {
  float x[4];
  size_t idx[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int mq = q < cnt ? m[q] : m[0];
    idx[q] = (size_t)mq * N + n;
    const float asc = e.a_scale != nullptr ? e.a_scale[mq] : e.a_scale_val;
    x[q] = __fmul_rn(__fmul_rn(__int2float_rn(acc[q]), asc), c.w_scale);
  }
  if (e.bias != nullptr) {
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = __fadd_rn(x[q], c.bias);
  }
  act4<GELU>(x, e.act);
  if (e.res != nullptr) {
    if (e.has_mid) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[q] = __fmul_rn(qdq_code(x[q], e.mid_scale), e.mid_scale);
    }
    float r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      r[q] = e.res_f32
          ? static_cast<const float*>(e.res)[idx[q]]
          : static_cast<float>(static_cast<const int8_t*>(e.res)[idx[q]]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x[q] = __fadd_rn(x[q], __fmul_rn(r[q], e.res_scale));
    act4<GELU>(x, e.add_act);
  }
  if (e.out_int8) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < cnt)
        static_cast<int8_t*>(C)[idx[q]] =
            static_cast<int8_t>(qdq_code(x[q], c.os));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < cnt) static_cast<float*>(C)[idx[q]] = x[q];
  }
}

// The epilogue as a pass of its own, on the complete int32 sums the product
// left in `part` [M, N] (stored, or added by the slices of a split K): many
// small blocks spread it over every SM.  Block: 128 columns x 8 rows, 4 rows
// a thread.  GELU: the instantiation that applies tanh-gelu.
constexpr int EP_COLS = 128, EP_ROWS = 8;

template <bool GELU>
__global__ void __launch_bounds__(256)
epilogue_pass(const int* __restrict__ part, void* __restrict__ C, int M,
               int N, Epi e) {
  const int n = blockIdx.x * EP_COLS + threadIdx.x % EP_COLS;
  const int r0 = blockIdx.y * EP_ROWS + threadIdx.x / EP_COLS;
  if (n >= N || r0 >= M) return;
  int acc[4], m[4], cnt = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    m[q] = r0 + 2 * q;
    const bool ok = m[q] < M;
    acc[q] = ok ? part[(size_t)m[q] * N + n] : 0;
    cnt += ok;
  }
  store4<GELU>(e, col_of(e, n), acc, m, cnt, n, N, C);
}

// ---------------------------------------------------------------------------
// Small M: split-K weight streaming
// ---------------------------------------------------------------------------

constexpr int ST_THREADS = 256;
constexpr int ST_M = 4;                  // rows (M <= 4)
constexpr int ST_CW = 16;                // columns a thread: one 16-byte load
constexpr int ST_CT = 8;                 // column threads
constexpr int ST_KL = ST_THREADS / ST_CT;  // k lanes
constexpr int ST_KG = 4 * ST_KL;         // k rows one pass covers (4 a lane)

// CW bytes of one B row from column c (zero past N); N % w == 0 and c is a
// multiple of CW >= w, so each w-byte piece lies wholly inside or outside.
// V: w == min(CW, 16), known when compiled.
template <int CW, bool V>
__device__ __forceinline__ void load_row(const int8_t* row, int c, int N,
                                         int w, bool valid,
                                         unsigned (&out)[CW / 4]) {
#pragma unroll
  for (int i = 0; i < CW / 4; ++i) out[i] = 0u;
  if (!valid) return;
  if (V || w >= 16) {
    if (CW >= 16) {
#pragma unroll
      for (int v = 0; v < CW / 16; ++v)
        if (c + 16 * v < N) {
          const uint4 x =
              __ldg(reinterpret_cast<const uint4*>(row + c + 16 * v));
          out[4 * v] = x.x; out[4 * v + 1] = x.y;
          out[4 * v + 2] = x.z; out[4 * v + 3] = x.w;
        }
      return;
    }
  }
  if (V || w == 8) {
#pragma unroll
    for (int v = 0; v < CW / 8; ++v)
      if (c + 8 * v < N) {
        const uint2 x =
            __ldg(reinterpret_cast<const uint2*>(row + c + 8 * v));
        out[2 * v] = x.x; out[2 * v + 1] = x.y;
      }
  } else if (w == 4) {
#pragma unroll
    for (int v = 0; v < CW / 4; ++v)
      if (c + 4 * v < N)
        out[v] = __ldg(reinterpret_cast<const unsigned*>(row + c + 4 * v));
  } else {
#pragma unroll
    for (int b = 0; b < CW; ++b)
      if (c + b < N)
        out[b / 4] |= static_cast<unsigned>(static_cast<uint8_t>(
                          __ldg(row + c + b))) << (8 * (b % 4));
  }
}

// grid (ceil(N / BN), splits).  Block: columns [n0, n0 + BN) x the K slice
// [k0, k0 + ks) of all M <= ST_M rows.  Dynamic shared memory: ST_M * BN
// ints (the block's sums) + ST_M * ks bytes (A's slice).  The sums go to
// the epilogue (fused) or into `part`.  V: B's rows take 16-byte loads.
template <bool V>
__global__ void __launch_bounds__(ST_THREADS, 2)
stream_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
              void* __restrict__ C, int M, int N, int K, int ks, int wa,
              int wb, int* __restrict__ part, int splits, int fused,
              Epi e) {
  constexpr int MT = ST_M, CW = ST_CW, BN = ST_CT * CW;
  extern __shared__ __align__(16) unsigned char st_smem[];
  int* red = reinterpret_cast<int*>(st_smem);           // [MT][CW][ST_CT]
  int8_t* As = reinterpret_cast<int8_t*>(red + MT * BN);  // [MT][ks]
  const int tid = threadIdx.x, ct = tid % ST_CT, kl = tid / ST_CT;
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * ks;
  const int kn = min(ks, K - k0);

  // the first two 4-row groups of B are in flight while A is staged
  const int nc = n0 + ct * CW;
  const int w = min(wb, CW);
  unsigned v[2][4][CW / 4];
  auto load_groups = [&](int r) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = r + h * ST_KG + q;
        load_row<CW, V>(B + (size_t)(k0 + rr) * N, nc, N, w, rr < kn,
                        v[h][q]);
      }
  };
  load_groups(4 * kl);

  for (int i = tid; i < MT * BN; i += ST_THREADS) red[i] = 0;
  if (wa >= 4) {       // K % 4 == 0: whole 4-byte words, zero past the slice
    const int kw = ks / 4;
    for (int i = tid; i < MT * kw; i += ST_THREADS) {
      const int m = i / kw, k = 4 * (i % kw);
      reinterpret_cast<unsigned*>(As)[i] =
          (m < M && k < kn) ? __ldg(reinterpret_cast<const unsigned*>(
                                  A + (size_t)m * K + k0 + k))
                            : 0u;
    }
  } else {
    for (int i = tid; i < MT * ks; i += ST_THREADS) {
      const int m = i / ks, k = i % ks;
      As[i] = (m < M && k < kn) ? A[(size_t)m * K + k0 + k] : int8_t(0);
    }
  }
  __syncthreads();

  int acc[MT][CW];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[m][c] = 0;
  const unsigned* Aw = reinterpret_cast<const unsigned*>(As);

  // two 4-row groups a lane a pass: rows r.. and r + ST_KG..
  for (int r = 4 * kl; r < kn; r += 2 * ST_KG) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + h * ST_KG;
      if (rr >= kn) break;
      int a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        a[m] = static_cast<int>(Aw[m * (ks / 4) + rr / 4]);
#pragma unroll
      for (int j = 0; j < CW / 4; ++j) {
        unsigned col[4];
        transpose4(v[h][0][j], v[h][1][j], v[h][2][j], v[h][3][j], col[0],
                   col[1], col[2], col[3]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[m][4 * j + c] =
                __dp4a(a[m], static_cast<int>(col[c]), acc[m][4 * j + c]);
      }
    }
    if (r + 2 * ST_KG < kn) load_groups(r + 2 * ST_KG);
  }

  // the block's sums: the warp's 4 k lanes by shuffles, then the 8 warps by
  // shared-memory atomics (red is column-interleaved: conflict-free)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      int s = acc[m][c];
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if ((tid & 31) < ST_CT)
        atomicAdd(&red[(m * CW + c) * ST_CT + ct], s);
    }
  __syncthreads();

  // thread tid owns column n0 + tid % BN and rows tid / BN, + 2 (M <= 4)
  const int nl = tid % BN, n = n0 + nl, r0 = tid / BN;
  if (n >= N || r0 >= M) return;
  int sums[4], m[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    m[q] = r0 + 2 * q;
    sums[q] = m[q] < MT ? red[(m[q] * CW + nl % CW) * ST_CT + nl / CW] : 0;
  }
  const int cnt = 1 + (r0 + 2 < M);
  if (fused) {
    store4<false>(e, col_of(e, n), sums, m, cnt, n, N, C);
    return;
  }
  for (int q = 0; q < cnt; ++q) {
    if (splits == 1)
      part[(size_t)m[q] * N + n] = sums[q];
    else
      atomicAdd(&part[(size_t)m[q] * N + n], sums[q]);
  }
}

// ---------------------------------------------------------------------------
// Larger M: int8 tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int MM_THREADS = 256;   // 8 warps
constexpr int BK = 64;            // K bytes a stage: four 16-byte units a row
constexpr int STAGES = 4;
constexpr int CPAD = 8;           // int32 padding of the staged output rows

template <int BM, int BN>
constexpr int mma_smem() {
  return STAGES * (BM * BK + BK * BN) + BN * BK > BM * (BN + CPAD) * 4
             ? STAGES * (BM * BK + BK * BN) + BN * BK
             : BM * (BN + CPAD) * 4;
}

// grid (ceil(M / BM), ceil(N / BN), splits); WM x WN warps of
// (BM / WM) x (BN / WN) outputs.  Dynamic shared memory (mma_smem): the A
// ring [STAGES][BM][BK] (a_unit), the N-major B ring [STAGES][BK][BN] as
// copied, and the transposed K-major B tile [BN][BK] (b_unit) of the current
// step (written between the step's two barriers, read after the second);
// after the K loop the same bytes hold the block's int32 sums [BM][BN +
// CPAD], which the epilogue (fused), or the stores / atomicAdds into
// `part`, walk with consecutive threads on consecutive columns.  V16:
// every copy is 16 bytes.
template <int BM, int BN, int WM, int WN, bool V16>
__global__ void __launch_bounds__(MM_THREADS, 2)
mma_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
           void* __restrict__ C, int M, int N, int K, int ks, int wa, int wb,
           int* __restrict__ part, int splits, int fused, Epi e) {
  static_assert(WM * WN * 32 == MM_THREADS, "8 warps");
  constexpr int MI = BM / WM / 16, NI = BN / WN / 8;
  constexpr int AU = BM * 4 / MM_THREADS;          // A units a thread
  constexpr int BU = (BK * BN / 16 + MM_THREADS - 1) / MM_THREADS;
  extern __shared__ __align__(16) unsigned char mm_smem[];
  int8_t* As = reinterpret_cast<int8_t*>(mm_smem);
  int8_t* Bs = As + STAGES * BM * BK;
  int8_t* Bt = Bs + STAGES * BK * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * ks, kend = min(kb + ks, K);
  const int nk = (kend - kb + BK - 1) / BK;

  // this thread's copies: A rows and units, B rows and columns
  const int8_t* a_row[AU];
  int a_lim[AU], a_col[AU], a_dst[AU];
#pragma unroll
  for (int i = 0; i < AU; ++i) {
    const int u = tid + i * MM_THREADS, r = u / 4, c = u % 4, gm = m0 + r;
    a_row[i] = A + (size_t)(gm < M ? gm : 0) * K;
    a_lim[i] = gm < M ? kend : 0;
    a_col[i] = kb + 16 * c;
    a_dst[i] = a_unit(r, c) * 16;
  }
  auto load_stage = [&](int slot, int kt) {
    int8_t* as = As + slot * BM * BK;
#pragma unroll
    for (int i = 0; i < AU; ++i)
      copy16<V16>(as + a_dst[i], a_row[i], a_col[i] + kt * BK, a_lim[i], wa);
    int8_t* bs = Bs + slot * BK * BN;
#pragma unroll
    for (int i = 0; i < BU; ++i) {
      const int u = tid + i * MM_THREADS;
      if (u >= BK * BN / 16) break;
      const int r = u / (BN / 16), c = u % (BN / 16);
      const int gk = kb + kt * BK + r;
      copy16<V16>(bs + r * BN + 16 * c, B + (size_t)(gk < kend ? gk : 0) * N,
                  n0 + 16 * c, gk < kend ? N : 0, wb);
    }
  };

  // one task: 16 k rows x 4 columns of the N-major stage -> four 16-byte
  // K-major units of the transposed tile
  auto transpose_stage = [&](const int8_t* bs) {
    constexpr int TASKS = (BK / 16) * (BN / 4);
    if (tid >= TASKS) return;
    const int cg = tid % (BN / 4), kc = tid / (BN / 4);
    unsigned w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      w[i] = *reinterpret_cast<const unsigned*>(bs + (kc * 16 + i) * BN +
                                                cg * 4);
    unsigned col[4][4];   // [column j][k quad q]
#pragma unroll
    for (int q = 0; q < 4; ++q)
      transpose4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3],
                 col[0][q], col[1][q], col[2][q], col[3][q]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint4*>(Bt + b_unit(cg * 4 + j, kc) * 16) =
          make_uint4(col[j][0], col[j][1], col[j][2], col[j][3]);
  };

  // ldmatrix addresses: A (i, k32 step s) relative to the stage; B (j)
  unsigned a_off[MI][2], b_addr[NI];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int s = 0; s < 2; ++s)
      a_off[i][s] = a_unit(wm * (BM / WM) + i * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8,
                           2 * s + (lane >> 4)) * 16;
#pragma unroll
  for (int j = 0; j < NI; ++j)
    b_addr[j] = smem_addr(Bt + b_unit(wn * (BN / WN) + j * 8 + (lane & 7),
                                      lane >> 3) * 16);

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2));
    __syncthreads();
    transpose_stage(Bs + (kt % STAGES) * BK * BN);
    if (kt + STAGES - 1 < nk)
      load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    __syncthreads();

    const unsigned as = smem_addr(As + (kt % STAGES) * BM * BK);
    unsigned bf[NI][4];   // per column fragment: k units 0..3 of the step
#pragma unroll
    for (int j = 0; j < NI; ++j) ldmatrix4(bf[j], b_addr[j]);
#pragma unroll
    for (int s = 0; s < 2; ++s) {      // two k32 steps of the 64-byte stage
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        unsigned af[4];
        ldmatrix4(af, as + a_off[i][s]);
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_s8(acc[i][j], af, bf[j][2 * s], bf[j][2 * s + 1]);
      }
    }
  }

  // the block's sums into shared memory: accumulator (i, j, r) is row g (+ 8
  // for r >= 2), columns 2t and 2t + 1
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  int* cs = reinterpret_cast<int*>(mm_smem);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * (BM / WM) + i * 16 + g + 8 * h;
        const int c = wn * (BN / WN) + j * 8 + 2 * t4;
        *reinterpret_cast<int2*>(cs + r * (BN + CPAD) + c) =
            make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __syncthreads();
  // thread tid owns column n0 + tid % BN of the tile and rows tid / BN + j *
  // (MM_THREADS / BN), four at a time; its column's operands load once
  constexpr int RSTEP = MM_THREADS / BN;
  const int nl = tid % BN, n = n0 + nl;
  const int rows = min(BM, M - m0);
  if (n >= N) return;
  const Col col = fused ? col_of(e, n) : Col{};
  for (int r = tid / BN; r < rows; r += 4 * RSTEP) {
    int sums[4], m[4], cnt = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int rq = r + q * RSTEP;
      const bool ok = rq < rows;
      sums[q] = ok ? cs[rq * (BN + CPAD) + nl] : 0;
      m[q] = m0 + rq;
      cnt += ok;
    }
    if (fused) {
      store4<false>(e, col, sums, m, cnt, n, N, C);
    } else if (splits == 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < cnt) part[(size_t)m[q] * N + n] = sums[q];
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < cnt) atomicAdd(&part[(size_t)m[q] * N + n], sums[q]);
    }
  }
}

// Pooled epilogue: grid (ceil(N / PBN), G); 4 x PBN / 32 warps, warp (wm, wn)
// taking row tiles wm, wm + 4, ... of 16 rows and columns [32 wn, 32 wn +
// 32) of the strip.  The block runs the image's rows in passes of pr rows
// and K in slices of kc bytes (pool_plan): one pass and one slice where the
// operands fit the shared memory, all staged at once (every served head);
// else passes of 64 rows, one tile a warp whose accumulators stay on the
// fragments across the slices, with B's strip staged once where K fits
// whole.  Dynamic shared memory (pool_smem): A [kc / 64][pr][64] (a_unit),
// the K-major B tile [kc / 64][BN][64] (b_unit), B's N-major strip [kc][BN]
// as copied, R's strip [pr][BN] (HAS_RES), the column sums [4][BN].
// HAS_RES: the bottleneck's shortcut R [G, rows, N] int8 is added before
// the pool (qdq at mid_scale, + r * res_scale, add_act, qdq at add_scale).
constexpr int PBN = 64;   // output columns a block (scripts/cnn_probe.py)
constexpr int POOL_SMEM_MAX = 232448;   // the H100's shared memory a block

inline size_t pool_smem(int pr, int kc, bool has_res) {
  return (size_t)kc * pr + 2 * (size_t)kc * PBN +
         (has_res ? (size_t)pr * PBN : 0) + 4 * (size_t)PBN * sizeof(int);
}

// The pass rows pr (a multiple of 16) and K slice kc (of 64) of pool_kernel:
// all rows and all of K where that fits, else passes of at most 64 rows --
// one tile a warp, as the kernel needs wherever K is sliced -- and the
// widest slice that fits (64 always does).
struct PoolPlan {
  int pr, kc;
  bool sliced;   // more than one pass or slice
};

inline PoolPlan pool_plan(int rows, int K, bool has_res) {
  const int rp = (rows + 15) / 16 * 16, kp = (K + BK - 1) / BK * BK;
  if (pool_smem(rp, kp, has_res) <= POOL_SMEM_MAX) return {rp, kp, false};
  const int pr = rp < 64 ? rp : 64;
  int kc = kp;
  while (pool_smem(pr, kc, has_res) > POOL_SMEM_MAX) kc -= BK;
  return {pr, kc, true};
}

// SLICED false: one pass and one slice (pr and kc ignored), every loop
// over passes and slices folded away at compile time.
template <bool HAS_RES, bool SLICED>
__global__ void __launch_bounds__(4 * PBN)
pool_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
            void* __restrict__ C, int rows, int N, int K, int pr, int kc,
            int wa, int wb, int wr, float a_scale,
            const float* __restrict__ w_scale,
            const float* __restrict__ bias, int act, float mid_scale,
            const int8_t* __restrict__ R, float res_scale, int add_act,
            float add_scale, float gap_scale, int out_int8, float os_val) {
  constexpr int BN = PBN, THREADS = 4 * BN, NI = 4;   // NI: n8 tiles a warp
  extern __shared__ __align__(16) unsigned char p_smem[];
  const int kp = (K + BK - 1) / BK * BK, rp = (rows + 15) / 16 * 16;
  if (!SLICED) pr = rp, kc = kp;
  int8_t* As = reinterpret_cast<int8_t*>(p_smem);
  int8_t* Bt = As + kc * pr;
  int8_t* Bs = Bt + kc * BN;
  int8_t* Rs = Bs + kc * BN;
  int* red = reinterpret_cast<int*>(Rs + (HAS_RES ? pr * BN : 0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % 4, wn = warp / 4;
  const int g = blockIdx.y, n0 = blockIdx.x * BN;
  const int8_t* Ag = A + (size_t)g * rows * K;
  const int8_t* Rg = HAS_RES ? R + (size_t)g * rows * N : R;

  const int g8 = lane >> 2, t4 = lane & 3;
  float ws[NI][2], bs[NI][2];   // this thread's columns' epilogue operands
  unsigned b_addr[NI];
#pragma unroll
  for (int j = 0; j < NI; ++j)
    b_addr[j] = smem_addr(Bt + b_unit(wn * 32 + j * 8 + (lane & 7),
                                      lane >> 3) * 16);
  int colsum[NI][2] = {};
  int acc[NI][4];
  const float rcp_mid = requant_rcp(mid_scale);
  const float rcp_add = HAS_RES ? requant_rcp(add_scale) : 0.f;

  for (int p0 = 0; p0 < rp; p0 += pr) {
    const int prn = min(pr, rp - p0), real = min(prn, rows - p0);
    for (int k0 = 0; k0 < kp; k0 += kc) {
      const int kcn = min(kc, kp - k0);
      const bool stage_b = kc < kp || p0 == 0;
      if (p0 + k0 > 0) __syncthreads();   // the last slice's reads are done
      // every copy of the slice in flight, then one wait
      for (int u = tid; u < prn * (kcn / 16); u += THREADS) {
        const int r = u / (kcn / 16), c = u % (kcn / 16), gr = p0 + r;
        copy16<false>(As + (c / 4) * pr * BK + a_unit(r, c % 4) * 16,
                      Ag + (size_t)(gr < rows ? gr : 0) * K, k0 + 16 * c,
                      gr < rows ? K : 0, wa);
      }
      for (int u = tid; stage_b && u < kcn * (BN / 16); u += THREADS) {
        const int kk = u / (BN / 16), c = u % (BN / 16), gk = k0 + kk;
        copy16<false>(Bs + kk * BN + 16 * c,
                      B + (size_t)(gk < K ? gk : 0) * N, n0 + 16 * c,
                      gk < K ? N : 0, wb);
      }
      for (int u = tid; HAS_RES && k0 == 0 && u < real * (BN / 16);
           u += THREADS) {
        const int r = u / (BN / 16), c = u % (BN / 16);
        copy16<false>(Rs + r * BN + 16 * c, Rg + (size_t)(p0 + r) * N,
                      n0 + 16 * c, N, wr);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      if (p0 + k0 == 0) {   // loaded while the first copies fly
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + wn * 32 + j * 8 + 2 * t4 + e;
            ws[j][e] = n < N ? w_scale[n] : 0.f;
            bs[j][e] = n < N && bias != nullptr ? bias[n] : 0.f;
          }
      }
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();

      // B's strip -> K-major 64-byte tiles: a task is 16 k rows x 4 columns
      for (int t = tid; stage_b && t < (kcn / 16) * (BN / 4); t += THREADS) {
        const int cg = t % (BN / 4), kq = t / (BN / 4);
        unsigned w[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          w[i] = *reinterpret_cast<const unsigned*>(Bs + (kq * 16 + i) * BN +
                                                    cg * 4);
        unsigned col[4][4];   // [column j][k quad q]
#pragma unroll
        for (int q = 0; q < 4; ++q)
          transpose4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3],
                     col[0][q], col[1][q], col[2][q], col[3][q]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint4*>(Bt + (kq / 4) * BN * BK +
                                    b_unit(cg * 4 + j, kq % 4) * 16) =
              make_uint4(col[j][0], col[j][1], col[j][2], col[j][3]);
      }
      if (stage_b) __syncthreads();

      // a sliced K keeps one tile a warp (pr <= 64), its sums on the
      // fragments from the first slice to the last
      for (int mt = wm; mt < prn / 16; mt += 4) {
        if (k0 == 0) {
#pragma unroll
          for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] = 0;
        }
        unsigned a_off[2];
#pragma unroll
        for (int s = 0; s < 2; ++s)
          a_off[s] = a_unit(mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                            2 * s + (lane >> 4)) * 16;
        for (int ch = 0; ch < kcn / BK; ++ch) {
          const unsigned as = smem_addr(As + ch * pr * BK);
          unsigned bf[NI][4];
#pragma unroll
          for (int j = 0; j < NI; ++j)
            ldmatrix4(bf[j], b_addr[j] + ch * BN * BK);
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            unsigned af[4];
            ldmatrix4(af, as + a_off[s]);
#pragma unroll
            for (int j = 0; j < NI; ++j)
              mma_s8(acc[j], af, bf[j][2 * s], bf[j][2 * s + 1]);
          }
        }
        if (k0 + kcn < kp) continue;            // more slices to come
        // accumulator (j, 2h + e): pass row mt * 16 + g8 + 8h, column 2 t4
        // + e
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g8 + 8 * h;
          if (p0 + r >= rows) continue;         // a padded row
#pragma unroll
          for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = __fmul_rn(
                  __fmul_rn(__int2float_rn(acc[j][2 * h + e]), a_scale),
                  ws[j][e]);
              if (bias != nullptr) x = __fadd_rn(x, bs[j][e]);
              x = apply_act(x, act);
              if (HAS_RES) {
                const float rv = static_cast<float>(
                    Rs[r * BN + wn * 32 + j * 8 + 2 * t4 + e]);
                x = apply_act(
                    __fadd_rn(__fmul_rn(qdq_code_rcp(x, mid_scale, rcp_mid),
                                        mid_scale),
                              __fmul_rn(rv, res_scale)), add_act);
              }
              colsum[j][e] += code_int(
                  HAS_RES ? qdq_code_rcp(x, add_scale, rcp_add)
                          : qdq_code_rcp(x, mid_scale, rcp_mid));
            }
        }
      }
    }
  }
  // the 8 row lanes g8 of each column, then the 4 row warps wm
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int v = colsum[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g8 == 0) red[wm * BN + wn * 32 + j * 8 + 2 * t4 + e] = v;
    }
  __syncthreads();
  if (tid < BN && n0 + tid < N) {
    const int s = red[tid] + red[BN + tid] + red[2 * BN + tid] +
                  red[3 * BN + tid];
    const float y = __fmul_rn(__int2float_rn(s), gap_scale);
    const size_t idx = (size_t)g * N + n0 + tid;
    if (out_int8)
      static_cast<int8_t*>(C)[idx] = static_cast<int8_t>(qdq_code(y, os_val));
    else
      static_cast<float*>(C)[idx] = y;
  }
}

int launch_stream(const int8_t* a, const int8_t* b, void* C, int M, int N,
                  int K, int ks, int wa, int wb, int* part, int splits,
                  int fused, const Epi& e, cudaStream_t s) {
  constexpr int BN = ST_CT * ST_CW;
  const dim3 grid((N + BN - 1) / BN, splits);
  const int smem = ST_M * BN * 4 + ST_M * ks;
  if (wb == 16)
    stream_kernel<true><<<grid, ST_THREADS, smem, s>>>(
        a, b, C, M, N, K, ks, wa, wb, part, splits, fused, e);
  else
    stream_kernel<false><<<grid, ST_THREADS, smem, s>>>(
        a, b, C, M, N, K, ks, wa, wb, part, splits, fused, e);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int WM, int WN, bool V16>
int launch_mma_v(const int8_t* a, const int8_t* b, void* C, int M, int N,
                 int K, int ks, int wa, int wb, int* part, int splits,
                 int fused, const Epi& e, cudaStream_t s) {
  constexpr int smem = mma_smem<BM, BN>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      mma_kernel<BM, BN, WM, WN, V16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  mma_kernel<BM, BN, WM, WN, V16><<<grid, MM_THREADS, smem, s>>>(
      a, b, C, M, N, K, ks, wa, wb, part, splits, fused, e);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int WM, int WN>
int launch_mma(const int8_t* a, const int8_t* b, void* C, int M, int N,
               int K, int ks, int wa, int wb, int* part, int splits,
               int fused, const Epi& e, cudaStream_t s) {
  if (wa == 16 && wb == 16)
    return launch_mma_v<BM, BN, WM, WN, true>(a, b, C, M, N, K, ks, wa, wb,
                                              part, splits, fused, e, s);
  return launch_mma_v<BM, BN, WM, WN, false>(a, b, C, M, N, K, ks, wa, wb,
                                             part, splits, fused, e, s);
}

bool width_ok(int w, int extent, const void* p) {
  return (w == 1 || w == 2 || w == 4 || w == 8 || w == 16) &&
         extent % w == 0 && reinterpret_cast<uintptr_t>(p) % w == 0;
}

// The widest copy (16, 8, 4, 2 or 1 bytes) that divides a row of `extent`
// bytes and the pointer's alignment.
int copy_width(int extent, const void* p) {
  for (int w = 16; w > 1; w /= 2)
    if (width_ok(w, extent, p)) return w;
  return 1;
}

template <bool HAS_RES>
int launch_pool(const int8_t* a, const int8_t* b, void* C, int G, int rows,
                int N, int K, float a_scale, const float* ws, const float* bs,
                int act, float mid_scale, const int8_t* r, float res_scale,
                int add_act, float add_scale, float gap_scale, int out_int8,
                float os_val, cudaStream_t s) {
  const PoolPlan p = pool_plan(rows, K, HAS_RES);
  const auto kernel = p.sliced ? pool_kernel<HAS_RES, true>
                               : pool_kernel<HAS_RES, false>;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(pool_kernel<HAS_RES, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           POOL_SMEM_MAX),
      cudaFuncSetAttribute(pool_kernel<HAS_RES, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           POOL_SMEM_MAX)};
  if (attr[p.sliced] != cudaSuccess) return static_cast<int>(attr[p.sliced]);
  const dim3 grid((N + PBN - 1) / PBN, G);
  kernel<<<grid, 4 * PBN, pool_smem(p.pr, p.kc, HAS_RES), s>>>(
      a, b, C, rows, N, K, p.pr, p.kc, copy_width(K, a), copy_width(N, b),
      HAS_RES ? copy_width(N, r) : 1, a_scale, ws, bs, act, mid_scale, r,
      res_scale, add_act, add_scale, gap_scale, out_int8, os_val);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C = epilogue(A[M,K] @ B[K,N]) on the plan kernels/conv_pe.py::plan made:
// path 0 streams (M <= 4, bm = 4, bn = 128, K slices of ks, a multiple of
// 128 up to 2048), path 1 runs tensor-core tiles (bm = 128, bn = 128 / 64 /
// 32, ks a multiple of 64); `splits` slices of ks cover K, each non-empty.
// wa / wb: the copy widths of A's and B's rows (they divide K / N and the
// pointers' alignment).  fused (splits == 1 only): the kernel runs the
// epilogue; else its int32 sums go to part [M * N] (zeroed here first when
// splits > 1, where the slices add into it) and epilogue_pass runs it over
// the card.  gelu (act or add_act) takes unfused plans only: it runs in
// epilogue_pass<true>.
// Pointers are device pointers (nullptr for an absent operand); the
// launches go on `stream`.  Returns cudaErrorInvalidValue for a plan it
// does not take, else cudaGetLastError(), so the caller sees a refused
// launch.
extern "C" int conv_pe_gemm(const void* A, const void* B, void* C, int M,
                            int N, int K, int path, int bm, int bn,
                            int splits, int ks, int wa, int wb, int fused,
                            void* part,
                            const void* a_scale, float a_scale_val,
                            const void* w_scale, const void* bias, int act,
                            int out_int8, const void* os_vec, float os_val,
                            const void* res, int res_f32, float res_scale,
                            int has_mid, float mid_scale, int add_act,
                            void* stream) {
  constexpr int bad = static_cast<int>(cudaErrorInvalidValue);
  if (M < 1 || N < 1 || K < 1 || splits < 1 || ks < 1 ||
      static_cast<long long>(ks) * splits < K ||
      static_cast<long long>(ks) * (splits - 1) >= K ||
      (splits > 1 && fused) || (!fused && part == nullptr) ||
      ((act == ACT_GELU || add_act == ACT_GELU) && fused) ||
      !width_ok(wa, K, A) ||
      !width_ok(wb, N, B))
    return bad;
  Epi e{static_cast<const float*>(a_scale), a_scale_val,
        static_cast<const float*>(w_scale), static_cast<const float*>(bias),
        act, out_int8, static_cast<const float*>(os_vec), os_val, res,
        res_f32, res_scale, has_mid, mid_scale, add_act};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int8_t*>(A);
  const auto* b = static_cast<const int8_t*>(B);
  auto* p = static_cast<int*>(part);
  if (splits > 1) {
    const cudaError_t z =
        cudaMemsetAsync(p, 0, sizeof(int) * static_cast<size_t>(M) * N, s);
    if (z != cudaSuccess) return static_cast<int>(z);
  }
  int err = bad;
  if (path == 0) {
    if (ks % ST_KG == 0 && ks <= 2048 && M <= ST_M && bm == ST_M &&
        bn == ST_CT * ST_CW)
      err = launch_stream(a, b, C, M, N, K, ks, wa, wb, p, splits, fused, e,
                          s);
  } else if (path == 1 && bm == 128 && ks % BK == 0) {
    if (bn == 128)
      err = launch_mma<128, 128, 2, 4>(a, b, C, M, N, K, ks, wa, wb, p,
                                      splits, fused, e, s);
    else if (bn == 64)
      err = launch_mma<128, 64, 4, 2>(a, b, C, M, N, K, ks, wa, wb, p,
                                     splits, fused, e, s);
    else if (bn == 32)
      err = launch_mma<128, 32, 8, 1>(a, b, C, M, N, K, ks, wa, wb, p,
                                     splits, fused, e, s);
  }
  if (err != 0 || fused) return err;
  const dim3 grid((N + EP_COLS - 1) / EP_COLS, (M + EP_ROWS - 1) / EP_ROWS);
  if (act == ACT_GELU || add_act == ACT_GELU)
    epilogue_pass<true><<<grid, 256, 0, s>>>(p, C, M, N, e);
  else
    epilogue_pass<false><<<grid, 256, 0, s>>>(p, C, M, N, e);
  return static_cast<int>(cudaGetLastError());
}

// C[G, N] = global-pool(qdq(epilogue(A[g] @ B))) per image g, static chain:
// codes at mid_scale, int32 sum over the rows, times gap_scale (the host's
// pre-pool scale / rows rounded once to f32), requant at os_val when
// out_int8.  With R [G, rows, N] int8 (else nullptr) the residual add runs
// first and the pre-pool scale is add_scale.  Any rows and K: operands
// past the shared memory are staged in passes of rows and slices of K.
// Returns cudaErrorInvalidValue for an empty or too-tall grid, else
// cudaGetLastError().
extern "C" int conv_pe_pool(const void* A, const void* B, void* C, int G,
                            int rows, int N, int K, float a_scale,
                            const void* w_scale, const void* bias, int act,
                            float mid_scale, const void* R, float res_scale,
                            int add_act, float add_scale, float gap_scale,
                            int out_int8, float os_val, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int8_t*>(A);
  const auto* b = static_cast<const int8_t*>(B);
  const auto* ws = static_cast<const float*>(w_scale);
  const auto* bs = static_cast<const float*>(bias);
  const auto* r = static_cast<const int8_t*>(R);
  if (G < 1 || rows < 1 || N < 1 || K < 1 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R != nullptr)
    return launch_pool<true>(a, b, C, G, rows, N, K, a_scale, ws, bs, act,
                             mid_scale, r, res_scale, add_act, add_scale,
                             gap_scale, out_int8, os_val, s);
  return launch_pool<false>(a, b, C, G, rows, N, K, a_scale, ws, bs, act,
                            mid_scale, r, res_scale, add_act, add_scale,
                            gap_scale, out_int8, os_val, s);
}
