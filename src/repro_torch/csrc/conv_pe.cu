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
// chains.  Inside a tensor-core kernel only 8-16 warps an SM share a 128 x
// 128 tile's 16,384 outputs, which measured slower than a pass of its own:
// so the planner fuses the epilogue only into unsplit narrow tiles and the
// stream kernel; otherwise the product leaves its int32 sums in a scratch
// [M, N] (allocated by the wrapper) and epilogue_pass runs over the whole
// card.  A split K adds its slices into that scratch, zeroed, with
// atomicAdd: an int32 sum is exact in any order, so every plan gives the
// same bits.
//
// The pooled variant is bytes-bound at MobileNetV2's and ResNet50's shapes:
// one block owns one image's ho*wo rows for 64 columns, requantizes every row
// in registers, sums the codes in int32 and writes one pooled int8 value per
// column -- the pre-pool feature map never reaches device memory.
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

__device__ __forceinline__ void act4(float (&x)[4], int act) {
  if (act == ACT_RELU) {
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = fmaxf(x[q], 0.f);
  } else if (act == ACT_RELU6) {
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = fminf(fmaxf(x[q], 0.f), 6.f);
  }
}

// The epilogue of outputs (m[q], n), q < cnt (cnt >= 1), each on its
// complete int32 sum: dequant, bias and act in dequant_bias_act's order,
// the residual tail, the requant -- apply_act / qdq_code's arithmetic, four
// outputs at a time, so each branch on the options is taken once for four
// independent chains.
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
  act4(x, e.act);
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
    act4(x, e.add_act);
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
// a thread.
constexpr int EP_COLS = 128, EP_ROWS = 8;

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
  store4(e, col_of(e, n), acc, m, cnt, n, N, C);
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
    store4(e, col_of(e, n), sums, m, cnt, n, N, C);
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
      store4(e, col, sums, m, cnt, n, N, C);
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

}  // namespace

// C = epilogue(A[M,K] @ B[K,N]) on the plan kernels/conv_pe.py::plan made:
// path 0 streams (M <= 4, bm = 4, bn = 128, K slices of ks, a multiple of
// 128 up to 2048), path 1 runs tensor-core tiles (bm = 128, bn = 128 / 64 /
// 32, ks a multiple of 64); `splits` slices of ks cover K, each non-empty.
// wa / wb: the copy widths of A's and B's rows (they divide K / N and the
// pointers' alignment).  fused (splits == 1 only): the kernel runs the
// epilogue; else its int32 sums go to part [M * N] (zeroed here first when
// splits > 1, where the slices add into it) and epilogue_pass runs it over
// the card.
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
  epilogue_pass<<<grid, 256, 0, s>>>(p, C, M, N, e);
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
