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
//   x[m, n] = sum_g S[g, n] * p_g[m, n]      p_g = A[m, g] . codes[g, n]
//           + sum_g Z[g, n] * r_g[m]         r_g = sum(A[m, g])
//
// then * a_scale, + bias, act, [qdq at mid_scale, + r * res_scale,
// add_act], requant -- kernels/ref.py::int4_group_dot and the epilogue of
// matmul_int8_fused.  The bar is bit-for-bit equality with that plain
// version, whose f32 fold runs in a fixed order: acc_s += p_g * s_g and
// acc_z += r_g * z_g side by side, g = 0, 1, ..., G-1, each product and sum
// rounded once (explicitly rounded intrinsics, --fmad=false), then acc_s +
// acc_z.  So no kernel here hands on an f32 sum over part of K: a K split
// carries the exact int32 p_g of each group, and the fold reads them in
// group order.
//
// conv_pe_w4 runs one of two kernels, chosen per product by the planner in
// kernels/conv_pe.py::plan_w4 and passed in as (route, tile, groups a
// chunk, copy widths); nothing here picks or falls back.
//
// * Few rows (the decode step, M = 4) -- stream_kernel.  Each packed byte
//   feeds 2 x M MACs, so the product is bound by reading the weights once
//   (qwen2's down projection, 7.74 MB with scales and zeros: 2.3 us at 3.35
//   TB/s).  A block owns 4 rows and a strip of 16 or 32 columns over all of K
//   (narrow strips: 96 blocks at N = 1536), in chunks of gc whole groups that
//   stream through a ring of two shared-memory slots by cp.async (packed rows
//   as 16-byte pieces along N, A's rows, the groups' f16 scales and zeros),
//   the next chunk in flight while this one is multiplied.  The block's 256
//   threads split a chunk into sub-tasks -- two quads (4 k, two packed rows)
//   of one group for one 16-column thread, one where the group's quads are odd
//   -- so many groups are multiplied at once: a sub-task unpacks the nibbles
//   in registers (masks, shifts and a 4x4 __byte_perm transpose) into each
//   column's int8x4 word of 4 consecutive k and __dp4a's it against A.  The
//   sub-tasks' exact int32 sums meet by shared-memory atomicAdd in their
//   group's slot, and one thread per (row, column) folds the chunk's groups in
//   order into its f32 sums while the next chunk is multiplied.  Rows past 4
//   take more row tiles (the weights again, from L2).
// * More rows (prefill, M = 4 x 64) -- mma_kernel.  Tiles of 64 x 64 (rows
//   and columns past M and N masked), one 16 x 32 output tile a warp, on
//   mma.sync.m16n8k32 s8 x s8 -> s32 (codes 0..15 are valid s8).  A, the packed B and the scales
//   and zeros of each k32 step's group stream through a 4-slot cp.async
//   ring, 3 stages ahead; each stage's 32 packed rows are unpacked and
//   transposed into the K-major int8 tile that ldmatrix reads (conv_pe.cu's
//   swizzle) one stage ahead, into one of two tiles, so one barrier a stage
//   orders the ring; the weights are read once a row tile.  Each group
//   (gs a multiple of 32) restarts its accumulators at the bits of 1.5 x
//   2^23 as an f32 (the C operand of its first mma), so after the group they
//   read as 1.5 x 2^23 + p_g (|p_g| < 2^22) and one exact f32 subtraction
//   gives p_g with no int-to-float conversion (a quarter-rate instruction).
//   The group is folded in registers into f32 acc_s / acc_z -- five f32
//   operations an output, against 64 MACs (gs = 64) on the tensor cores;
//   r_g comes from the lane's own A fragments (__dp4a against ones, summed
//   over the four lanes of a row by two shuffles).  No scratch, no second
//   pass.  What holds it back: two f32 sums an output live in registers for
//   all of K, so a 128-register thread keeps a 64 x 64 tile at most, and
//   64-column tiles read A from L2 N / 64 times (110 MB at qwen2's gate/up
//   against the int8 kernel's 55 MB).
//
// The epilogue runs once per output on its folded sum (the tiles stage
// their sums in shared memory first, so it runs in a loop over the tile).
// Neither kernel splits K across blocks: that would carry M x G x N int32
// sums through device memory (16 bytes a column and group at M = 4 against
// 36 of weights; 220 MB for qwen2's down projection at M = 256) and fold
// them in a pass of its own.
#include <cuda_fp16.h>

#include "epilogue.cuh"
#include "mma_s8.cuh"

namespace {

using namespace repro;

struct Epi {
  const float* a_scale;   // [M] per-row activation scale, or nullptr
  float a_scale_val;      // the static per-tensor scale otherwise
  const float* bias;      // [N] or nullptr
  int act;
  int out_int8;           // 1: requant to int8, 0: f32 out
  const float* os_vec;    // [N] per-column requant scale, or nullptr
  float os_val;
  const void* res;        // [M, N] residual operand (int8 or f32), or nullptr
  int res_f32;
  float res_scale;
  int has_mid;            // static chain: qdq at mid_scale before the add
  float mid_scale;
  int add_act;
};

// Output (m, n) from its folded sum x = acc_s + acc_z: * a_scale, + bias,
// act, [qdq at mid_scale, + r * res_scale, add_act], requant -- the plain
// version's order.
__device__ __forceinline__ void store_out(const Epi& e, float x, int m, int n,
                                          int N, void* C) {
  const size_t idx = (size_t)m * N + n;
  x = __fmul_rn(x, e.a_scale != nullptr ? e.a_scale[m] : e.a_scale_val);
  if (e.bias != nullptr) x = __fadd_rn(x, e.bias[n]);
  x = apply_act(x, e.act);
  if (e.res != nullptr) {
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

// d = a x b + (c, c, c, c): a group's first k32 step, which restarts the
// accumulator at c (s8 x s8 -> s32, the fragments of mma_s8.cuh)
__device__ __forceinline__ void mma_s8_from(int (&d)[4],
                                            const unsigned (&a)[4],
                                            unsigned b0, unsigned b1, int c) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(c));
}

// Packed rows 2i (x) and 2i + 1 (y) of four columns (column j in byte j; k
// = 4i, 4i + 1 in x's low / high nibble, 4i + 2, 4i + 3 in y's) -> each
// column's four codes as one int8x4 word, k = 4i in the low byte.
__device__ __forceinline__ void unpack4(unsigned x, unsigned y,
                                        unsigned (&c)[4]) {
  transpose4(x & 0x0F0F0F0Fu, (x >> 4) & 0x0F0F0F0Fu, y & 0x0F0F0F0Fu,
             (y >> 4) & 0x0F0F0F0Fu, c[0], c[1], c[2], c[3]);
}

// ---------------------------------------------------------------------------
// Few rows: weight streaming, the groups folded in shared memory
// ---------------------------------------------------------------------------

constexpr int ST_THREADS = 256;
constexpr int ST_M = 4;                 // rows a block
constexpr int ST_QPT = 2;               // quads a sub-task at most
constexpr int CW = 16;                  // columns a column thread: 16 bytes
constexpr int ST_SLOTS = 2;             // the chunk ring's slots
constexpr int SMEM_MAX = 232448;        // dynamic shared memory a block

// A stream block's shared memory (bytes): ST_SLOTS chunk slots, each the
// packed rows of gc groups (each group's gs / 2 rows of BN bytes, padded by
// 16 x CT bytes so that sub-tasks of neighbouring groups read distinct
// banks) and A's 4 rows over the chunk's gc x gs K values; then, by chunk
// mod 3, the groups' f16 scales and zeros [gc][BN] each and the activation
// sums [gc][4]; and by chunk parity the groups' int32 sums [gc][4 * BN + 1]
// (one word of padding a group: neighbouring groups add into distinct
// banks).  A chunk's scales and sums outlive its slot: they are folded
// while the next chunk is multiplied.
__host__ __device__ constexpr int w_group(int gs, int bn, int ct) {
  return gs / 2 * bn + 16 * ct;
}
__host__ __device__ constexpr int stream_slot(int gc, int gs, int bn,
                                              int ct) {
  return gc * w_group(gs, bn, ct) + ST_M * gc * gs;
}
__host__ __device__ constexpr int stream_smem(int gc, int gs, int bn,
                                              int ct) {
  return ST_SLOTS * stream_slot(gc, gs, bn, ct) + 3 * 4 * gc * bn +
         3 * 4 * gc * ST_M + 2 * 4 * gc * (ST_M * bn + 1);
}

// n / d for n * d < 2^32 with a multiply-high: m = ceil(2^32 / d).
struct FastDiv {
  unsigned d, m;
  __device__ explicit FastDiv(int d_)
      : d(d_), m(d_ > 1 ? 0xFFFFFFFFu / d_ + 1 : 0) {}
  __device__ int div(int n) const {
    return d > 1 ? __umulhi(static_cast<unsigned>(n), m) : n;
  }
};

// grid (ceil(N / BN), ceil(M / 4)); BN = 16 x CT columns, CT column threads
// of 16 columns (one 16-byte vector of a packed row).  K runs in chunks of gc
// groups through a ring of ST_SLOTS slots: chunk c + 1's cp.async copies
// are in flight while chunk c is multiplied and chunk c - 1 folded (by the
// block's last 4 x BN threads, after their sub-tasks), one barrier a
// chunk.  wb: the copy width of P's rows (16-byte copies when it is 16,
// else bytes: ragged N).
template <int CT>
__global__ void __launch_bounds__(ST_THREADS, 2)
stream_kernel(const int8_t* __restrict__ A, const uint8_t* __restrict__ P,
              const __half* __restrict__ S, const __half* __restrict__ Z,
              void* __restrict__ C, int M, int N, int K, int gs, int gc,
              int wb, Epi e) {
  constexpr int BN = CW * CT, PSTR = ST_M * BN + 1;
  extern __shared__ __align__(16) unsigned char st_smem[];
  const int wgrp = w_group(gs, BN, CT), slot = stream_slot(gc, gs, BN, CT);
  __half* szr = reinterpret_cast<__half*>(st_smem + ST_SLOTS * slot);
  int* asum = reinterpret_cast<int*>(szr + 3 * 2 * gc * BN);  // [3][gc][4]
  int* part = asum + 3 * gc * ST_M;                   // [2][gc][PSTR]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * ST_M;
  const int G = K / gs, qg = gs / 4, chunks = (G + gc - 1) / gc;
  const int qpt = qg % ST_QPT ? 1 : ST_QPT;    // quads a sub-task
  const bool wv = wb == 16;
  // A's chunk rows take 16-byte copies when A's rows and chunks are
  // 16-byte aligned
  const bool a16 = K % 16 == 0 && gs % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const FastDiv rows_g(gs / 2);           // packed rows -> group
  const bool sz16 = N % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(S) | reinterpret_cast<uintptr_t>(Z)) %
          16 == 0;

  auto load_chunk = [&](int c) {
    unsigned char* w = st_smem + c % ST_SLOTS * slot;
    int* a = reinterpret_cast<int*>(w + gc * wgrp);
    __half* sh = szr + c % 3 * 2 * gc * BN;
    __half* zh = sh + gc * BN;
    const int g0 = c * gc, gn = min(gc, G - g0), rows = gn * gs / 2;
    for (int i = tid; i < rows * CT; i += ST_THREADS) {
      const int r = i / CT, col = n0 + i % CT * CW, gl = rows_g.div(r);
      unsigned char* dst =
          w + gl * wgrp + (r - gl * (gs / 2)) * BN + (col - n0);
      const uint8_t* src = P + ((size_t)g0 * gs / 2 + r) * N + col;
      if (wv) {
        cp_async<16>(dst, col < N ? src : P, col < N);
      } else {
        for (int b = 0; b < CW; ++b) dst[b] = col + b < N ? src[b] : 0;
      }
    }
#pragma unroll
    for (int r = 0; r < ST_M; ++r) {      // A's rows, zero past M: 16-byte
      const int gm = m0 + r;              // copies, or 4-byte words
      const int8_t* src = A + (size_t)(gm < M ? gm : 0) * K + (size_t)g0 * gs;
      if (a16) {
        for (int i = tid; i < gn * gs / 16; i += ST_THREADS)
          cp_async<16>(a + r * gc * qg + 4 * i, src + 16 * i, gm < M);
      } else {
        for (int i = tid; i < gn * qg; i += ST_THREADS)
          cp_async<4>(a + r * gc * qg + i, src + 4 * i, gm < M);
      }
    }
    if (sz16) {                           // 8 halfs a copy
#pragma unroll
      for (int zr = 0; zr < 2; ++zr)
        for (int i = tid; i < gn * (BN / 8); i += ST_THREADS) {
          const int gl = i / (BN / 8), col = n0 + i % (BN / 8) * 8;
          const __half* src = (zr ? Z : S) + (size_t)(g0 + gl) * N + col;
          cp_async<16>((zr ? zh : sh) + gl * BN + (col - n0),
                       col < N ? src : S, col < N);
        }
    } else {
      for (int i = tid; i < gn * BN; i += ST_THREADS) {
        const int n = n0 + i % BN;
        const size_t gi = (size_t)(g0 + i / BN) * N + n;
        sh[i] = n < N ? S[gi] : __float2half(0.f);
        zh[i] = n < N ? Z[gi] : __float2half(0.f);
      }
    }
  };

  // the fold: the last 4 x BN threads, thread (fm, fn) owning output
  // (m0 + fm, n0 + fn) -- they have the fewest sub-tasks
  const int f = ST_THREADS - 1 - tid, fm = f / BN, fn = f % BN;
  const bool folds = f < ST_M * BN && m0 + fm < M && n0 + fn < N;
  float acc_s = 0.f, acc_z = 0.f;
  // chunk c's groups in order, four loaded at a time; each int32 sum is
  // zeroed for chunk c + 2
  auto fold = [&](int c) {
    const int gn = min(gc, G - c * gc);
    const __half* sh = szr + c % 3 * 2 * gc * BN;
    const __half* zh = sh + gc * BN;
    const int* as = asum + c % 3 * gc * ST_M;
    int* pc = part + (c & 1) * gc * PSTR + fm * BN + fn;
    for (int g0 = 0; g0 < gn; g0 += 4) {
      int pv[4], rv[4];
      float sv[4], zv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int gl = min(g0 + u, gn - 1);
        pv[u] = pc[gl * PSTR];
        rv[u] = as[gl * ST_M + fm];
        sv[u] = __half2float(sh[gl * BN + fn]);
        zv[u] = __half2float(zh[gl * BN + fn]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (g0 + u >= gn) break;
        pc[(g0 + u) * PSTR] = 0;
        acc_s = __fadd_rn(acc_s, __fmul_rn(__int2float_rn(pv[u]), sv[u]));
        acc_z = __fadd_rn(acc_z, __fmul_rn(__int2float_rn(rv[u]), zv[u]));
      }
    }
  };

  for (int i = tid; i < 2 * gc * PSTR; i += ST_THREADS) part[i] = 0;
  for (int i = tid; i < 2 * gc * ST_M; i += ST_THREADS) asum[i] = 0;
  load_chunk(0);
  asm volatile("cp.async.commit_group;\n" ::);

  for (int c = 0; c < chunks; ++c) {
    // chunk c has landed; every thread is done with chunk c - 1's
    // sub-tasks (its slot takes chunk c + 1) and chunk c - 2's fold (its
    // scales and activation sums take chunk c + 1's, its int32 sums chunk
    // c's, zeroed)
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (c + 1 < chunks) load_chunk(c + 1);
    asm volatile("cp.async.commit_group;\n" ::);
    for (int i = tid; i < gc * ST_M; i += ST_THREADS)
      asum[(c + 1) % 3 * gc * ST_M + i] = 0;
    const unsigned char* w = st_smem + c % ST_SLOTS * slot;
    const int* a = reinterpret_cast<const int*>(w + gc * wgrp);
    const int gn = min(gc, G - c * gc);
    int* as_c = asum + c % 3 * gc * ST_M;
    int* part_c = part + (c & 1) * gc * PSTR;
    // sub-task t: column thread t % CT, group (t / CT) % gn, quads
    // [q0, q0 + qpt) of it -- neighbouring lanes on distinct groups
    const FastDiv groups(gn);
    for (int t = tid; t < gn * CT * (qg / qpt); t += ST_THREADS) {
      const int ct = t % CT, tg = t / CT, qs = groups.div(tg);
      const int gl = tg - qs * gn, q0 = qs * qpt;
      const unsigned char* src = w + gl * wgrp + 2 * q0 * BN + ct * CW;
      int acc[ST_M][CW], rsum[ST_M];
#pragma unroll
      for (int m = 0; m < ST_M; ++m) {
        rsum[m] = 0;
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[m][j] = 0;
      }
#pragma unroll
      for (int q = 0; q < ST_QPT; ++q) {
        if (q >= qpt) break;
        const uint4 xv = *reinterpret_cast<const uint4*>(src + 2 * q * BN);
        const uint4 yv =
            *reinterpret_cast<const uint4*>(src + (2 * q + 1) * BN);
        const unsigned x[4] = {xv.x, xv.y, xv.z, xv.w};
        const unsigned y[4] = {yv.x, yv.y, yv.z, yv.w};
        int av[ST_M];
#pragma unroll
        for (int m = 0; m < ST_M; ++m) {
          av[m] = a[m * gc * qg + gl * qg + q0 + q];
          rsum[m] = __dp4a(av[m], 0x01010101, rsum[m]);
        }
#pragma unroll
        for (int j = 0; j < CW / 4; ++j) {
          unsigned cw[4];
          unpack4(x[j], y[j], cw);
#pragma unroll
          for (int m = 0; m < ST_M; ++m)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[m][4 * j + i] =
                  __dp4a(av[m], static_cast<int>(cw[i]), acc[m][4 * j + i]);
        }
      }
      // (rows past M and columns past N add zeros: their A words and codes
      // were staged as zeros)
      int* dst = part_c + gl * PSTR + ct * CW;
#pragma unroll
      for (int m = 0; m < ST_M; ++m) {
#pragma unroll
        for (int j = 0; j < CW; ++j) atomicAdd(dst + m * BN + j, acc[m][j]);
        if (ct == 0) atomicAdd(as_c + gl * ST_M + m, rsum[m]);
      }
    }
    if (folds && c > 0) fold(c - 1);
  }
  __syncthreads();
  if (!folds) return;
  fold(chunks - 1);
  store_out(e, __fadd_rn(acc_s, acc_z), m0 + fm, n0 + fn, N, C);
}

// ---------------------------------------------------------------------------
// More rows: int8 tensor-core tiles, the groups folded in registers
// ---------------------------------------------------------------------------

constexpr int BK = 64;              // K values a stage: two k32 steps
constexpr int STAGES = 4;           // ring slots: 3 stages loaded ahead
constexpr int CPAD = 4;             // f32 padding of the staged output rows
constexpr int MAGIC = 0x4B400000;   // the bits of 1.5 x 2^23 as an f32
constexpr float MAGIC_F = 12582912.f;
constexpr int MM_BM = 64, MM_BN = 64;     // the tile
constexpr int MM_THREADS = MM_BM * MM_BN / 16;

// A ring slot (bytes): A [BM][BK] (a_unit), the packed B [BK / 2][BN] as
// copied, and the f16 scales and zeros of the groups of the stage's two k32
// steps [2][2][BN].  Then two unpacked K-major B tiles [BN][BK] (b_unit).
constexpr int MM_SLOT = MM_BM * BK + BK / 2 * MM_BN + 8 * MM_BN;
constexpr int MM_SMEM =
    STAGES * MM_SLOT + 2 * MM_BN * BK > MM_BM * (MM_BN + CPAD) * 4
        ? STAGES * MM_SLOT + 2 * MM_BN * BK
        : MM_BM * (MM_BN + CPAD) * 4;

// grid (ceil(M / BM), ceil(N / BN)), BM x BN = MM_BM x MM_BN; (BM / 16) x
// (BN / 32) warps of 16 x 32 outputs.  Dynamic shared memory (MM_SMEM): the
// 4-slot ring (MM_SLOT) and two unpacked B tiles: stage kt + 1 is unpacked
// while stage kt is multiplied, so one barrier a stage orders the ring;
// after the K loop the same bytes hold the tile's folded f32 sums [BM][BN +
// CPAD], which the epilogue walks.  V16: every A and B copy is 16 bytes.
template <bool V16>
__global__ void __launch_bounds__(MM_THREADS, 2)
mma_kernel(const int8_t* __restrict__ A, const uint8_t* __restrict__ P,
           const __half* __restrict__ S, const __half* __restrict__ Z,
           void* __restrict__ C, int M, int N, int K, int gs, int wa, int wb,
           Epi e) {
  constexpr int BM = MM_BM, BN = MM_BN, WM = BM / 16, THREADS = MM_THREADS;
  constexpr int NI = 4;
  constexpr int SLOT = MM_SLOT;
  constexpr int AU = BM * 4 / THREADS;           // A units a thread
  constexpr int BU = BK / 2 * BN / 16;           // packed B units a stage
  constexpr int BUT = (BU + THREADS - 1) / THREADS;
  static_assert(AU >= 1 && BM * 4 % THREADS == 0 && BN <= THREADS,
                "tile shape");
  extern __shared__ __align__(16) unsigned char mm_smem[];
  int8_t* Bt = reinterpret_cast<int8_t*>(mm_smem + STAGES * SLOT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK, K2 = K / 2;
  const int8_t* Pb = reinterpret_cast<const int8_t*>(P);
  const bool sz16 = N % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(S) | reinterpret_cast<uintptr_t>(Z)) %
          16 == 0;

  const int8_t* a_row[AU];
  int a_lim[AU], a_col[AU], a_dst[AU];
#pragma unroll
  for (int i = 0; i < AU; ++i) {
    const int u = tid + i * THREADS, r = u / 4, c = u % 4, gm = m0 + r;
    a_row[i] = A + (size_t)(gm < M ? gm : 0) * K;
    a_lim[i] = gm < M ? K : 0;
    a_col[i] = 16 * c;
    a_dst[i] = a_unit(r, c) * 16;
  }
  auto load_stage = [&](int slot, int kt) {
    unsigned char* base = mm_smem + slot * SLOT;
    int8_t* as = reinterpret_cast<int8_t*>(base);
#pragma unroll
    for (int i = 0; i < AU; ++i)
      copy16<V16>(as + a_dst[i], a_row[i], a_col[i] + kt * BK, a_lim[i], wa);
    int8_t* bs = as + BM * BK;
#pragma unroll
    for (int i = 0; i < BUT; ++i) {
      const int u = tid + i * THREADS;
      if (u >= BU) break;
      const int r = u / (BN / 16), c = u % (BN / 16);
      const int gk = kt * BK / 2 + r;            // packed row
      copy16<V16>(bs + r * BN + 16 * c, Pb + (size_t)(gk < K2 ? gk : 0) * N,
                  n0 + 16 * c, gk < K2 ? N : 0, wb);
    }
    // the scales and zeros of each k32 step's group: rows [step][S, Z]
    if (tid < BN / 2) {
      __half* sz = reinterpret_cast<__half*>(bs + BK / 2 * BN);
      const int row = tid / (BN / 8), col = tid % (BN / 8) * 8;
      const int kk = kt * BK + 32 * (row >> 1), n = n0 + col;
      const __half* src = ((row & 1) ? Z : S) + (size_t)(kk / gs) * N + n;
      __half* dst = sz + row * BN + col;
      if (sz16) {
        cp_async<16>(dst, kk < K && n < N ? src : S, kk < K && n < N);
      } else {
        for (int h = 0; h < 8; ++h)
          dst[h] = kk < K && n + h < N ? src[h] : __float2half(0.f);
      }
    }
  };
  // one task: 8 packed rows (16 k) x 4 columns of a stage -> four 16-byte
  // K-major units of an unpacked tile
  auto unpack_stage = [&](const int8_t* bs, int8_t* bt) {
    if (tid >= BN) return;                       // (BK / 16) x (BN / 4) tasks
    const int cg = tid % (BN / 4), kc = tid / (BN / 4);
    unsigned w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i] = *reinterpret_cast<const unsigned*>(bs + (kc * 8 + i) * BN +
                                                cg * 4);
    unsigned col[4][4];   // [column j][k quad q]
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned cw[4];
      unpack4(w[2 * q], w[2 * q + 1], cw);
#pragma unroll
      for (int j = 0; j < 4; ++j) col[j][q] = cw[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint4*>(bt + b_unit(cg * 4 + j, kc) * 16) =
          make_uint4(col[j][0], col[j][1], col[j][2], col[j][3]);
  };

  // ldmatrix offsets: A at the stage's first k32 step (the second is unit
  // 2 + ..., the byte offset ^ 32); B (j), all four units of the stage
  const unsigned a_off = a_unit(wm * 16 + (lane & 15), lane >> 4) * 16;
  unsigned b_off[NI];
#pragma unroll
  for (int j = 0; j < NI; ++j)
    b_off[j] = b_unit(wn * 32 + j * 8 + (lane & 7), lane >> 3) * 16;

  // this lane's outputs: rows g4 (+ 8) of the warp's m16 tile, columns 2 t4
  // (+ 1) of each n8 tile j
  const int g4 = lane >> 2, t4 = lane & 3;
  int acc[NI][4] = {};            // MAGIC + the group's int32 sums
  float fs[NI][4], fz[NI][4];
  int rs[2] = {0, 0};             // the group's row sums, this lane's k
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) fs[j][q] = fz[j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2));
  __syncthreads();
  unpack_stage(reinterpret_cast<const int8_t*>(mm_smem) + BM * BK, Bt);
  int kin = 0;                    // k into the current group
  for (int kt = 0; kt < nk; ++kt) {
    // stage kt + 1 has landed; every thread is done with stage kt - 1, whose
    // slot takes stage kt + STAGES - 1
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 3));
    __syncthreads();
    if (kt + STAGES - 1 < nk)
      load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    if (kt + 1 < nk)
      unpack_stage(reinterpret_cast<const int8_t*>(
                       mm_smem + (kt + 1) % STAGES * SLOT) + BM * BK,
                   Bt + (kt + 1) % 2 * BN * BK);

    const unsigned char* base = mm_smem + kt % STAGES * SLOT;
    const unsigned as = smem_addr(base);
    const __half* sz = reinterpret_cast<const __half*>(base + BM * BK +
                                                       BK / 2 * BN);
    const unsigned bt = smem_addr(Bt + kt % 2 * BN * BK);
    unsigned bf[NI][4];   // per column fragment: k units 0..3 of the stage
#pragma unroll
    for (int j = 0; j < NI; ++j) ldmatrix4(bf[j], bt + b_off[j]);
#pragma unroll 1
    for (int s = 0; s < 2; ++s) {      // two k32 steps of the stage
      if (kt * BK + 32 * s >= K) break;
      unsigned af[4];
      ldmatrix4(af, as + (a_off ^ (32 * s)));
      rs[0] = __dp4a(static_cast<int>(af[2]), 0x01010101,
                     __dp4a(static_cast<int>(af[0]), 0x01010101, rs[0]));
      rs[1] = __dp4a(static_cast<int>(af[3]), 0x01010101,
                     __dp4a(static_cast<int>(af[1]), 0x01010101, rs[1]));
      if (kin == 0) {                  // a group's first products: C = MAGIC
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_s8_from(acc[j], af, s ? bf[j][2] : bf[j][0],
                      s ? bf[j][3] : bf[j][1], MAGIC);
      } else {
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_s8(acc[j], af, s ? bf[j][2] : bf[j][0],
                 s ? bf[j][3] : bf[j][1]);
      }
      kin += 32;
      if (kin < gs) continue;
      // the group's fold, in the plain version's order
      float rf[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r = rs[h];
        r += __shfl_xor_sync(0xffffffffu, r, 1);
        r += __shfl_xor_sync(0xffffffffu, r, 2);
        rf[h] = __int2float_rn(r);
        rs[h] = 0;
      }
      const __half* ss = sz + 2 * s * BN + wn * 32 + 2 * t4;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const float2 sv =
            __half22float2(*reinterpret_cast<const __half2*>(ss + j * 8));
        const float2 zv = __half22float2(
            *reinterpret_cast<const __half2*>(ss + BN + j * 8));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float p = __fadd_rn(__int_as_float(acc[j][q]), -MAGIC_F);
          fs[j][q] = __fadd_rn(fs[j][q], __fmul_rn(p, q & 1 ? sv.y : sv.x));
          fz[j][q] = __fadd_rn(fz[j][q],
                               __fmul_rn(rf[q >> 1], q & 1 ? zv.y : zv.x));
        }
      }
      kin = 0;
    }
  }

  // the folded sums into shared memory (over the ring), then the epilogue,
  // consecutive threads on consecutive columns
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  float* cs = reinterpret_cast<float*>(mm_smem);   // [BM][BN + CPAD]
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 16 + g4 + 8 * h, c = wn * 32 + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(cs + r * (BN + CPAD) + c) =
          make_float2(__fadd_rn(fs[j][2 * h], fz[j][2 * h]),
                      __fadd_rn(fs[j][2 * h + 1], fz[j][2 * h + 1]));
    }
  __syncthreads();
#pragma unroll 1
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN, m = m0 + r, n = n0 + c;
    if (m < M && n < N) store_out(e, cs[r * (BN + CPAD) + c], m, n, N, C);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int CT>
int launch_stream(const int8_t* a, const uint8_t* p, const __half* s,
                  const __half* z, void* C, int M, int N, int K, int gs,
                  int gc, int wb, const Epi& e, cudaStream_t st) {
  constexpr int BN = CW * CT;
  static const cudaError_t attr = cudaFuncSetAttribute(
      stream_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int smem = stream_smem(gc, gs, BN, CT);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + ST_M - 1) / ST_M);
  stream_kernel<CT><<<grid, ST_THREADS, smem, st>>>(a, p, s, z, C, M, N, K,
                                                    gs, gc, wb, e);
  return static_cast<int>(cudaGetLastError());
}

template <bool V16>
int launch_mma(const int8_t* a, const uint8_t* p, const __half* s,
               const __half* z, void* C, int M, int N, int K, int gs, int wa,
               int wb, const Epi& e, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      mma_kernel<V16>, cudaFuncAttributeMaxDynamicSharedMemorySize, MM_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + MM_BM - 1) / MM_BM, (N + MM_BN - 1) / MM_BN);
  mma_kernel<V16><<<grid, MM_THREADS, MM_SMEM, st>>>(a, p, s, z, C, M, N, K,
                                                     gs, wa, wb, e);
  return static_cast<int>(cudaGetLastError());
}

bool width_ok(int w, int extent, const void* p) {
  return (w == 1 || w == 2 || w == 4 || w == 8 || w == 16) &&
         extent % w == 0 && reinterpret_cast<uintptr_t>(p) % w == 0;
}

}  // namespace

// C = epilogue(A[M,K] x unpack(P)[K,N]) with per-group scale / zero, on the
// plan kernels/conv_pe.py::plan_w4 made.  gs: the group size (a multiple of
// 4 up to 1024, K a multiple of it).  route 0 streams (bm = 4; bn = 16 or
// 32 columns a block; chunks of gc groups, gc <= K / gs, whose slots fit in
// shared memory; wb the copy width of P's rows); route 1 runs tensor-core
// tiles (bm x bn = 64 x 64; gs a multiple of 32; wa / wb the copy widths of
// A's and P's rows).  Widths divide the row
// and the pointer's alignment.  Pointers are device pointers (nullptr for an
// absent operand; A 4-byte aligned); the launch goes on `stream`.  Returns
// cudaErrorInvalidValue for a plan it does not take, else
// cudaGetLastError().
extern "C" int conv_pe_w4(const void* A, const void* P, const void* S,
                          const void* Z, void* C, int M, int N, int K, int gs,
                          int route, int bm, int bn, int gc, int wa,
                          int wb, const void* a_scale, float a_scale_val,
                          const void* bias, int act, int out_int8,
                          const void* os_vec, float os_val, const void* res,
                          int res_f32, float res_scale, int has_mid,
                          float mid_scale, int add_act, void* stream) {
  constexpr int bad = static_cast<int>(cudaErrorInvalidValue);
  if (M < 1 || N < 1 || K < 1 || gs < 4 || gs % 4 || gs > 1024 || K % gs ||
      reinterpret_cast<uintptr_t>(A) % 4 || !width_ok(wb, N, P))
    return bad;
  Epi e{static_cast<const float*>(a_scale), a_scale_val,
        static_cast<const float*>(bias), act, out_int8,
        static_cast<const float*>(os_vec), os_val, res, res_f32, res_scale,
        has_mid, mid_scale, add_act};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int8_t*>(A);
  const auto* p = static_cast<const uint8_t*>(P);
  const auto* s = static_cast<const __half*>(S);
  const auto* z = static_cast<const __half*>(Z);
  if (route == 0) {
    if (bm != ST_M || gc < 1 || gc > K / gs) return bad;
    if (bn == 16)
      return launch_stream<1>(a, p, s, z, C, M, N, K, gs, gc, wb, e, st);
    if (bn == 32)
      return launch_stream<2>(a, p, s, z, C, M, N, K, gs, gc, wb, e, st);
    return bad;
  }
  if (route != 1 || bm != MM_BM || bn != MM_BN || gs % 32 || !width_ok(wa, K, A))
    return bad;
  if (wa == 16 && wb == 16)
    return launch_mma<true>(a, p, s, z, C, M, N, K, gs, wa, wb, e, st);
  return launch_mma<false>(a, p, s, z, C, M, N, K, gs, wa, wb, e, st);
}
