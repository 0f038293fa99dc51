// Flash attention (prefill) on Hopper: online-softmax attention over
// q [B, Hq, L, D] and k / v [B, Hkv, S, D], GQA by head index.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attn.py::
// flash_attention (_kernel :29, pallas_call :84)      -> flash_kernel
//
// What it computes is _kernel's function: s = (q . k) * scale, the logit
// softcap `softcap * tanh(s / softcap)` when softcap > 0, the end-aligned
// causal mask kpos <= qpos + (S - L) (and kpos < S), -1e30 in every masked
// entry, the running max / sum / accumulator in f32 over KV chunks, and a
// row whose sum is 0 divided by 1.  q, k, v are f32 or bf16 (widened to
// f32 on load); the output is f32.  head_dim D is 32, 128 or 256.
//
// Numerics.  The compiled prefill's ref backend runs the same attention
// as plain torch (models/layers.py::flash_attention): one softmax per KV
// chunk of min(1024, round_up(S, 128)) keys, padded keys masked, then
// `l * alpha + sum(p)` and `acc * alpha + p @ v`.  Its output is quantized
// to int8 right after, so an ulp can move a code, and a code can move a
// served token.  This kernel therefore keeps that op sequence on the same
// chunks: each dot product is one fused multiply-add chain in index order
// from 0 (the order of cuBLAS's f32 GEMM at these shapes), the row sum takes
// the order of torch's CUDA sum over a contiguous row (one warp, four
// accumulators per lane over float4 groups, then a shuffle-down tree from
// offset 16), exp / tanh are the full-precision expf / tanhf (bitwise
// torch's exp / tanh), the division is IEEE, and `x / softcap` multiplies
// by the f32 reciprocal as torch's CUDA division by a scalar does.  Every
// other operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, ...), so no build flag can contract it.  Those orders were
// read off torch 2.11 / CUDA 12.8 on the H100; where another torch sums
// otherwise, the kernel still agrees with its plain version to f32
// rounding, which is its contract.
//
// What bounds it on the H100: the f32 FMA pipe (4 * pairs * D flops at 67
// TFLOP/s, pairs the visible (query, key) pairs; the inputs are a few MB),
// and at a served prefill of 64 tokens the latency of a block's short
// chain of loads and products.  Tensor-core tiles would change the sums
// above, so the kernel stays on the FMA pipe and feeds it from shared
// memory, whose 128 bytes a clock per SM (a 16-byte load costs its 16
// bytes for each thread) bound it before the FMAs do:
//   * Rows.  A block holds R rows of one KV group: flat row f = pos * G + g
//     of the group's G query heads, so one staged K / V slab serves every
//     head of the group, and a block's rows span few positions (its causal
//     limit stays tight).  The wrapper's planner (kernels/flash_attn.py::
//     plan) picks the block, R rows at NT threads (32 / 256, 16 / 128 or
//     8 / 64): the most rows whose grid still fills 7/8 of the SMs (K / V
//     reused across more rows at long L), within shared memory.
//   * Register micro-tiles.  For the scores a thread owns RM rows x 4 keys
//     (RM = 4 at 32 rows, else 2) and steps d in order for all of them at
//     once: per 4 d it loads RM Q and 4 K float4s from shared memory and
//     issues 16 RM FMAs (2 to 3 bytes of shared memory an FMA).  For p @ v
//     a thread owns RMV rows x GV float4 column groups and steps the
//     chunk's keys in order: per 4 keys RMV float4s of p and 4 GV of v for
//     16 RMV GV FMAs.  Every chain keeps its order, so the result is the
//     same bits.  A warp covers 8 keys (or column groups) x 4 rows, so
//     the 8 threads of a quarter warp load 8 distinct 16-byte words, one
//     to a bank group.
//   * A ring of K / V slabs.  K is staged as [BK keys][DK dims] slabs (BK
//     the score tile, 128 or 64 keys; d in order over a tile's slabs), V
//     as [4096 / D keys][D] slabs, by 16-byte cp.async into STAGES slots,
//     so the next slab loads while the current one is multiplied (and the
//     first V slabs during the softmax statistics, the first K slabs
//     during the Q tile's load); keys past S or past the block's causal
//     limit are zero-filled, not read, and key groups of a tile past it
//     are skipped.  bf16 stays bf16 in the ring and is widened from shared
//     memory to registers.
//   * Per chunk the scores of every live tile land in shared memory (R x
//     chunk f32); one warp a row takes the max, the exps and the sum in
//     torch's order; the chunk's p @ v follows.  Chunks and keys past the
//     block's causal limit are skipped (their exact zeros change nothing).
#include <cstdint>
#include <initializer_list>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_s8.cuh"

namespace {

using repro::cp_async;

constexpr int STAGES = 3;          // slots of the K / V ring
constexpr int SMEM_MAX = 232448;   // a block's shared memory on the H100
constexpr float NEG_INF = -1e30f;

// The block of R rows at NT threads: scores on TXS key lanes x NT / TXS
// row lanes, 4 keys a thread, so a score tile is BK = 4 TXS keys; K slabs
// of DK dims, V slabs of BV keys.
__host__ __device__ constexpr int txs_of(int nt) { return nt >= 256 ? 32 : 16; }
__host__ __device__ constexpr int bk_of(int nt) { return 4 * txs_of(nt); }
__host__ __device__ constexpr int dk_of(int d, int nt) {
  return d < 4096 / bk_of(nt) ? d : 4096 / bk_of(nt);
}
__host__ __device__ constexpr int bv_of(int d) {
  return d > 64 ? 4096 / d : 64;
}
// floats of a ring slot: an f32 K or V slab with its rows padded by 16
// bytes (a bf16 slab takes at most as many bytes)
__host__ __device__ constexpr int slot_floats(int d, int nt) {
  return bk_of(nt) * (dk_of(d, nt) + 4) > bv_of(d) * (d + 4)
             ? bk_of(nt) * (dk_of(d, nt) + 4)
             : bv_of(d) * (d + 4);
}
// floats of dynamic shared memory: the ring, the Q tile [R][D + 4], the
// chunk's scores [R][chunk + 8], and the running max, sum and rescale per
// row (kernels/flash_attn.py::flash_smem computes the same)
__host__ __device__ constexpr int smem_floats(int d, int r, int nt,
                                              int chunk) {
  return STAGES * slot_floats(d, nt) + r * (d + 4) + r * (chunk + 8) + 3 * r;
}
// the thread layouts take R rows at NT threads and head dim D: whole row
// passes for the scores and for p @ v (TXV = min(TXS, D / 4) lanes)
__host__ __device__ constexpr bool tile_ok(int d, int r, int nt) {
  return nt % 64 == 0 && r % (nt / txs_of(nt)) == 0 &&
         r % (nt / (d / 4 < txs_of(nt) ? d / 4 : txs_of(nt))) == 0;
}

// four elements as f32: from global memory (q) or from a slab
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// four elements of q as f32, by a global-memory load the compiler may
// hoist past shared-memory stores (a generic load may alias them)
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float comp(const float4& a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

// acc += p * v on four columns
__device__ __forceinline__ void fma4(float4& acc, float p, const float4& v) {
  acc.x = __fmaf_rn(p, v.x, acc.x);
  acc.y = __fmaf_rn(p, v.y, acc.y);
  acc.z = __fmaf_rn(p, v.z, acc.z);
  acc.w = __fmaf_rn(p, v.w, acc.w);
}

// The block's slab jobs: chunk by chunk, the K slabs of its live score
// tiles (KS a tile, d in order), then its live V slabs, each over the
// chunk's keys through kmax.  Every chunk but the last is whole, so job j
// belongs to chunk min(j / full, nch - 1).
template <typename T, int D, int NT>
struct Ring {
  static constexpr int EPC = 16 / sizeof(T);     // elements a 16-byte copy
  static constexpr int BK = bk_of(NT), DK = dk_of(D, NT), BV = bv_of(D);
  static constexpr int KS = D / DK, KROW = DK + EPC, VROW = D + EPC;
  static constexpr int SLOT = slot_floats(D, NT) * 4 / sizeof(T);
  T* slots;
  const T* kg;
  const T* vg;
  int tid, chunk, kmax, nch, full, jobs;

  __device__ int live(int c) const { return min(chunk, kmax + 1 - c * chunk); }
  __device__ int njobs(int c) const {
    const int n = live(c);
    return (n + BK - 1) / BK * KS + (n + BV - 1) / BV;
  }
  __device__ Ring(T* slots_, const T* kg_, const T* vg_, int tid_,
                  int chunk_, int kmax_)
      : slots(slots_), kg(kg_), vg(vg_), tid(tid_), chunk(chunk_),
        kmax(kmax_), nch(kmax_ / chunk_ + 1) {
    full = njobs(0);
    jobs = (nch - 1) * full + njobs(nch - 1);
  }
  // cp.async of job j into its slot, then a commit (empty past the last)
  __device__ void issue(int j) const {
    if (j < jobs) {
      const int c = min(j / full, nch - 1), jj = j - c * full;
      const int c0 = c * chunk, lim = c0 + live(c);
      const int nk = (live(c) + BK - 1) / BK * KS;
      T* slot = slots + (j % STAGES) * SLOT;
      if (jj < nk) {
        const int kb = c0 + jj / KS * BK, d0 = jj % KS * DK;
        constexpr int CPR = DK / EPC;
        for (int i = tid; i < BK * CPR; i += NT) {
          const int r = i / CPR, cc = i % CPR * EPC;
          const bool ok = kb + r < lim;
          cp_async<16>(slot + r * KROW + cc,
                       ok ? kg + (size_t)(kb + r) * D + d0 + cc : kg, ok);
        }
      } else {
        const int vb = c0 + (jj - nk) * BV;
        constexpr int CPR = D / EPC;
        for (int i = tid; i < BV * CPR; i += NT) {
          const int r = i / CPR, cc = i % CPR * EPC;
          const bool ok = vb + r < lim;
          cp_async<16>(slot + r * VROW + cc,
                       ok ? vg + (size_t)(vb + r) * D + cc : vg, ok);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // job jc's slab, once every thread's copies landed and every thread left
  // job jc - 1, whose slot then takes job jn = jc + STAGES - 1
  __device__ __forceinline__ const T* next(int& jn, int& jc) const {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2));
    __syncthreads();
    issue(jn++);
    return slots + (jc++ % STAGES) * SLOT;
  }
};

template <typename T, int D, int R, int NT>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ out, int Hq,
             int Hkv, int L, int S, int chunk, float scale, float softcap,
             float inv_softcap, int causal) {
  using RingT = Ring<T, D, NT>;
  constexpr int BK = RingT::BK, DK = RingT::DK, BV = RingT::BV;
  constexpr int KS = RingT::KS, KROW = RingT::KROW, VROW = RingT::VROW;
  constexpr int QROW = D + 4, NW = NT / 32;
  // scores: TYS x TXS threads, a thread RM rows (sy + TYS i) x 4 keys
  // (sx + TXS j); p @ v: TYV x TXV threads, a thread RMV rows (vy + TYV i)
  // x GV float4 column groups (vx + TXV j); a warp 4 rows x 8 lanes
  constexpr int TXS = txs_of(NT), TYS = NT / TXS, RM = R / TYS;
  constexpr int TXV = D / 4 < TXS ? D / 4 : TXS, TYV = NT / TXV;
  constexpr int RMV = R / TYV, GV = D / 4 / TXV;
  constexpr int WXS = TXS / 8, WXV = TXV / 8;
  // the softmax statistics: a warp RPW rows (warp + NW w), side by side;
  // the Q tile: QPT float4s a thread
  constexpr int RPW = R / NW, QPT = R * D / 4 / NT;
  static_assert(tile_ok(D, R, NT) && GV * TXV * 4 == D && BK == 4 * TXS &&
                    RPW * NW == R && QPT * NT * 4 == R * D,
                "thread layout");

  extern __shared__ __align__(16) float smem[];
  float* qs = smem + STAGES * slot_floats(D, NT);   // [R][QROW]
  float* ps = qs + R * QROW;                        // [R][prow]
  const int prow = chunk + 8;
  float* m_row = ps + R * prow;
  float* l_row = m_row + R;
  float* a_row = l_row + R;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sx = (lane & 7) + 8 * (warp % WXS);
  const int sy = (lane >> 3) + 4 * (warp / WXS);
  const int vx = (lane & 7) + 8 * (warp % WXV);
  const int vy = (lane >> 3) + 4 * (warp / WXV);
  // row tiles in reverse, so the blocks with the most keys (the last
  // positions) start first and the lightest fill the tail
  const int G = Hq / Hkv, f0 = (gridDim.x - 1 - blockIdx.x) * R;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int shift = S - L;                // end-aligned causal positions
  const int rows = min(R, G * L - f0);    // real rows of this block
  // the last key any row of this block may see
  const int kmax =
      causal ? min(S - 1, (f0 + rows - 1) / G + shift) : S - 1;
  const RingT ring(reinterpret_cast<T*>(smem),
                   k + ((size_t)b * Hkv + hk) * S * D,
                   v + ((size_t)b * Hkv + hk) * S * D, tid, chunk, kmax);
  int jn = 0, jc = 0;                     // next job to issue, to compute
  for (int i = 0; i < STAGES - 1; ++i) ring.issue(jn++);

  // the Q tile: every load in flight before the first store
  float4 qx[QPT];
#pragma unroll
  for (int n = 0; n < QPT; ++n) {
    const int i = tid + n * NT, r = i / (D / 4), c4 = i % (D / 4);
    qx[n] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      const int f = f0 + r, h = hk * G + f % G;
      qx[n] = ldg4(q + (((size_t)b * Hq + h) * L + f / G) * D + 4 * c4);
    }
  }
#pragma unroll
  for (int n = 0; n < QPT; ++n) {
    const int i = tid + n * NT;
    *reinterpret_cast<float4*>(qs + i / (D / 4) * QROW + 4 * (i % (D / 4))) =
        qx[n];
  }
  for (int r = tid; r < R; r += NT) {
    m_row[r] = NEG_INF;
    l_row[r] = 0.0f;
  }

  float4 acc[RMV][GV];
#pragma unroll
  for (int i = 0; i < RMV; ++i)
#pragma unroll
    for (int j = 0; j < GV; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int c = 0; c < ring.nch; ++c) {
    const int c0 = c * chunk, live = ring.live(c);
    const int ntile = (live + BK - 1) / BK;
    // -- scores of the chunk's live tiles --------------------------------
    for (int t = 0; t < ntile; ++t) {
      const int klive = live - t * BK;    // live keys of this tile
      float sc[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
      for (int ks = 0; ks < KS; ++ks) {
        const T* slab = ring.next(jn, jc);
        const float* qb = qs + sy * QROW + ks * DK;
        const T* kr = slab + sx * KROW;
#pragma unroll 2
        for (int dd = 0; dd < DK; dd += 4) {
          float4 qv[RM], kv[4];
#pragma unroll
          for (int i = 0; i < RM; ++i) qv[i] = ld4(qb + i * TYS * QROW + dd);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j * TXS < klive) kv[j] = ld4(kr + j * TXS * KROW + dd);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j * TXS < klive)
#pragma unroll
                for (int i = 0; i < RM; ++i)
                  sc[i][j] = __fmaf_rn(comp(qv[i], u), comp(kv[j], u),
                                       sc[i][j]);
        }
      }
      const int kb = c0 + t * BK;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = sy + i * TYS, qpos = (f0 + r) / G + shift;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = kb + sx + TXS * j;
          float s = NEG_INF;
          if (kpos < S && (!causal || kpos <= qpos)) {
            s = __fmul_rn(sc[i][j], scale);
            if (softcap > 0.0f)
              s = __fmul_rn(softcap, tanhf(__fmul_rn(s, inv_softcap)));
          }
          ps[r * prow + t * BK + sx + TXS * j] = s;
        }
      }
    }
    __syncthreads();
    // -- softmax statistics: one warp a row, RPW rows side by side ---------
    {
      const int nl = ntile * BK;          // entries past it are p = 0
      float* pr[RPW];
      float mx[RPW], m_new[RPW], part[RPW][4];
#pragma unroll
      for (int w = 0; w < RPW; ++w) {
        pr[w] = ps + (warp + w * NW) * prow;
        mx[w] = NEG_INF;
      }
      for (int i = lane; i < nl; i += 32)
#pragma unroll
        for (int w = 0; w < RPW; ++w) mx[w] = fmaxf(mx[w], pr[w][i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int w = 0; w < RPW; ++w)
          mx[w] = fmaxf(mx[w], __shfl_xor_sync(0xffffffffu, mx[w], o));
      // torch's row sum: lane t walks the float4 groups t, t + 32, ...,
      // element u of a group into accumulator u; the four fold in order,
      // then the lanes fold at shuffle-down offsets 16, 8, 4, 2, 1 (the
      // zeros past nl would add nothing)
#pragma unroll
      for (int w = 0; w < RPW; ++w) {
        m_new[w] = fmaxf(m_row[warp + w * NW], mx[w]);
#pragma unroll
        for (int u = 0; u < 4; ++u) part[w][u] = 0.0f;
      }
      for (int i = 4 * lane; i < nl; i += 128)
#pragma unroll
        for (int w = 0; w < RPW; ++w)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float p = expf(__fsub_rn(pr[w][i + u], m_new[w]));
            pr[w][i + u] = p;
            part[w][u] = __fadd_rn(part[w][u], p);
          }
      float sum[RPW];
#pragma unroll
      for (int w = 0; w < RPW; ++w)
        sum[w] = __fadd_rn(__fadd_rn(__fadd_rn(part[w][0], part[w][1]),
                                     part[w][2]), part[w][3]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int w = 0; w < RPW; ++w)
          sum[w] = __fadd_rn(sum[w], __shfl_down_sync(0xffffffffu, sum[w], o));
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < RPW; ++w) {
          const int r = warp + w * NW;
          const float alpha = expf(__fsub_rn(m_row[r], m_new[w]));
          a_row[r] = alpha;
          l_row[r] = __fadd_rn(__fmul_rn(l_row[r], alpha), sum[w]);
          m_row[r] = m_new[w];
        }
      }
    }
    __syncthreads();
    // -- p @ v over the chunk's live keys, then acc = acc * alpha + pv -----
    float4 pv[RMV][GV];
#pragma unroll
    for (int i = 0; i < RMV; ++i)
#pragma unroll
      for (int j = 0; j < GV; ++j) pv[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int nv = (live + BV - 1) / BV;
    for (int vs = 0; vs < nv; ++vs) {
      const T* slab = ring.next(jn, jc);
      const float* pb = ps + vy * prow + vs * BV;
      const T* vr = slab + 4 * vx;
      const int vlive = min(BV, live - vs * BV);   // keys past it: p = 0
#pragma unroll 2
      for (int kk = 0; kk < vlive; kk += 4) {
        float4 pp[RMV];
#pragma unroll
        for (int i = 0; i < RMV; ++i) pp[i] = ld4(pb + i * TYV * prow + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float4 vv[GV];
#pragma unroll
          for (int j = 0; j < GV; ++j)
            vv[j] = ld4(vr + (kk + u) * VROW + 4 * TXV * j);
#pragma unroll
          for (int i = 0; i < RMV; ++i)
#pragma unroll
            for (int j = 0; j < GV; ++j) fma4(pv[i][j], comp(pp[i], u), vv[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RMV; ++i) {
      const float alpha = a_row[vy + i * TYV];
#pragma unroll
      for (int j = 0; j < GV; ++j) {
        float4& a = acc[i][j];
        const float4& p = pv[i][j];
        a.x = __fadd_rn(__fmul_rn(a.x, alpha), p.x);
        a.y = __fadd_rn(__fmul_rn(a.y, alpha), p.y);
        a.z = __fadd_rn(__fmul_rn(a.z, alpha), p.z);
        a.w = __fadd_rn(__fmul_rn(a.w, alpha), p.w);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
#pragma unroll
  for (int i = 0; i < RMV; ++i) {
    const int r = vy + i * TYV;
    if (r < rows) {
      const float l = l_row[r], den = l == 0.0f ? 1.0f : l;
      const int f = f0 + r, h = hk * G + f % G;
      float* o = out + (((size_t)b * Hq + h) * L + f / G) * D + 4 * vx;
#pragma unroll
      for (int j = 0; j < GV; ++j) {
        const float4& a = acc[i][j];
        *reinterpret_cast<float4*>(o + 4 * TXV * j) =
            make_float4(__fdiv_rn(a.x, den), __fdiv_rn(a.y, den),
                        __fdiv_rn(a.z, den), __fdiv_rn(a.w, den));
      }
    }
  }
}

template <typename T, int D, int R, int NT>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int L, int S, int chunk, int smem, float scale,
           float softcap, float inv_softcap, int causal,
           cudaStream_t stream) {
  if constexpr (!tile_ok(D, R, NT)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_kernel<T, D, R, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const size_t bytes = sizeof(float) * smem_floats(D, R, NT, chunk);
    if (bytes != static_cast<size_t>(smem) || bytes > SMEM_MAX ||
        chunk % bk_of(NT))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((Hq / Hkv * L + R - 1) / R, Hkv, B);
    flash_kernel<T, D, R, NT><<<grid, NT, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<float*>(out), Hq, Hkv, L, S,
        chunk, scale, softcap, inv_softcap, causal);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int D>
int dispatch_rows(int rows, int threads, const void* q, const void* k,
                  const void* v, void* out, int B, int Hq, int Hkv, int L,
                  int S, int chunk, int smem, float scale, float softcap,
                  float inv_softcap, int causal, cudaStream_t st) {
  if (rows == 8 && threads == 64)
    return launch<T, D, 8, 64>(q, k, v, out, B, Hq, Hkv, L, S, chunk, smem,
                               scale, softcap, inv_softcap, causal, st);
  if (rows == 16 && threads == 128)
    return launch<T, D, 16, 128>(q, k, v, out, B, Hq, Hkv, L, S, chunk, smem,
                                 scale, softcap, inv_softcap, causal, st);
  if (rows == 32 && threads == 256)
    return launch<T, D, 32, 256>(q, k, v, out, B, Hq, Hkv, L, S, chunk, smem,
                                 scale, softcap, inv_softcap, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
template <typename T>
int dispatch(int D, int rows, int threads, const void* q, const void* k,
             const void* v, void* out, int B, int Hq, int Hkv, int L, int S,
             int chunk, int smem, float scale, float softcap,
             float inv_softcap, int causal, cudaStream_t st) {
  switch (D) {
    case 32: return dispatch_rows<T, 32>(rows, threads, q, k, v, out, B, Hq,
                                         Hkv, L, S, chunk, smem, scale,
                                         softcap, inv_softcap, causal, st);
    case 128: return dispatch_rows<T, 128>(rows, threads, q, k, v, out, B,
                                           Hq, Hkv, L, S, chunk, smem, scale,
                                           softcap, inv_softcap, causal, st);
    case 256: return dispatch_rows<T, 256>(rows, threads, q, k, v, out, B,
                                           Hq, Hkv, L, S, chunk, smem, scale,
                                           softcap, inv_softcap, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out [B, Hq, L, D] f32 <- q [B, Hq, L, D], k / v [B, Hkv, S, D], all
// contiguous and 16-byte aligned, f32 (bf16 = 0) or bf16 (bf16 = 1); Hq a
// multiple of Hkv; chunk a multiple of 128 (the keys per softmax chunk);
// rows / threads / smem the planner's block (kernels/flash_attn.py::plan:
// rows 8 at 64 threads, 16 at 128, 32 at 256, and the dynamic shared
// memory it computes, which must equal the kernel's); softcap 0 = off,
// inv_softcap its f32 reciprocal.  The launch goes on `stream`.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported D, block or
// chunk, or a shared-memory count that differs).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Hq, int Hkv, int L,
                               int S, int D, int chunk, int rows, int threads,
                               int smem, int bf16, float scale, float softcap,
                               float inv_softcap, int causal, void* stream) {
  if (chunk <= 0 || chunk % 128 || Hkv <= 0 || Hq % Hkv || L <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(D, rows, threads, q, k, v, out, B, Hq, Hkv,
                                   L, S, chunk, smem, scale, softcap,
                                   inv_softcap, causal, st);
  return dispatch<float>(D, rows, threads, q, k, v, out, B, Hq, Hkv, L, S,
                         chunk, smem, scale, softcap, inv_softcap, causal, st);
}
