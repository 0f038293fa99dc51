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
// What bounds it on the H100: at a prefill of 64 tokens, the launch and the
// f32 FMA pipe (the inputs are a few MB; 2 * L * S * D * Hq FLOPs).  The
// design is the simple one that is right: one block of 256 threads per
// (query tile of 16 rows, head, batch); the Q tile, one 32-key K or V tile
// (K rows padded by one word against bank conflicts) and the tile's scores
// for a whole chunk in shared memory; chunks and tiles past the causal edge
// of the block are skipped (adding their exact zeros would change nothing).
// Tensor-core tiles (wgmma) and TMA loads are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 16;          // query rows per block
constexpr int BK = 32;          // keys per staged K / V tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// floats of dynamic shared memory: Q tile, one K / V tile, the chunk's
// scores, and the running max, sum and rescale factor per row
__host__ __device__ constexpr int smem_floats(int d, int chunk) {
  return BQ * d + BK * (d + 1) + BQ * chunk + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ out, int Hq,
             int Hkv, int L, int S, int chunk, float scale, float softcap,
             float inv_softcap, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [BQ][D]
  float* kv = qs + BQ * D;                // [BK][D + 1]
  float* ps = kv + BK * (D + 1);          // [BQ][chunk]
  float* m_row = ps + BQ * chunk;         // [BQ]
  float* l_row = m_row + BQ;              // [BQ]
  float* a_row = l_row + BQ;              // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qg = q + ((size_t)b * Hq + h) * L * D;
  const T* kg = k + ((size_t)b * Hkv + hk) * S * D;
  const T* vg = v + ((size_t)b * Hkv + hk) * S * D;
  const int shift = S - L;                // end-aligned causal positions
  // the last key any row of this block may see
  const int kmax = causal ? min(S - 1, q0 + BQ - 1 + shift) : S - 1;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    qs[i] = q0 + r < L ? widen(qg[(size_t)(q0 + r) * D + c]) : 0.0f;
  }
  if (tid < BQ) {
    m_row[tid] = NEG_INF;
    l_row[tid] = 0.0f;
  }
  // the PV accumulators: this thread owns column d of RPT rows
  constexpr int GROUPS = THREADS / D;
  constexpr int RPT = BQ / GROUPS;
  const int d_own = tid % D, g_own = tid / D;
  float acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[j] = 0.0f;

  const int nchunks = (S + chunk - 1) / chunk;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int c0 = ci * chunk;
    if (c0 > kmax) break;                 // every later key is masked
    __syncthreads();                      // ps / kv free again
    // -- scores of the chunk: 2 per thread per 32-key tile ---------------
    const int c = tid & 31, r0 = tid >> 5;
    for (int t0 = 0; t0 < chunk; t0 += BK) {
      const int kb = c0 + t0;
      const bool live = kb <= kmax;       // uniform over the block
      if (live) {
        __syncthreads();
        for (int i = tid; i < BK * D; i += THREADS) {
          const int r = i / D, cc = i % D;
          kv[r * (D + 1) + cc] =
              kb + r < S ? widen(kg[(size_t)(kb + r) * D + cc]) : 0.0f;
        }
        __syncthreads();
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + rr * WARPS;
        const int kpos = kb + c, qpos = q0 + r + shift;
        const bool valid = live && kpos < S && (!causal || kpos <= qpos);
        float s = NEG_INF;
        if (valid) {
          const float* qr = qs + r * D;
          const float* kr = kv + c * (D + 1);
          float dot = 0.0f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot = __fmaf_rn(qr[d], kr[d], dot);
          s = __fmul_rn(dot, scale);
          if (softcap > 0.0f)
            s = __fmul_rn(softcap, tanhf(__fmul_rn(s, inv_softcap)));
        }
        ps[r * chunk + t0 + c] = s;
      }
    }
    __syncthreads();
    // -- softmax statistics: one warp per row, rows warp and warp + 8 -----
    for (int r = warp; r < BQ; r += WARPS) {
      float* pr = ps + r * chunk;
      float mx = NEG_INF;
      for (int i = lane; i < chunk; i += 32) mx = fmaxf(mx, pr[i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_row[r];
      const float m_new = fmaxf(m_old, mx);
      // torch's row sum: lane t walks the float4 groups t, t + 32, ...,
      // element u of a group into accumulator u; the four fold in order,
      // then the lanes fold at shuffle-down offsets 16, 8, 4, 2, 1
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = 4 * lane; i < chunk; i += 128) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float p = expf(__fsub_rn(pr[i + u], m_new));
          pr[i + u] = p;
          part[u] = __fadd_rn(part[u], p);
        }
      }
      float sum = __fadd_rn(__fadd_rn(__fadd_rn(part[0], part[1]), part[2]),
                            part[3]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum = __fadd_rn(sum, __shfl_down_sync(0xffffffffu, sum, o));
      if (lane == 0) {
        const float alpha = expf(__fsub_rn(m_old, m_new));
        a_row[r] = alpha;
        l_row[r] = __fadd_rn(__fmul_rn(l_row[r], alpha), sum);
        m_row[r] = m_new;
      }
    }
    // -- p @ v over the chunk's live tiles, then acc = acc * alpha + pv ---
    float pv[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) pv[j] = 0.0f;
    for (int t0 = 0; t0 < chunk && c0 + t0 <= kmax; t0 += BK) {
      const int kb = c0 + t0;
      __syncthreads();
      for (int i = tid; i < BK * D; i += THREADS) {
        const int r = i / D, cc = i % D;
        kv[r * (D + 1) + cc] =
            kb + r < S ? widen(vg[(size_t)(kb + r) * D + cc]) : 0.0f;
      }
      __syncthreads();
      const int nk = min(BK, min(S, kmax + 1) - kb);
      for (int kk = 0; kk < nk; ++kk) {
        const float vv = kv[kk * (D + 1) + d_own];
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          pv[j] = __fmaf_rn(ps[(g_own + j * GROUPS) * chunk + t0 + kk], vv,
                            pv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      acc[j] = __fadd_rn(__fmul_rn(acc[j], a_row[g_own + j * GROUPS]), pv[j]);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = g_own + j * GROUPS;
    if (q0 + r < L) {
      const float l = l_row[r];
      out[(((size_t)b * Hq + h) * L + q0 + r) * D + d_own] =
          __fdiv_rn(acc[j], l == 0.0f ? 1.0f : l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int L, int S, int chunk, float scale,
           float softcap, float inv_softcap, int causal,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(D, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + BQ - 1) / BQ, Hq, B);
  flash_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out), Hq, Hkv, L, S,
      chunk, scale, softcap, inv_softcap, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* out,
             int B, int Hq, int Hkv, int L, int S, int chunk, float scale,
             float softcap, float inv_softcap, int causal,
             cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, Hq, Hkv, L, S, chunk,
                                  scale, softcap, inv_softcap, causal, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, Hq, Hkv, L, S, chunk,
                                    scale, softcap, inv_softcap, causal,
                                    stream);
    case 256: return launch<T, 256>(q, k, v, out, B, Hq, Hkv, L, S, chunk,
                                    scale, softcap, inv_softcap, causal,
                                    stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out [B, Hq, L, D] f32 <- q [B, Hq, L, D], k / v [B, Hkv, S, D], all
// contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1); Hq a multiple of Hkv;
// chunk a multiple of 128 (the keys per softmax chunk); softcap 0 = off,
// inv_softcap its f32 reciprocal.  The launch goes on `stream`.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported D or chunk).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Hq, int Hkv, int L,
                               int S, int D, int chunk, int bf16, float scale,
                               float softcap, float inv_softcap, int causal,
                               void* stream) {
  if (chunk <= 0 || chunk % 128 || Hkv <= 0 || Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(D, q, k, v, out, B, Hq, Hkv, L, S, chunk,
                                   scale, softcap, inv_softcap, causal, st);
  return dispatch<float>(D, q, k, v, out, B, Hq, Hkv, L, S, chunk, scale,
                         softcap, inv_softcap, causal, st);
}
