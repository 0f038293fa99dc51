// Low-Channel Conv Unit on Hopper: the first-layer conv with a small input
// channel count (3 for RGB) as an implicit GEMM on the int8 tensor cores,
// then per-OC dequant, bias, act and requant; with or without a fused
// max-pool tail.
//
// Replaces the Pallas TPU kernel src/repro/kernels/low_channel.py::
// low_channel_conv, _kernel (:33), with and without its max-pool tail.
//
// The GEMM: M = conv positions, N = output channels, K = k*k*IC in (kh, kw,
// c) order, zero-padded to a multiple of 32 (147 -> 160 at 7x7x3, 27 -> 32
// at 3x3x3, 108 -> 128 at 6x6x3).  What bounds it on the H100: the unit moves
// few bytes (a 229x229x3 int8 image in, 55x55x64 pooled codes out for
// ResNet50) and does 0.1-0.5 G multiply-adds a wave, microseconds at the
// int8 tensor-core rate; what costs is latency: the gather of the k x k
// window of every position (K is too shallow to hide it behind products)
// and the epilogue's IEEE division, once per conv output.  The design, one
// block of 8 warps per tile of positions and up to 64 output channels:
//   * the block stages its input window once -- each input row's span with
//     coalesced 16-byte loads, kept at its own byte offset (rowoff) -- and
//     the filter once, K-major (bt[n][k]), zero past K and past OC;
//   * each warp takes 16 positions at a time (an m16 tile) and builds their
//     im2col rows in its own slice of shared memory: for a fixed kh, a
//     position's k*IC bytes are one contiguous run of its window row, so a
//     4-byte word of the row is one unaligned read (two aligned words and a
//     funnel shift) or, where it crosses into the next kh's run or into the
//     K padding, two merged with __byte_perm (quad_of tabulates which);
//   * ldmatrix.x4 loads the fragments and mma.sync.m16n8k32 s8 x s8 -> s32
//     (mma_s8.cuh, shared with the Conv PE) sums the whole K in registers;
//   * the int32 sums go through epilogue.cuh's dequant_bias_act / qdq_code
//     in the reference's order (built with --fmad=false): integer sums are
//     exact, so the outputs equal the plain version bit for bit.
// Rows of im2col and of the filter are K + 16 bytes apart (an odd number of
// 16-byte units), so the eight row addresses of an ldmatrix matrix fall in
// eight distinct bank groups.
//
// Without a pool tail a block owns BP consecutive positions of one image
// (row-major; its window is the full-width input rows under them), and a
// warp stages its 16 x OCB outputs and writes them as one contiguous run
// (16-byte stores where aligned).  With the max tail (ResNet's 7x7/2 conv
// -> 3x3/2 max pool) a block owns a tile of th x tw pooled outputs: the conv
// outputs under it, halo included, are computed once each into shared
// memory -- int8 codes at the pre-pool edge scale in a static chain (a
// quarter of the f32 tile), f32 in a dynamic one -- and each window's max is
// taken from there.  Only the pooled map is written.  The planner
// (kernels/low_channel.py::plan) picks BP, the pooled tile and OCB; the
// shared memory is layout_of's count for them (the launcher refuses a plan
// past the H100's 227 KB).
#include "epilogue.cuh"
#include "mma_s8.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MAX_KSTEPS = 8;        // K <= 256: k*k*IC of any zoo stem
constexpr int MAX_OCB = 64;          // output channels a block
constexpr int SMEM_MAX = 232448;     // 227 KB, the H100's per-block limit

struct Stem {
  const int8_t* x;          // [N, Hp, Wp, IC], pre-padded (VALID conv)
  const int8_t* w;          // [k, k, IC, OC] = [K, OC]
  const float* bias;        // [OC] or nullptr
  const float* w_scale;     // [OC]
  float a_scale;
  void* out;
  int hp, wp, ic, oc, k, stride, ho, wo, act;
  int out_int8;             // int8 codes at `os` (no tail: out_scale; max
  float os;                 // tail: the static chain's mid_scale), else f32
  int pk, ps, pho, pwo;     // max tail (pk == 0: none)
  int tile_h, tile_w;       // max tail: pooled tile; none: tile_w = BP
  int ocb;                  // channels a block, a multiple of 8
};

__host__ __device__ inline int up16(int v) { return (v + 15) & ~15; }

// Shared-memory layout (byte offsets; every region 16-byte aligned).
struct Layout {
  int as;       // im2col / filter row stride: K padded + 16
  int wh, rs;   // window rows (the most any block needs), row stride
  int qtab, scale, bias, rowoff, rinfo, bt, col, win, out, total;
};

__host__ __device__ inline Layout layout_of(const Stem& a, int ks) {
  Layout L;
  L.as = 32 * ks + 16;
  int span, npos;
  if (a.pk > 0) {
    const int ch = (a.tile_h - 1) * a.ps + a.pk;
    const int cw = (a.tile_w - 1) * a.ps + a.pk;
    L.wh = (ch - 1) * a.stride + a.k;
    span = ((cw - 1) * a.stride + a.k) * a.ic;
    npos = ch * cw;
  } else {
    int rows = (a.tile_w + a.wo - 2) / a.wo + 1;
    rows = rows < a.ho ? rows : a.ho;
    L.wh = (rows - 1) * a.stride + a.k;
    span = a.wp * a.ic;
    npos = a.tile_w;
  }
  // a row's 16-byte chunks start up to 15 bytes early and end up to 15
  // late; the funnel reads run up to 7 bytes past a row's last byte
  L.rs = up16(span + 30);
  const int es = a.out_int8 ? 1 : 4;
  int off = 0;
  L.qtab = off;   off += 8 * ks * 16;
  L.scale = off;  off += up16(a.ocb * 4);
  L.bias = off;   off += up16(a.ocb * 4);
  L.rowoff = off; off += up16(L.wh * 4);
  L.rinfo = off;  off += WARPS * 16 * 8;
  L.bt = off;     off += up16(a.ocb) * L.as;
  L.col = off;    off += WARPS * 16 * L.as;
  L.win = off;    off += L.wh * L.rs;
  L.out = off;    off += up16((a.pk > 0 ? npos : WARPS * 16) * a.ocb * es);
  L.total = off;
  return L;
}

// Where the 4 bytes 4q..4q+3 of an im2col row come from.  K runs kh-major
// in runs of seg = k*IC bytes; run kh of position (pr, pc) is bytes
// pc*s*IC .. + seg of window row pr*s + kh.  {kh, byte in the run, next
// source, j0}: the next source is -2 when the word lies in one run, the
// next run's kh when bytes j0..3 cross into it, -1 when they are K padding
// (zeros); kh = -1 marks a word of padding only.  seg >= 3, so a word
// crosses at most one run boundary.
__device__ __forceinline__ int4 quad_of(int q, int seg, int K) {
  const int kk = 4 * q;
  if (kk >= K) return make_int4(-1, 0, 0, 0);
  const int kh = kk / seg, end = (kh + 1) * seg;
  if (end >= kk + 4) return make_int4(kh, kk - kh * seg, -2, 0);
  return make_int4(kh, kk - kh * seg, end >= K ? -1 : kh + 1, end - kk);
}

// The 4 bytes at byte address `at` of the window (any alignment).
__device__ __forceinline__ unsigned window_word(const unsigned char* win,
                                                int at) {
  const unsigned* w = reinterpret_cast<const unsigned*>(win + (at & ~3));
  return __funnelshift_r(w[0], w[1], (at & 3) * 8);
}

// A warp's nrows staged rows [nrows, ocv] (element size es) to positions
// first.. of out [.., oc]: one contiguous run when the block has every
// channel, else element by element.
__device__ __forceinline__ void store_rows(void* out,
                                           const unsigned char* st,
                                           size_t first, int nrows, int ocv,
                                           int oc, int oc0, int es,
                                           int lane) {
  unsigned char* o = static_cast<unsigned char*>(out);
  if (ocv == oc) {
    unsigned char* d = o + first * oc * es;
    const int n = nrows * oc * es;
    if ((reinterpret_cast<uintptr_t>(d) & 15) == 0 && n % 16 == 0) {
      for (int i = lane; i < n / 16; i += 32)
        reinterpret_cast<uint4*>(d)[i] =
            reinterpret_cast<const uint4*>(st)[i];
    } else if ((reinterpret_cast<uintptr_t>(d) & 3) == 0 && n % 4 == 0) {
      for (int i = lane; i < n / 4; i += 32)
        reinterpret_cast<unsigned*>(d)[i] =
            reinterpret_cast<const unsigned*>(st)[i];
    } else {
      for (int i = lane; i < n; i += 32) d[i] = st[i];
    }
    return;
  }
  for (int i = lane; i < nrows * ocv; i += 32) {
    const size_t idx = (first + i / ocv) * oc + oc0 + i % ocv;
    if (es == 1)
      o[idx] = st[i];
    else
      reinterpret_cast<float*>(o)[idx] = reinterpret_cast<const float*>(st)[i];
  }
}

// grid: (position tiles (none) or pooled tiles (max), ceil(OC / ocb), N).
// KS: K / 32 steps (K padded); MAX: the max-pool tail.
template <int KS, bool MAX>
__global__ void __launch_bounds__(THREADS)
stem_kernel(const Stem a) {
  constexpr int KQ = 8 * KS;                 // 4-byte words an im2col row
  extern __shared__ __align__(16) unsigned char sm[];
  const Layout L = layout_of(a, KS);
  int4* qtab = reinterpret_cast<int4*>(sm + L.qtab);
  float* sc = reinterpret_cast<float*>(sm + L.scale);
  float* bs = reinterpret_cast<float*>(sm + L.bias);
  int* rowoff = reinterpret_cast<int*>(sm + L.rowoff);
  int8_t* bt = reinterpret_cast<int8_t*>(sm + L.bt);
  unsigned char* win = sm + L.win;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, oc0 = blockIdx.y * a.ocb;
  const int ocv = min(a.ocb, a.oc - oc0);     // the block's real channels
  const int s = a.stride, ic = a.ic;
  const int K = a.k * a.k * ic;
  // the block's positions, and its window's origin and extent in the image
  int npos, row0, col0, wh, span, cw = 0, th = 0, tw = 0, ph0 = 0, pw0 = 0;
  int p0 = 0, rfirst = 0;
  if (MAX) {
    const int tiles_w = (a.pwo + a.tile_w - 1) / a.tile_w;
    ph0 = blockIdx.x / tiles_w * a.tile_h;
    pw0 = blockIdx.x % tiles_w * a.tile_w;
    th = min(a.tile_h, a.pho - ph0);
    tw = min(a.tile_w, a.pwo - pw0);
    const int ch = (th - 1) * a.ps + a.pk;
    cw = (tw - 1) * a.ps + a.pk;
    npos = ch * cw;
    row0 = ph0 * a.ps * s;
    col0 = pw0 * a.ps * s;
    wh = (ch - 1) * s + a.k;
    span = ((cw - 1) * s + a.k) * ic;
  } else {
    p0 = blockIdx.x * a.tile_w;
    npos = min(a.tile_w, a.ho * a.wo - p0);
    rfirst = p0 / a.wo;
    row0 = rfirst * s;
    col0 = 0;
    wh = ((p0 + npos - 1) / a.wo - rfirst) * s + a.k;
    span = a.wp * ic;
  }

  // -- stage: word sources, column scales, window, filter -----------------
  if (tid < KQ) qtab[tid] = quad_of(tid, a.k * ic, K);
  if (tid < a.ocb) {
    const int o = min(oc0 + tid, a.oc - 1);
    sc[tid] = a.w_scale[o];
    bs[tid] = a.bias != nullptr ? a.bias[o] : 0.f;
  }
  const int8_t* xb = a.x + (size_t)b * a.hp * a.wp * ic;
  const int nc = (span + 30) / 16;            // chunks a row, at most
#pragma unroll 4
  for (int i = tid; i < wh * nc; i += THREADS) {
    const int r = i / nc, j = i % nc;
    const uintptr_t g0 = reinterpret_cast<uintptr_t>(
        xb + ((size_t)(row0 + r) * a.wp + col0) * ic);
    const uintptr_t c = (g0 & ~uintptr_t(15)) + 16 * j;
    if (j == 0) rowoff[r] = r * L.rs + static_cast<int>(g0 & 15);
    if (c < g0 + span)
      *reinterpret_cast<uint4*>(win + r * L.rs + 16 * j) =
          __ldg(reinterpret_cast<const uint4*>(c));
  }
  const int nrow = up16(a.ocb);
#pragma unroll 4
  for (int i = tid; i < nrow * KQ; i += THREADS) {
    const int n = i % nrow, q = i / nrow;
    unsigned word = 0;
    if (n < ocv) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * q + j < K)
          word |= static_cast<unsigned>(static_cast<uint8_t>(
                      a.w[(size_t)(4 * q + j) * a.oc + oc0 + n])) << (8 * j);
    }
    *reinterpret_cast<unsigned*>(bt + n * L.as + 4 * q) = word;
  }
  __syncthreads();

  // -- each warp: m16 tiles of positions, the whole K, every channel -------
  int8_t* col = reinterpret_cast<int8_t*>(sm + L.col) + warp * 16 * L.as;
  int2* rinfo = reinterpret_cast<int2*>(sm + L.rinfo) + warp * 16;
  const int es = a.out_int8 ? 1 : 4;
  unsigned char* dst = MAX ? sm + L.out : sm + L.out + warp * 16 * a.ocb * es;
  const int ntiles = a.ocb / 8, g = lane >> 2, t4 = lane & 3;
  // ldmatrix row addresses: A rows (lane & 7) + 8 ((lane >> 3) & 1), k unit
  // lane >> 4; B columns 8 (lane >> 4) + (lane & 7), k unit (lane >> 3) & 1
  const unsigned a_addr = smem_addr(
      col + ((lane & 7) + ((lane >> 3) & 1) * 8) * L.as + (lane >> 4) * 16);
  const unsigned b_addr = smem_addr(
      bt + ((lane >> 4) * 8 + (lane & 7)) * L.as + ((lane >> 3) & 1) * 16);
  const int mtiles = (npos + 15) / 16;
  for (int mt = warp; mt < mtiles; mt += WARPS) {
    // each row's window row and byte offset (rows past npos repeat the last)
    if (lane < 16) {
      const int p = min(mt * 16 + lane, npos - 1);
      int pr, pc;
      if (MAX) {
        pr = p / cw;
        pc = p % cw;
      } else {
        pr = (p0 + p) / a.wo - rfirst;
        pc = (p0 + p) % a.wo;
      }
      rinfo[lane] = make_int2(pr * s, pc * s * ic);
    }
    __syncwarp();
#pragma unroll 4
    for (int t = 0; t < KQ / 2; ++t) {
      const int wi = lane + 32 * t, i = wi / KQ, q = wi % KQ;
      const int2 ri = rinfo[i];
      const int4 qt = qtab[q];
      unsigned word = 0;
      if (qt.x >= 0) {
        word = window_word(win, rowoff[ri.x + qt.x] + ri.y + qt.y);
        if (qt.z != -2) {
          const unsigned hi =
              qt.z >= 0 ? window_word(win, rowoff[ri.x + qt.z] + ri.y - qt.w)
                        : 0u;
          const int lo = 4 * qt.w;            // bytes 0..j0-1 stay
          word = __byte_perm(word, hi, (0x7654 & (0xffff << lo)) |
                                           (0x3210 & ((1 << lo) - 1)));
        }
      }
      *reinterpret_cast<unsigned*>(col + i * L.as + 4 * q) = word;
    }
    __syncwarp();

    int acc[MAX_OCB / 8][4];
#pragma unroll
    for (int j = 0; j < MAX_OCB / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0;
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      unsigned af[4];
      ldmatrix4(af, a_addr + st * 32);
#pragma unroll
      for (int jj = 0; jj < MAX_OCB / 16; ++jj) {
        if (2 * jj < ntiles) {
          unsigned bf[4];
          ldmatrix4(bf, b_addr + jj * 16 * L.as + st * 32);
          mma_s8(acc[2 * jj], af, bf[0], bf[1]);
          if (2 * jj + 1 < ntiles) mma_s8(acc[2 * jj + 1], af, bf[2], bf[3]);
        }
      }
    }

    // the epilogue of each sum: accumulator (j, r) is row g (+ 8 for r >=
    // 2), column 8 j + 2 t4 + (r & 1)
#pragma unroll
    for (int j = 0; j < MAX_OCB / 8; ++j) {
      if (j < ntiles) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = g + 8 * (r >> 1), p = mt * 16 + row;
          const int c = 8 * j + 2 * t4 + (r & 1);
          if (p < npos && c < ocv) {
            const float v = dequant_bias_act(acc[j][r], a.a_scale, sc[c],
                                             a.bias != nullptr ? bs : nullptr,
                                             c, a.act);
            const int at = (MAX ? p : row) * ocv + c;
            if (es == 1)
              reinterpret_cast<int8_t*>(dst)[at] =
                  static_cast<int8_t>(qdq_code(v, a.os));
            else
              reinterpret_cast<float*>(dst)[at] = v;
          }
        }
      }
    }
    if (!MAX) {
      __syncwarp();
      store_rows(a.out, dst, (size_t)b * a.ho * a.wo + p0 + mt * 16,
                 min(16, npos - mt * 16), ocv, a.oc, oc0, es, lane);
    }
    __syncwarp();
  }
  if (!MAX) return;

  // -- the max tail: each pooled output's window, taps in (kh, kw) order ---
  __syncthreads();
  if (es == 1 && a.oc % 4 == 0) {     // int8 codes, four channels a word
    const int ov = ocv / 4;
    const unsigned* t = reinterpret_cast<const unsigned*>(dst);
    for (int i = tid; i < th * tw * ov; i += THREADS) {
      const int o = i % ov, pp = i / ov, pr = pp / tw, pc = pp % tw;
      const int base = pr * a.ps * cw + pc * a.ps;
      unsigned m = t[base * ov + o];
      for (int kh = 0; kh < a.pk; ++kh)
        for (int kw = 0; kw < a.pk; ++kw)
          m = __vmaxs4(m, t[(base + kh * cw + kw) * ov + o]);
      *reinterpret_cast<unsigned*>(
          static_cast<int8_t*>(a.out) +
          (((size_t)b * a.pho + ph0 + pr) * a.pwo + pw0 + pc) * a.oc + oc0 +
          4 * o) = m;
    }
    return;
  }
  for (int i = tid; i < th * tw * ocv; i += THREADS) {
    const int o = i % ocv, pp = i / ocv, pr = pp / tw, pc = pp % tw;
    const int base = pr * a.ps * cw + pc * a.ps;
    const size_t idx =
        (((size_t)b * a.pho + ph0 + pr) * a.pwo + pw0 + pc) * a.oc + oc0 + o;
    if (es == 1) {
      const int8_t* t = reinterpret_cast<const int8_t*>(dst);
      int m = t[base * ocv + o];
      for (int kh = 0; kh < a.pk; ++kh)
        for (int kw = 0; kw < a.pk; ++kw)
          m = max(m, static_cast<int>(t[(base + kh * cw + kw) * ocv + o]));
      static_cast<int8_t*>(a.out)[idx] = static_cast<int8_t>(m);
    } else {
      const float* t = reinterpret_cast<const float*>(dst);
      float m = t[base * ocv + o];
      for (int kh = 0; kh < a.pk; ++kh)
        for (int kw = 0; kw < a.pk; ++kw)
          m = fmaxf(m, t[(base + kh * cw + kw) * ocv + o]);
      static_cast<float*>(a.out)[idx] = m;
    }
  }
}

template <int KS, bool MAX>
int launch(const Stem& a, int smem, dim3 grid, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      stem_kernel<KS, MAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  stem_kernel<KS, MAX><<<grid, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int KS>
int dispatch(int ks, const Stem& a, int smem, dim3 grid, cudaStream_t s) {
  if constexpr (KS > MAX_KSTEPS) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (ks != KS) return dispatch<KS + 1>(ks, a, smem, grid, s);
    return a.pk > 0 ? launch<KS, true>(a, smem, grid, s)
                    : launch<KS, false>(a, smem, grid, s);
  }
}

}  // namespace

// out = epilogue(conv(x[N, Hp, Wp, IC], w[k, k, IC, OC])), VALID, stride s:
// [N, Ho, Wo, OC] int8 codes at os (out_int8) or f32.  pk > 0 fuses a VALID
// pk x pk / ps max pool: [N, PHo, PWo, OC], int8 codes at os (out_int8, the
// static chain's mid_scale, which the max keeps) or f32.  tile_w positions
// a block without the tail, tile_h x tile_w pooled outputs with it; ocb
// channels a block (a multiple of 8, at most 64).  Pointers are device
// pointers (bias may be null); the launch goes on `stream`.  Returns
// cudaErrorInvalidValue for arguments the kernel does not take (K past 256,
// shared memory past 227 KB), else cudaGetLastError().
extern "C" int low_channel_conv(const void* x, const void* w,
                                const void* bias, const void* w_scale,
                                float a_scale, void* out, int n, int hp,
                                int wp, int ic, int oc, int k, int stride,
                                int act, int out_int8, float os, int pk,
                                int ps, int tile_h, int tile_w, int ocb,
                                void* stream) {
  constexpr int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n < 1 || ic < 1 || oc < 1 || k < 1 || stride < 1 || k > hp ||
      k > wp || k * ic < 3 || ocb < 8 || ocb > MAX_OCB || ocb % 8 ||
      tile_w < 1 || tile_h < 1 || n > 65535)
    return bad;
  const int ks = (k * k * ic + 31) / 32;
  Stem a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
         static_cast<const float*>(bias), static_cast<const float*>(w_scale),
         a_scale, out, hp, wp, ic, oc, k, stride, (hp - k) / stride + 1,
         (wp - k) / stride + 1, act, out_int8, os, pk, ps, 0, 0, tile_h,
         tile_w, ocb};
  unsigned tiles;
  if (pk > 0) {
    if (ps < 1 || pk > a.ho || pk > a.wo) return bad;
    a.pho = (a.ho - pk) / ps + 1;
    a.pwo = (a.wo - pk) / ps + 1;
    tiles = ((a.pho + tile_h - 1) / tile_h) * ((a.pwo + tile_w - 1) / tile_w);
  } else {
    tiles = (a.ho * a.wo + tile_w - 1) / tile_w;
  }
  if (ks > MAX_KSTEPS) return bad;
  const int smem = layout_of(a, ks).total;
  if (smem > SMEM_MAX) return bad;
  const dim3 grid(tiles, (oc + ocb - 1) / ocb, n);
  return dispatch<1>(ks, a, smem, grid, static_cast<cudaStream_t>(stream));
}
