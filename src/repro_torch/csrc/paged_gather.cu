// Paged KV gather on Hopper: block-table-indexed page copy, the k and v
// pools of a layer in one launch.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attn.py::
// paged_gather (_gather_kernel :110, scalar-prefetched block table)
//                                                     -> paged_gather
//
// out[b, m*P + p, ...] = pool[tables[b, m], p, ...] for each pool: each
// (slot, page) of the table copies one page of P * F elements, a pure copy
// (the output is bitwise its input, whatever the element type: bf16 KV,
// f32 scales).
//
// What bounds it on the H100: latency and launches, not bytes.  A decode
// step of qwen2-1.5b (4 slots, 8 pages of 8 KB each) reads 512 KB a global
// layer for k and v together and writes as much, 0.3 us of HBM, while a
// launch and a dependent table read cost microseconds.  The design: one
// launch serves both pools of a layer (the v pool may be null: the
// single-pool gather runs the same kernel); every block reads its (slot,
// page) table entry once and copies that page's chunk of k and of v; pages
// are split into chunks of one vector a thread, as many as give the card
// at least 132 blocks (blocks of 256 threads, halved down to 32 until they
// do); each thread issues both loads before either store.  Vectors are 16
// bytes where the page's byte count and the pointers allow, else 8, 4, 2
// or 1.  The kernel clamps each table entry into [0, N-1] (unallocated
// pages hold the sentinel N; what a clamped sentinel reads lies past the
// slot's length, where the decode mask discards it), so no entry can
// address outside the pool and the wrapper launches nothing else.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MIN_BLOCKS = 132;        // the H100's SMs

template <int W> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = unsigned; };
template <> struct Vec<2> { using T = unsigned short; };
template <> struct Vec<1> { using T = unsigned char; };

// grid (page chunks, B * M); a thread moves vector i of its page's chunk.
template <int W>
__global__ void gather_kernel(const void* __restrict__ pk,
                              const void* __restrict__ pv,
                              const int* __restrict__ tables,
                              void* __restrict__ ok, void* __restrict__ ov,
                              int N, long long page_vecs) {
  using T = typename Vec<W>::T;
  const long long bm = blockIdx.y;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= page_vecs) return;
  const long long blk = min(max(__ldg(tables + bm), 0), N - 1);
  const long long src = blk * page_vecs + i, dst = bm * page_vecs + i;
  const T k = __ldg(static_cast<const T*>(pk) + src);
  if (pv != nullptr) {
    const T v = __ldg(static_cast<const T*>(pv) + src);
    static_cast<T*>(ok)[dst] = k;
    static_cast<T*>(ov)[dst] = v;
  } else {
    static_cast<T*>(ok)[dst] = k;
  }
}

template <int W>
int launch(const void* pk, const void* pv, const void* tables, void* ok,
           void* ov, int N, int BM, long long page_bytes, cudaStream_t s) {
  const long long vecs = page_bytes / W;
  int threads = 256;                      // halved while the card idles
  while (threads > 32 && BM * ((vecs + threads - 1) / threads) < MIN_BLOCKS)
    threads /= 2;
  const dim3 grid(static_cast<unsigned>((vecs + threads - 1) / threads), BM);
  gather_kernel<W><<<grid, threads, 0, s>>>(
      pk, pv, static_cast<const int*>(tables), ok, ov, N, vecs);
  return static_cast<int>(cudaGetLastError());
}

bool fits(int w, long long page_bytes, const void* p) {
  return p == nullptr ||
         (page_bytes % w == 0 && reinterpret_cast<uintptr_t>(p) % w == 0);
}

}  // namespace

// out_k [B, M, page_bytes] <- pool_k [N, page_bytes] through tables [B, M]
// int32, and out_v from pool_v the same way when pool_v is not null (both
// pools then have the same page size).  Pointers are device pointers; the
// launch goes on `stream`.  Returns cudaErrorInvalidValue for arguments the
// kernel does not take, else cudaGetLastError().
extern "C" int paged_gather(const void* pool_k, const void* pool_v,
                            const void* tables, void* out_k, void* out_v,
                            int N, int B, int M, long long page_bytes,
                            void* stream) {
  if (N < 1 || B < 1 || M < 1 || page_bytes < 1 ||
      (pool_v == nullptr) != (out_v == nullptr) ||
      static_cast<long long>(B) * M > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int bm = B * M;
  constexpr int widths[] = {16, 8, 4, 2};
  for (const int w : widths) {
    if (fits(w, page_bytes, pool_k) && fits(w, page_bytes, pool_v) &&
        fits(w, page_bytes, out_k) && fits(w, page_bytes, out_v)) {
      if (w == 16)
        return launch<16>(pool_k, pool_v, tables, out_k, out_v, N, bm,
                          page_bytes, s);
      if (w == 8)
        return launch<8>(pool_k, pool_v, tables, out_k, out_v, N, bm,
                         page_bytes, s);
      if (w == 4)
        return launch<4>(pool_k, pool_v, tables, out_k, out_v, N, bm,
                         page_bytes, s);
      return launch<2>(pool_k, pool_v, tables, out_k, out_v, N, bm,
                       page_bytes, s);
    }
  }
  return launch<1>(pool_k, pool_v, tables, out_k, out_v, N, bm, page_bytes,
                   s);
}
