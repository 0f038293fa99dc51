// Paged KV gather on Hopper: block-table-indexed page copy.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attn.py::
// paged_gather (_gather_kernel :110, scalar-prefetched block table)
//                                                     -> paged_gather
//
// out[b, m*P + p, ...] = pool[tables[b, m], p, ...]: each (slot, page) of
// the table copies one page of P * F elements, a pure copy (the output is
// bitwise its input, whatever the element type: bf16 KV, f32 scales).
//
// What bounds it on the H100: bytes, and at decode the launch itself.  A
// decode step gathers k and v for every global layer (56 launches for
// qwen2-1.5b), each a few tens of KB (B * pages pages of P*Hkv*D bf16), far
// under what a microsecond of HBM moves.  The design keeps the copy as lean
// as a copy gets: one block per (slot, page) reads its block id from the
// table itself (the TPU's scalar prefetch has no counterpart to need) and
// moves the page with 16-byte vector loads and stores when its byte count
// allows (a byte loop otherwise).  The ops wrapper clips the table into
// [0, N-1]; the kernel clamps again so that no entry can address outside
// the pool.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gather_kernel(const uint8_t* __restrict__ pool, const int* __restrict__ tables,
              uint8_t* __restrict__ out, int N, int M, long long page_bytes) {
  const int m = blockIdx.x, b = blockIdx.y;
  const int blk = min(max(tables[(size_t)b * M + m], 0), N - 1);
  const uint8_t* src = pool + (size_t)blk * page_bytes;
  uint8_t* dst = out + ((size_t)b * M + m) * page_bytes;
  if (page_bytes % 16 == 0) {
    const auto* s4 = reinterpret_cast<const uint4*>(src);
    auto* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < page_bytes / 16; i += THREADS)
      d4[i] = s4[i];
  } else {
    for (long long i = threadIdx.x; i < page_bytes; i += THREADS)
      dst[i] = src[i];
  }
}

}  // namespace

// out [B, M, page_bytes] <- pool [N, page_bytes] through tables [B, M] int32.
// Pointers are device pointers (pool and out 16-byte aligned, which the
// wrapper checks); the launch goes on `stream`.  Returns cudaGetLastError().
extern "C" int paged_gather(const void* pool, const void* tables, void* out,
                            int N, int B, int M, long long page_bytes,
                            void* stream) {
  const dim3 grid(M, B);
  gather_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const int*>(tables),
      static_cast<uint8_t*>(out), N, M, page_bytes);
  return static_cast<int>(cudaGetLastError());
}
