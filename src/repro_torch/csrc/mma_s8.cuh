// The int8 tensor-core tile steps the Conv PE's mma_kernel (conv_pe.cu) and
// the Low-Channel stem (low_channel.cu) share: ldmatrix fragment loads from
// shared memory and mma.sync.m16n8k32 s8 x s8 -> s32.
//
// Fragment layout (PTX ISA, m16n8k32 .s8): lane = 4 g + t.  A (row-major,
// 16 x 32): a[0] row g, k bytes 4t..4t+3; a[1] row g + 8, same k; a[2] / a[3]
// the same rows at k 16 + 4t.  B (column-major, 32 x 8): b0 column g, k
// bytes 4t..4t+3; b1 column g, k 16 + 4t.  C: c[0], c[1] row g, columns 2t
// and 2t + 1; c[2], c[3] row g + 8.  ldmatrix.x4 hands lane l the 4 bytes
// 4t..4t+3 of row g of each of four 8 x 16-byte matrices, whose row
// addresses lanes 8i..8i+7 give: K-major tiles in shared memory load
// straight into these fragments.
#pragma once

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace repro
