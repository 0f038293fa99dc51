// The int8 tile steps the Conv PE kernels (conv_pe.cu, conv_pe_w4.cu) and
// the Low-Channel stem (low_channel.cu) share: ldmatrix fragment loads from
// shared memory and mma.sync.m16n8k32 s8 x s8 -> s32; the cp.async copies,
// the swizzled 64-byte-row tiles and the 4x4 byte transpose of the Conv PE's
// kernels.
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

#include <cstdint>
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

// An asynchronous copy of BYTES (4, 8 or 16) from global to shared memory,
// zero-filled when !ok (src then only has to be a valid address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES),
                 "r"(ok ? BYTES : 0));
}

// 16 bytes of a row from byte `col` into dst, zero-filled from `limit` on.
// V16: one 16-byte cp.async; else pieces of w bytes (8 / 4 by cp.async, 2 /
// 1 byte by byte), each lying wholly before or after `limit`.
template <bool V16>
__device__ __forceinline__ void copy16(int8_t* dst, const int8_t* row,
                                       int col, int limit, int w) {
  if (V16) {
    const bool ok = col < limit;
    cp_async<16>(dst, ok ? row + col : row, ok);
  } else if (w >= 4) {
    for (int p = 0; p < 16; p += w) {
      const bool ok = col + p < limit;
      const int8_t* src = ok ? row + col + p : row;
      if (w == 16)
        cp_async<16>(dst + p, src, ok);
      else if (w == 8)
        cp_async<8>(dst + p, src, ok);
      else
        cp_async<4>(dst + p, src, ok);
    }
  } else {
    for (int p = 0; p < 16; ++p)
      dst[p] = col + p < limit ? row[col + p] : int8_t(0);
  }
}

// 16-byte unit c of K-major row r in a [rows][64] tile.  A tiles: 8
// consecutive rows of one unit land in 8 distinct bank groups (ldmatrix).
__device__ __forceinline__ int a_unit(int r, int c) {
  return r * 4 + (c ^ ((r >> 1) & 3));
}
// The transposed B tile: conflict-free for ldmatrix (8 consecutive columns,
// one unit) and for the transposing 16-byte stores (columns 4l + j, l =
// 0..7).  The XOR stays inside a pair of rows.
__device__ __forceinline__ int b_unit(int n, int c) {
  const int g = ((n >> 2) & 1) | ((((n >> 1) ^ (n >> 3)) & 1) << 1) |
                (((n >> 4) & 1) << 2);
  return (n * 4 + c) ^ g;
}

// Columns 0..3 of rows r0..r3 (one byte each) -> rows 0..3 of columns c0..c3:
// c_j holds column j's four k bytes, k = 0 in the low byte.
__device__ __forceinline__ void transpose4(unsigned r0, unsigned r1,
                                           unsigned r2, unsigned r3,
                                           unsigned& c0, unsigned& c1,
                                           unsigned& c2, unsigned& c3) {
  const unsigned t0 = __byte_perm(r0, r1, 0x5140);   // r0b0 r1b0 r0b1 r1b1
  const unsigned t1 = __byte_perm(r0, r1, 0x7362);   // r0b2 r1b2 r0b3 r1b3
  const unsigned t2 = __byte_perm(r2, r3, 0x5140);
  const unsigned t3 = __byte_perm(r2, r3, 0x7362);
  c0 = __byte_perm(t0, t2, 0x5410);
  c1 = __byte_perm(t0, t2, 0x7632);
  c2 = __byte_perm(t1, t3, 0x5410);
  c3 = __byte_perm(t1, t3, 0x7632);
}

}  // namespace repro
