// The tensor cores' bf16 product as the kernels issue it by hand:
// mma.sync.aligned.m16n8k16 with bf16 operands and float32 sums, fed by
// ldmatrix from shared memory.  rnn_avg.cu (the bf16 one-CTA and cluster
// tiles) and rnn_grid.cu (the grid tile's bf16 step) include it.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, float32 sums.
__device__ __forceinline__ void MmaBf16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16 x 16 bf16 tile in shared memory: lane l gives the
// address of row l % 16, columns 8 (l / 16) .. +7.
__device__ __forceinline__ void LdMatrixX4(uint32_t (&a)[4],
                                           const __nv_bfloat16 *row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// The B fragments of two n8 tiles from a 16 (k) x 16 (n) bf16 tile kept
// k-major in shared memory (n contiguous): lane l gives the address of k
// row l % 16, columns 8 (l / 16) .. +7; b[0], b[1] are the first n8
// tile's (k 0-7, 8-15), b[2], b[3] the second's.
__device__ __forceinline__ void LdMatrixX4Trans(uint32_t (&b)[4],
                                                const __nv_bfloat16 *row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

}  // namespace
