// Tensor-core building blocks for bf16 inputs with f32 accumulators:
// mma.sync.aligned.m16n8k16 fed by ldmatrix from swizzled shared memory
// (kv_ring.cuh). Used by split_decode.cuh (kernels 1, 3 and 6), where the
// GQA group's few query heads are the rows of one tile; mq_paged_attention.cu
// shares the register layouts and pack_bf16 and multiplies through
// wgmma_bf16.cuh.
//
// Fragment layouts of one warp (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), four registers of two bf16:
//     a0 = (row g,     k 2t, 2t+1)      a1 = (row g + 8, k 2t, 2t+1)
//     a2 = (row g,     k 2t+8, 2t+9)    a3 = (row g + 8, k 2t+8, 2t+9)
//   B (16 x 8, "col": the k index is the fast one), two registers:
//     b0 = (k 2t, 2t+1, n g)            b1 = (k 2t+8, 2t+9, n g)
//   C / D (16 x 8), four f32:
//     c0, c1 = (row g, n 2t, 2t+1)      c2, c3 = (row g + 8, n 2t, 2t+1)
// So the C fragments of two neighbouring 8-wide tiles (16 columns) are, after
// rounding to bf16, exactly the A fragment of the next product over those 16
// columns: probabilities go from the score product into the value product
// without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace xllm {

// Four 8 x 8 matrices of 16-bit elements from shared memory. Lane l gives
// the address of row l % 8 of matrix l / 8 (16 bytes); register i of every
// lane receives elements (row g, columns 2t, 2t+1) of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same with every matrix transposed on the way: register i receives
// elements (rows 2t, 2t+1, column g) of matrix i as stored.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16 bf16) * b (16 x 8 bf16), f32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace xllm
