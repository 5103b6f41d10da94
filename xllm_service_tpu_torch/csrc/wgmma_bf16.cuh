// Warpgroup matrix multiply for bf16 inputs with f32 accumulators
// (wgmma.mma_async, sm_90a only): four warps together multiply a 64-row A
// tile held in registers with a B tile read straight from shared memory, at
// the card's full tensor-core rate and without the ldmatrix traffic of
// mma.sync. Used by mq_paged_attention.cu.
//
// A (64 x 16 per instruction) comes from registers: warp w of the warpgroup
// holds rows [16 w, 16 w + 16) in the layout of mma.sync's A fragment
// (mma_bf16.cuh), and the accumulator has that instruction's C layout,
// repeated over the N / 8 column tiles: d[4 j + 0, 1] = (row g, columns
// 8 j + 2 t, + 1), d[4 j + 2, 3] = (row g + 8, same columns). So the scores
// of one product are again the A operand of the next.
//
// B comes from shared memory through a 64-bit descriptor, in the 128-byte
// swizzle: rows of 64 bf16 (128 bytes), the 16-byte piece c of row r stored
// at piece c ^ (r % 8), eight rows (1024 bytes) to an atom, the tile
// 1024-byte aligned.
// - K-major (tnsp_b 0; K for the score product: row = key, the head dim
//   contiguous): an instruction covers N rows and 16 elements (32 bytes) of
//   the row; the k-step advances the start address by 32 bytes inside the
//   row, SBO is the stride between 8-row atoms along N.
// - MN-major (tnsp_b 1; V for the value product: row = key again, but now
//   the contiguous head dim is the product's N): an instruction covers 16
//   rows (two atoms along k, SBO apart) and N columns (N / 64 atoms along n,
//   LBO apart); the k-step advances the start address by 16 rows.

#pragma once

#include <stdint.h>

namespace xllm {

// Descriptor of a 128-byte-swizzled tile at shared-memory address `addr`;
// lbo and sbo in bytes.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr, int lbo,
                                                     int sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

// Orders earlier register and shared-memory accesses of the warpgroup before
// the wgmma instructions that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes writes to shared memory by ordinary stores and cp.async visible to
// the asynchronous proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The compiler does not know that wgmma writes its accumulators after the
// instruction was started: this pins every use of `x` behind the wait.
template <int N>
__device__ __forceinline__ void wgmma_pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// The same for A operands held in registers, which the tensor cores read
// until the wait: a use here keeps the compiler from reusing them earlier.
template <int N>
__device__ __forceinline__ void wgmma_pin(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// d (64 x 64, f32) = a (64 x 16 bf16, registers) * b (16 x 64 bf16, shared
// memory through desc_b) + (scale_d ? d : 0). tnsp_b: 0 where b's k index is
// the contiguous one in shared memory (K-major), 1 where its n index is.
template <int kTnspB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(kTnspB));
}

// d (64 x 128, f32) = a (64 x 16 bf16, registers) * b (16 x 128 bf16, shared
// memory through desc_b) + (scale_d ? d : 0). tnsp_b: 0 where b's k index is
// the contiguous one in shared memory (K-major), 1 where its n index is.
template <int kTnspB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(kTnspB));
}

}  // namespace xllm
