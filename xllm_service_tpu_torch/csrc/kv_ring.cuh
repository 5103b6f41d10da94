// Staged K/V loads for the redesigned attention kernels (split_decode.cuh,
// the walk of kernels 1, 3 and 6; mq_paged_attention.cu): 16-byte cp.async
// copies from the page pool into a ring of shared-memory stages, so the
// loads of a later stage are in flight while an earlier one is multiplied.
//
// Layout of a staged token row: hd elements of T, contiguous, cut into
// 16-byte pieces; piece c of token t is stored at piece c ^ swizzle(t).
// Eight neighbouring tokens then put the same logical piece into eight
// different 16-byte bank groups, so both a column walk over tokens (one
// lane per token, every lane the same piece) and ldmatrix (eight rows of
// 16 bytes) read without bank conflicts and without padding.
//
// The invariant carried over from page_walk.cuh (masked_kv_f32): a token at
// a position at or past the context bound is ZERO in shared memory. Here
// the copy itself does it: cp.async with a source size of 0 writes 16 zero
// bytes and reads nothing, so NaN in a dead slot never reaches a product.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace xllm {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1 (K/V are read once per block).
// With live == false nothing is read and the 16 bytes are zero-filled; src
// must still be a valid address.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool live) {
  const int n = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// XOR applied to the 16-byte piece index of token t, for rows of
// kPieces pieces (a power of two, at least 4). Rows of 128 bytes or more
// rotate through all eight bank groups; a 64-byte row shares its 128 bytes
// with its neighbour, so pairs of tokens rotate through its four pieces.
template <int kPieces>
__device__ __forceinline__ int swizzle_of(int t) {
  static_assert(kPieces >= 4 && (kPieces & (kPieces - 1)) == 0,
                "token rows are 64 bytes or more, a power of two");
  return kPieces >= 8 ? (t & 7) : ((t >> 1) & 3);
}

// Byte offset, inside a staged tile of rows of kPieces pieces, of logical
// piece c of token t.
template <int kPieces>
__device__ __forceinline__ int staged_offset(int t, int c) {
  return (t * kPieces + (c ^ swizzle_of<kPieces>(t))) << 4;
}

}  // namespace xllm
