// KV page movers for the tiered cache, for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   xllm_service_tpu/ops/pallas_page_dma.py::gather_kv_pages
//     (_gather_pages_kernel)
//   xllm_service_tpu/ops/pallas_page_dma.py::scatter_kv_pages
//     (_scatter_pages_kernel)
//
// The pool is [L, 2, P, n_kv, ps, hd]; a block buffer is [L, 2, n, n_kv, ps,
// hd]. Row (l, s, i) of the block is row (l, s, ids[i]) of the pool: one
// contiguous run of n_kv * ps * hd elements. Gather copies pool rows into
// the block; scatter copies block rows into the pool, in place.
//
// What bounds it on this card: the bytes it moves. One Llama-3-8B hash block
// (128 tokens = 8 pages of 8 KV heads x 16 x 128 bf16, 32 layers, K and V) is
// 16 MiB read and 16 MiB written: 33.6 MB / 3.35 TB/s = 10.0 us.
//
// What the design does about it: no arithmetic and no staging. The TPU
// kernel's grid of one DMA and one semaphore wait per row is not carried
// over; here one grid covers all L * 2 * n rows, each block copies its row
// (32 KiB at Llama-3-8B's width) with 16-byte loads and stores, neighbouring
// threads on neighbouring addresses, so every warp moves 512 contiguous bytes
// per instruction. The copy is of bytes, so one kernel serves every dtype; a
// row whose length or address is not a multiple of 16 bytes takes a
// byte-wide loop instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Row r = (ls, i) with ls = l * 2 + s in [0, L * 2) and i in [0, n). The
// pool side of the row is (ls, ids[i]) in a pool of P pages per (l, s).
__global__ void __launch_bounds__(kThreads)
    move_rows_kernel(const char* __restrict__ src, char* __restrict__ dst,
                     const int* __restrict__ ids, int n, int P,
                     long long row_bytes, int to_pool) {
  const long long r = blockIdx.x;
  const long long ls = r / n;
  const int i = static_cast<int>(r - ls * n);
  const long long pool_row = ls * P + ids[i];
  const long long blk_row = r;
  const long long src_row = to_pool ? blk_row : pool_row;
  const long long dst_row = to_pool ? pool_row : blk_row;
  const char* s = src + src_row * row_bytes;
  char* d = dst + dst_row * row_bytes;
  if ((row_bytes & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    const long long n4 = row_bytes >> 4;
#pragma unroll 4
    for (long long j = threadIdx.x; j < n4; j += blockDim.x) d4[j] = s4[j];
  } else {
    for (long long j = threadIdx.x; j < row_bytes; j += blockDim.x) d[j] = s[j];
  }
}

}  // namespace

extern "C" {

// Gather (to_pool 0): pool rows (ls, ids[i]) -> block rows (ls, i).
// Scatter (to_pool 1): block rows (ls, i) -> pool rows (ls, ids[i]).
// rows_ls = L * 2; ids holds n page ids, each in [0, P) (checked by the
// caller). Returns cudaGetLastError() of the launch.
int page_dma_launch(void* pool, void* block, const void* ids,
                    int rows_ls, int n, int P, long long row_bytes,
                    int to_pool, void* stream) {
  const long long rows = static_cast<long long>(rows_ls) * n;
  if (rows == 0 || row_bytes == 0) return 0;
  if (rows > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const char* src = static_cast<const char*>(to_pool ? block : pool);
  char* dst = static_cast<char*>(to_pool ? pool : block);
  move_rows_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      src, dst, static_cast<const int*>(ids), n, P, row_bytes, to_pool);
  return int(cudaGetLastError());
}

}  // extern "C"
