// KV page movers for the tiered cache, for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   xllm_service_tpu/ops/pallas_page_dma.py::gather_kv_pages
//     (_gather_pages_kernel)
//   xllm_service_tpu/ops/pallas_page_dma.py::scatter_kv_pages
//     (_scatter_pages_kernel)
//
// A pool is one or more shards [L, 2, P_loc, n_kv, ps, hd] (one for an
// unsharded pool; under a seq mesh shard d holds global pages [d * P_loc,
// (d + 1) * P_loc)); a block buffer is [L, 2, n, n_kv, ps, hd]. A launch
// moves m table entries: entry j is page local[j] of shard owner[j] and slot
// slot[j] of the block, and row (ls, slot[j]) of the block is row (ls,
// local[j]) of that shard for every ls = l * 2 + s: one contiguous run of
// row_bytes = n_kv * ps * hd * elem bytes. Gather copies shard rows into the
// block; scatter copies block rows into the shards, in place. So one launch
// moves a hash block whatever its spread over the shards of one device.
//
// What bounds it on this card: the bytes it moves. One Llama-3-8B hash block
// (128 tokens = 8 pages of 8 KV heads x 16 x 128 bf16, 32 layers, K and V) is
// 16 MiB read and 16 MiB written: 33.6 MB / 3.35 TB/s = 10.0 us.
//
// What the design does about it: no arithmetic, and the copy engine inside
// each SM (the TMA) moves the bytes. The work is cut into units, a fixed
// chunk of one row each, and a grid of a few blocks per SM walks them. In
// each block one thread issues 1-D bulk copies from global memory into a
// ring of stages in shared memory (completion counted in bytes on one
// mbarrier per stage) and, as each stage lands, a bulk copy from it to its
// destination; a stage is reloaded once its store has read it
// (cp.async.bulk.wait_group.read). No thread spends registers on the bytes,
// and stages x chunk bytes are in flight per block: the wrapper's 8 x 16 KiB
// at one block per SM keeps 17 MB in flight across 132 SMs, the whole of a
// Llama-3-8B block (the fastest shape of chip_smoke.py's sweep, at the time
// of the card's own contiguous copy of the same bytes). The table (shard
// bases, local pages, slots) is a kernel parameter: it sits in the constant
// bank, so no unit waits on a dependent load of a page id, and the launch
// needs no upload. Bulk copies need 16-byte aligned addresses and sizes; a
// pool or block that fails that (rows of an odd count of 2-byte elements)
// takes a byte loop over the same units.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShards = 8;
constexpr int kMaxSlots = 256;
constexpr int kMaxStages = 8;
constexpr int kBulkThreads = 32;
constexpr int kByteThreads = 256;

// The launch's table, passed by value (2.1 KB of parameter space).
struct Table {
  char* shard[kMaxShards];  // base of each shard [rows_ls, P_loc, row]
  int local[kMaxSlots];     // page of entry j within its shard
  int where[kMaxSlots];     // owner << 24 | block slot of entry j
};

struct Geometry {
  char* block;              // [rows_ls, n_blk, row]
  long long row_bytes;
  long long units;          // rows_ls * m * chunks_per_row
  int m, n_blk, P_loc, to_pool, chunk, chunks_per_row;
};

// Unit u: chunk c of entry row r = (ls, j). Returns its source, its
// destination and its byte count.
__device__ __forceinline__ uint32_t unit_span(const Table& t,
                                              const Geometry& g, long long u,
                                              const char** src, char** dst) {
  const long long r = u / g.chunks_per_row;
  const long long off =
      static_cast<long long>(u - r * g.chunks_per_row) * g.chunk;
  const long long ls = r / g.m;
  const int j = static_cast<int>(r - ls * g.m);
  const int where = t.where[j];
  char* pool = t.shard[where >> 24] +
               (ls * g.P_loc + t.local[j]) * g.row_bytes + off;
  char* blk =
      g.block + (ls * g.n_blk + (where & 0xffffff)) * g.row_bytes + off;
  *src = g.to_pool ? blk : pool;
  *dst = g.to_pool ? pool : blk;
  const long long left = g.row_bytes - off;
  return static_cast<uint32_t>(left < g.chunk ? left : g.chunk);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// The bulk-copy route: lane 0 of each block walks units u = blockIdx.x +
// k * gridDim.x through a ring of `stages` chunks.
__global__ void __launch_bounds__(kBulkThreads)
    bulk_copy_kernel(const __grid_constant__ Table t, const Geometry g,
                     int stages) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  if (threadIdx.x != 0) return;
  const long long first = blockIdx.x, step = gridDim.x;
  const long long count = (g.units - first + step - 1) / step;
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(&full[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const uint32_t ring0 = smem_addr(ring);
  const char* src;
  char* dst;
  for (long long k = 0; k < count && k < stages; ++k) {
    const uint32_t bytes = unit_span(t, g, first + k * step, &src, &dst);
    bulk_load(ring0 + k * g.chunk, src, bytes, smem_addr(&full[k]));
  }
  for (long long k = 0; k < count; ++k) {
    const int s = static_cast<int>(k % stages);
    mbar_wait(smem_addr(&full[s]), static_cast<uint32_t>((k / stages) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t bytes = unit_span(t, g, first + k * step, &src, &dst);
    bulk_store(dst, ring0 + s * g.chunk, bytes);
    // Refill the stage of unit k - 1 once its store has read it (every
    // group but the newest, unit k's store, has).
    const long long next = k - 1 + stages;
    if (k >= 1 && next < count) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      const int sp = static_cast<int>((k - 1) % stages);
      const uint32_t nb = unit_span(t, g, first + next * step, &src, &dst);
      bulk_load(ring0 + sp * g.chunk, src, nb, smem_addr(&full[sp]));
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Rows or bases that are not 16-byte aligned: bytes, over the same units.
__global__ void __launch_bounds__(kByteThreads)
    byte_copy_kernel(const __grid_constant__ Table t, const Geometry g) {
  for (long long u = blockIdx.x; u < g.units; u += gridDim.x) {
    const char* src;
    char* dst;
    const uint32_t bytes = unit_span(t, g, u, &src, &dst);
    for (uint32_t j = threadIdx.x; j < bytes; j += kByteThreads)
      dst[j] = src[j];
  }
}

int g_smem_set[64];   // dynamic shared memory enabled per device

}  // namespace

extern "C" {

// One launch on the current device and `stream`. shards: n_shards <=
// kMaxShards base pointers (host array); owner, local, slot: m <= kMaxSlots
// entries each (host arrays),
// owner[j] < n_shards, local[j] < P_loc, slot[j] < n_blk (checked by the
// caller). rows_ls = L * 2. to_pool 0 gathers shard rows into the block, 1
// scatters block rows into the shards. stages, chunk (bytes, a multiple of
// 16) and blocks_per_sm shape the bulk route (stages >= 2: a stage is
// reloaded one unit after its store); sms is the device's SM count.
// Returns cudaGetLastError() of the launch.
int page_dma_launch(const void* const* shards, int n_shards, void* block,
                    const int* owner, const int* local, const int* slot,
                    int m, int n_blk, int rows_ls, int P_loc,
                    long long row_bytes, int to_pool, int stages, int chunk,
                    int blocks_per_sm, int sms, void* stream) {
  if (m == 0 || rows_ls == 0 || row_bytes == 0) return 0;
  if (n_shards < 1 || n_shards > kMaxShards || m > kMaxSlots ||
      n_blk >= (1 << 24) || stages < 2 || stages > kMaxStages ||
      chunk < 16 || (chunk & 15) || blocks_per_sm < 1 || sms < 1)
    return int(cudaErrorInvalidValue);
  Table t;
  bool aligned = (row_bytes & 15) == 0 &&
                 (reinterpret_cast<uintptr_t>(block) & 15) == 0;
  for (int d = 0; d < n_shards; ++d) {
    t.shard[d] = static_cast<char*>(const_cast<void*>(shards[d]));
    aligned = aligned && (reinterpret_cast<uintptr_t>(shards[d]) & 15) == 0;
  }
  for (int j = 0; j < m; ++j) {
    t.local[j] = local[j];
    t.where[j] = owner[j] << 24 | slot[j];
  }
  Geometry g;
  g.block = static_cast<char*>(block);
  g.row_bytes = row_bytes;
  g.m = m;
  g.n_blk = n_blk;
  g.P_loc = P_loc;
  g.to_pool = to_pool;
  g.chunk = chunk;
  g.chunks_per_row = static_cast<int>((row_bytes + chunk - 1) / chunk);
  g.units = static_cast<long long>(rows_ls) * m * g.chunks_per_row;
  const long long cap = static_cast<long long>(blocks_per_sm) * sms;
  const unsigned grid = static_cast<unsigned>(g.units < cap ? g.units : cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!aligned) {
    byte_copy_kernel<<<grid, kByteThreads, 0, s>>>(t, g);
  } else {
    const int smem = stages * chunk;
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return int(cudaErrorInvalidDevice);
    if (g_smem_set[dev] < smem) {
      const cudaError_t e = cudaFuncSetAttribute(
          bulk_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return int(e);
      g_smem_set[dev] = smem;
    }
    bulk_copy_kernel<<<grid, kBulkThreads, smem, s>>>(t, g, stages);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
