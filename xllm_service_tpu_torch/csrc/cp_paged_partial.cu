// Context-parallel paged decode partial for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   xllm_service_tpu/ops/cp_paged_attention.py::_paged_partial_pallas
//   (_paged_partial_impl, body _partial_kernel).
//
// Under a `seq` mesh axis the KV page pool is sharded by page range; each
// shard runs this kernel over ITS pool shard and returns the raw flash
// statistics of one query token per sequence over the pages it owns:
//   m[b, h]      running max of the scaled scores,
//   l[b, h]      sum of exp(s - m),
//   acc[b, h, :] sum of exp(s - m) * v, unnormalised,
// all f32. The log-sum-exp merge across shards runs outside the kernel
// (ops/cp_paged_attention.py::merge_partials).
//
// The table is compacted by the caller (compact_local_table): the row's
// owned, occupied entries come first (n_local[b] of them, as LOCAL page
// indices) and starts[b, j] is entry j's global token start. Compacted
// pages are not contiguous in position, so the walk takes the CompactedPos
// functor of page_walk.cuh: token t of entry j sits at starts[b, j] +
// t % ps, and entries past n_local sit at ctx (never loaded, fully masked).
//
// The invariants of the TPU kernel (cp_paged_attention.py:137-153) hold:
// entries past n_local are never loaded; V rows at positions >= ctx are
// zero before the product; p is re-zeroed on masked scores; a row whose
// shard owns none of its occupied pages returns m = NEG_INF, l = 0,
// acc = 0, which the merge weights 0. The TPU's lane-padded [B, n_q, 128]
// statistics and its 2-slot VMEM DMA ring are the TPU's shape and are not
// carried over: m and l come out [B, n_q].
//
// What bounds it on this card: reading the shard's owned, occupied K/V
// bytes. At Llama-3-8B decode shapes over four shards (B 8, ctx 1024,
// n_kv 8, hd 128, bf16) a shard reads about a quarter of kernel 1's
// 33.5 MB.
//
// What the design does about it: kernel 1's (paged_attention.cu) design:
// one block per (row, KV head), so the G query heads of a GQA group share
// every K/V page the block loads, and the walk covers only the n_local
// owned entries. The same known gap as kernel 1 (64 blocks on 132 SMs, no
// split-K, no cp.async/TMA ring) is left for later work.

#include "page_walk.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cp_paged_partial_kernel(const T* __restrict__ q,
                            const T* __restrict__ k_pages,
                            const T* __restrict__ v_pages,
                            const int* __restrict__ local_pt,
                            const int* __restrict__ starts,
                            const int* __restrict__ n_local,
                            const int* __restrict__ context_lens,
                            float* __restrict__ m_out,
                            float* __restrict__ l_out,
                            float* __restrict__ acc_out, int n_q, int n_kv,
                            int hd, int ps, int max_pages, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int G = n_q / n_kv;
  const int R = G;  // the GQA group's query heads share every page load
  const xllm::WalkSmem sm = xllm::carve_smem(smem, R, hd);

  const int ctx = context_lens[b];
  const int n_pages = min(max(n_local[b], 0), max_pages);
  const size_t head0 = size_t(b) * n_q + size_t(kv) * G;
  const size_t row0 = head0 * hd;
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x)
    sm.q[i] = xllm::Elt<T>::to_f(q[row0 + i]) * scale;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    sm.m[r] = xllm::kNegInf;
    sm.l[r] = 0.f;
    sm.hi[r] = ctx;
    sm.lo[r] = 0;
  }
  __syncthreads();

  float acc[xllm::kMaxAccRows];
#pragma unroll
  for (int i = 0; i < xllm::kMaxAccRows; ++i) acc[i] = 0.f;

  const size_t pt0 = size_t(b) * max_pages;
  const xllm::CompactedPos pos_of{starts + pt0, n_pages, ps, ctx};
  xllm::page_walk<T>(k_pages, v_pages, local_pt + pt0, 0, n_pages, n_kv, kv,
                     ps, hd, R, ctx, 0.f, sm, acc, pos_of);
  // page_walk ends synchronised (or never ran): sm.m / sm.l are final.
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m_out[head0 + r] = sm.m[r];
    l_out[head0 + r] = sm.l[r];
  }
#pragma unroll
  for (int i = 0; i < xllm::kMaxAccRows; ++i) {
    const xllm::AccSlot a = xllm::acc_slot(i, hd);
    if (a.row < R) acc_out[row0 + size_t(a.row) * hd + a.col] = acc[i];
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* local_pt, const void* starts, const void* n_local,
           const void* context_lens, void* m, void* l, void* acc, int B,
           int n_q, int n_kv, int hd, int ps, int max_pages, float scale,
           cudaStream_t stream) {
  const int R = n_q / n_kv;
  const size_t smem = xllm::walk_smem_bytes(R, hd);
  static bool attr_set = false;  // raise the dynamic shared-memory cap once
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        cp_paged_partial_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  dim3 grid(n_kv, B);
  cp_paged_partial_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(local_pt),
      static_cast<const int*>(starts), static_cast<const int*>(n_local),
      static_cast<const int*>(context_lens), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(acc), n_q, n_kv, hd, ps,
      max_pages, scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Query heads per KV head the kernel takes at this head dim and page size
// (0: the shape is not supported).
int cp_paged_partial_max_group(int hd, int ps) {
  return xllm::walk_max_rows(kThreads, hd, ps);
}

// dtype: 0 = float32, 1 = bfloat16 (q and the pool shard; the statistics
// are always f32). Returns cudaGetLastError() of the launch.
int cp_paged_partial_launch(const void* q, const void* k_pages,
                            const void* v_pages, const void* local_pt,
                            const void* starts, const void* n_local,
                            const void* context_lens, void* m, void* l,
                            void* acc, int B, int n_q, int n_kv, int hd,
                            int ps, int max_pages, int dtype, float scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, local_pt, starts,
                                 n_local, context_lens, m, l, acc, B, n_q,
                                 n_kv, hd, ps, max_pages, scale, s);
  return launch<float>(q, k_pages, v_pages, local_pt, starts, n_local,
                       context_lens, m, l, acc, B, n_q, n_kv, hd, ps,
                       max_pages, scale, s);
}

}  // extern "C"
