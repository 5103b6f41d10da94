// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   xllm_service_tpu/ops/pallas_paged_attention.py::paged_attention_pallas
//   (_paged_attention_impl, body _kernel).
//
// One query token per sequence attends over that sequence's KV pages,
// located through its page table; context_lens include the new token, whose
// K/V are already written. Inputs bf16 (the serving path) or f32.
//
// What bounds it on this card: reading K/V bytes. At Llama-3-8B decode shapes
// (B 8, ctx 1024, n_kv 8, hd 128, bf16) one call reads
// 8 * 1024 * 8 * 128 * 2 * 2 B = 33.5 MB of K/V, about 10 us at 3.35 TB/s,
// against about 0.13 GFLOP of arithmetic; it runs once per layer per decode
// step (32 launches per step).
//
// What the design does about it: one block per (row, KV head), so the G query
// heads of a GQA group share every K/V page the block loads (each K/V byte is
// read from device memory once per call); the walk covers only the pages
// below ctx (reading the page id from the table in the kernel), 64 tokens of
// pages per step, and rows past ctx inside the last page are never read.
// Known gap, left for later work: at B 8 and n_kv 8 this is 64 blocks on 132
// SMs with few loads in flight each (no split-K over the context, no
// cp.async/TMA ring; holding the next chunk in registers was tried and
// measured no faster, see PERF.md).
//
// Softcap, sliding window and an explicit scale follow the TPU kernel
// (gemma-2 options; the Llama path passes scale = 1/sqrt(hd) and neither of
// the others).

#include "page_walk.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages,
                           const int* __restrict__ page_table,
                           const int* __restrict__ context_lens,
                           T* __restrict__ out, int n_q, int n_kv, int hd,
                           int ps, int max_pages, float scale, float softcap,
                           int window) {
  extern __shared__ __align__(16) char smem[];
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int G = n_q / n_kv;
  const int R = G;  // the GQA group's query heads share every page load
  const xllm::WalkSmem sm = xllm::carve_smem(smem, R, hd);

  const int ctx = context_lens[b];
  const size_t row0 = (size_t(b) * n_q + size_t(kv) * G) * hd;
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x)
    sm.q[i] = xllm::Elt<T>::to_f(q[row0 + i]) * scale;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    sm.m[r] = xllm::kNegInf;
    sm.l[r] = 0.f;
    sm.hi[r] = ctx;
    // The query sits at position ctx - 1: a window keeps keys >= ctx - window.
    sm.lo[r] = window > 0 ? ctx - window : 0;
  }
  __syncthreads();

  float acc[xllm::kMaxAccRows];
#pragma unroll
  for (int i = 0; i < xllm::kMaxAccRows; ++i) acc[i] = 0.f;

  const int p_hi = min((ctx + ps - 1) / ps, max_pages);
  // Pages wholly below ctx - window are never visible: start past them.
  const int p_lo = window > 0 ? max(ctx - window, 0) / ps : 0;
  xllm::page_walk<T>(k_pages, v_pages, page_table + size_t(b) * max_pages,
                     p_lo, p_hi, n_kv, kv, ps, hd, R, ctx, softcap, sm, acc);
#pragma unroll
  for (int i = 0; i < xllm::kMaxAccRows; ++i) {
    const xllm::AccSlot a = xllm::acc_slot(i, hd);
    if (a.row < R)
      out[row0 + size_t(a.row) * hd + a.col] =
          xllm::Elt<T>::from_f(xllm::normalised(acc[i], sm, a.row));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* context_lens, void* out, int B,
           int n_q, int n_kv, int hd, int ps, int max_pages, float scale,
           float softcap, int window, cudaStream_t stream) {
  const int R = n_q / n_kv;
  const size_t smem = xllm::walk_smem_bytes(R, hd);
  static bool attr_set = false;  // raise the dynamic shared-memory cap once
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  dim3 grid(n_kv, B);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(context_lens), static_cast<T*>(out), n_q, n_kv,
      hd, ps, max_pages, scale, softcap, window);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Query heads per KV head the kernel takes at this head dim and page size
// (0: the shape is not supported).
int paged_attention_max_group(int hd, int ps) {
  return xllm::walk_max_rows(kThreads, hd, ps);
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* context_lens, void* out, int B, int n_q,
                           int n_kv, int hd, int ps, int max_pages, int dtype,
                           float scale, float softcap, int window,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table,
                                 context_lens, out, B, n_q, n_kv, hd, ps,
                                 max_pages, scale, softcap, window, s);
  return launch<float>(q, k_pages, v_pages, page_table, context_lens, out, B,
                       n_q, n_kv, hd, ps, max_pages, scale, softcap, window,
                       s);
}

}  // extern "C"
