// Causal multi-query paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   xllm_service_tpu/ops/pallas_mq_paged_attention.py::mq_paged_attention_pallas
//   (_mq_impl, body _kernel).
//
// A block of Sq queries per sequence attends against that sequence's pages,
// which already hold prefix + block K/V (write_prefill_kv runs first). Query
// s sits at absolute position prefix + s and sees keys at positions
// <= prefix + s. Query rows s >= block_lens[b] are padding and come out zero.
// In the port this kernel carries every prefill against a cached prefix.
//
// What bounds it on this card: at serving shapes (one sequence, a 512-token
// suffix behind a 512-token prefix, 32/8 heads, hd 128, bf16) the causal
// score and value products are about 6.4 GFLOP against about 12.6 MB of q,
// K/V and output, so the bound is the arithmetic at the bf16 tensor-core rate
// (~6.5 us); this first version computes in f32 on the CUDA cores.
//
// What the design does about it: blocks over (query tile, KV head, row), so
// any suffix length fits (the TPU route capped S * n_heads at 4096 for its
// scratch memory; here a tile of queries times the GQA group, at most 32
// rows, shares each K/V page load) and the grid fills the card at long
// suffixes. Each tile walks only the pages its last valid query can see.
// Tensor-core products (wgmma) and a TMA ring are left for later work.

#include "page_walk.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mq_paged_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ page_table,
                              const int* __restrict__ prefix_lens,
                              const int* __restrict__ block_lens,
                              T* __restrict__ out, int s_q, int n_q, int n_kv,
                              int hd, int ps, int max_pages, int q_tile,
                              float scale) {
  extern __shared__ __align__(16) char smem[];
  const int tile = blockIdx.x;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int G = n_q / n_kv;
  const int R = q_tile * G;  // rows ordered (query in tile, group head)
  const int s0 = tile * q_tile;
  const xllm::WalkSmem sm = xllm::carve_smem(smem, R, hd);

  const int prefix = prefix_lens[b];
  const int blk = min(block_lens[b], s_q);
  const int ctx = prefix + blk;
  const size_t q_stride = size_t(n_q) * hd;  // one query position
  const size_t row0 = (size_t(b) * s_q + s0) * q_stride + size_t(kv) * G * hd;

  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int sl = r / G;
    const int g = r - sl * G;
    sm.q[i] = s0 + sl < s_q
                  ? xllm::Elt<T>::to_f(q[row0 + sl * q_stride + g * hd + d]) *
                        scale
                  : 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int s = s0 + r / G;
    sm.m[r] = xllm::kNegInf;
    sm.l[r] = 0.f;
    sm.hi[r] = s < blk ? prefix + s + 1 : 0;
    sm.lo[r] = 0;
  }
  __syncthreads();

  float acc[xllm::kMaxAccRows];
#pragma unroll
  for (int i = 0; i < xllm::kMaxAccRows; ++i) acc[i] = 0.f;

  // The tile's last valid query bounds the pages it needs.
  const int s_end = min(s0 + q_tile, blk);
  const int p_hi =
      s_end > s0 ? min((prefix + s_end + ps - 1) / ps, max_pages) : 0;
  xllm::page_walk<T>(k_pages, v_pages, page_table + size_t(b) * max_pages, 0,
                     p_hi, n_kv, kv, ps, hd, R, ctx, 0.f, sm, acc);
#pragma unroll
  for (int i = 0; i < xllm::kMaxAccRows; ++i) {
    const xllm::AccSlot a = xllm::acc_slot(i, hd);
    const int sl = a.row / G;
    if (a.row < R && s0 + sl < s_q)
      out[row0 + sl * q_stride + size_t(a.row - sl * G) * hd + a.col] =
          xllm::Elt<T>::from_f(xllm::normalised(acc[i], sm, a.row));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* prefix_lens,
           const void* block_lens, void* out, int B, int s_q, int n_q,
           int n_kv, int hd, int ps, int max_pages, int q_tile, float scale,
           cudaStream_t stream) {
  const int R = q_tile * (n_q / n_kv);
  const size_t smem = xllm::walk_smem_bytes(R, hd);
  static bool attr_set = false;  // raise the dynamic shared-memory cap once
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        mq_paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  dim3 grid((s_q + q_tile - 1) / q_tile, n_kv, B);
  mq_paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(prefix_lens),
      static_cast<const int*>(block_lens), static_cast<T*>(out), s_q, n_q,
      n_kv, hd, ps, max_pages, q_tile, scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows (queries in a tile x GQA group) one block takes at this head dim and
// page size (0: the shape is not supported).
int mq_paged_attention_max_rows(int hd, int ps) {
  return xllm::walk_max_rows(kThreads, hd, ps);
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
int mq_paged_attention_launch(const void* q, const void* k_pages,
                              const void* v_pages, const void* page_table,
                              const void* prefix_lens, const void* block_lens,
                              void* out, int B, int s_q, int n_q, int n_kv,
                              int hd, int ps, int max_pages, int q_tile,
                              int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, prefix_lens,
                                 block_lens, out, B, s_q, n_q, n_kv, hd, ps,
                                 max_pages, q_tile, scale, s);
  return launch<float>(q, k_pages, v_pages, page_table, prefix_lens,
                       block_lens, out, B, s_q, n_q, n_kv, hd, ps, max_pages,
                       q_tile, scale, s);
}

}  // extern "C"
