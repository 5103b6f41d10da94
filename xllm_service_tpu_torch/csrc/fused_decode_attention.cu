// Fused decode step for Hopper (sm_90a): append the new token's K/V to its
// tail page AND attend, in one kernel.
//
// Replaces the TPU kernel
//   xllm_service_tpu/ops/pallas_fused_decode_attention.py::
//     fused_decode_attention_pallas (_fused_impl, body _kernel).
//
// context_lens INCLUDE the new token, whose K/V arrive as operands
// k_new/v_new [B, n_kv, hd] and are not in the pool yet. pos = max(ctx - 1,
// 0) is the new token's position. The block walks the pooled tokens
// [0, ctx - 1) through the shared page walk of kernel 1 (page_walk.cuh),
// merges the new token's score and value from the operands into the online
// softmax at the end, and writes the new K and V rows straight into slot
// pos % ps of page page_table[b, min(pos / ps, max_pages - 1)].
//
// The TPU kernel read-modify-writes the whole tail page, because Mosaic
// tiles HBM (8, 128) and cannot DMA one token's row; global memory here is
// byte-addressable, so only the row itself is written.
//
// Why the write cannot race the reads: the walk never reads position pos
// (its bound is ctx - 1), and block (b, kv) is the only writer of head kv's
// row in that page. Tail pages are private to their sequence (the page
// manager donates only whole hash blocks of whole pages), so no other
// row's walk reads the slot either. A row with ctx 0 (an inactive slot)
// walks nothing, attends only the new token (its output is v_new) and
// writes slot 0 of page_table[b, 0], which the engine points at the garbage
// page 0, where concurrent writes are harmless.
//
// What bounds it on this card: reading K/V bytes, as kernel 1. At Llama-3-8B
// decode shapes (B 8, ctx 1024, n_kv 8, hd 128, bf16) one call reads 33.5 MB
// of K/V, about 10 us at 3.35 TB/s; the appended rows add 2 * B * n_kv * hd
// elements (32 KB). What fusing saves is the unfused path's separate write
// of the new rows (a scatter of several small launches per layer).
//
// The scale is fixed at 1/sqrt(hd), with no softcap or window (the engine
// takes this route only then, as the reference does). The pallas_page_dma
// invariants hold: V rows past the bound are zero in shared memory, p is
// re-zeroed on masked scores, l is clamped at 1e-9.

#include "page_walk.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, T* k_pages, T* v_pages,
                        const int* __restrict__ page_table,
                        const int* __restrict__ context_lens,
                        T* __restrict__ out, int n_q, int n_kv, int hd,
                        int ps, int max_pages, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int G = n_q / n_kv;
  const int R = G;  // the GQA group's query heads share every page load
  const xllm::WalkSmem sm = xllm::carve_smem(smem, R, hd);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  const int ctx = context_lens[b];
  const int pos = max(ctx - 1, 0);  // the new token's position
  const int ctx_prev = pos;         // tokens already in the pool
  const size_t row0 = (size_t(b) * n_q + size_t(kv) * G) * hd;
  const size_t new0 = (size_t(b) * n_kv + kv) * hd;
  for (int i = tid; i < R * hd; i += blockDim.x)
    sm.q[i] = xllm::Elt<T>::to_f(q[row0 + i]) * scale;
  for (int r = tid; r < R; r += blockDim.x) {
    sm.m[r] = xllm::kNegInf;
    sm.l[r] = 0.f;
    sm.hi[r] = ctx_prev;
    sm.lo[r] = 0;
  }
  __syncthreads();

  float acc[xllm::kMaxAccRows];
#pragma unroll
  for (int i = 0; i < xllm::kMaxAccRows; ++i) acc[i] = 0.f;

  const int p_hi = min((ctx_prev + ps - 1) / ps, max_pages);
  xllm::page_walk<T>(k_pages, v_pages, page_table + size_t(b) * max_pages, 0,
                     p_hi, n_kv, kv, ps, hd, R, ctx_prev, 0.f, sm, acc);

  // Merge the new token (always visible: position ctx - 1 < ctx), one warp
  // per row: its score, then flash_accumulate's update of m and l.
  for (int r = warp; r < R; r += n_warps) {
    float x = 0.f;
    for (int d = lane; d < hd; d += 32)
      x = fmaf(sm.q[r * hd + d], xllm::Elt<T>::to_f(k_new[new0 + d]), x);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) {
      const float m_prev = sm.m[r];
      const float m_new = fmaxf(m_prev, x);
      const float a = expf(m_prev - m_new);
      const float p = x <= 0.5f * xllm::kNegInf ? 0.f : expf(x - m_new);
      sm.l[r] = sm.l[r] * a + p;
      sm.m[r] = m_new;
      sm.alpha[r] = a;
      sm.s[r * xllm::kChunkTokens] = p;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < xllm::kMaxAccRows; ++i) {
    const xllm::AccSlot a = xllm::acc_slot(i, hd);
    if (a.row < R) {
      const float vn = xllm::Elt<T>::to_f(v_new[new0 + a.col]);
      const float y = fmaf(sm.s[a.row * xllm::kChunkTokens], vn,
                           acc[i] * sm.alpha[a.row]);
      out[row0 + size_t(a.row) * hd + a.col] =
          xllm::Elt<T>::from_f(xllm::normalised(y, sm, a.row));
    }
  }

  // The append: head kv's row of the new token, in place.
  const int wpage =
      page_table[size_t(b) * max_pages + min(pos / ps, max_pages - 1)];
  const size_t dst = ((size_t(wpage) * n_kv + kv) * ps + pos % ps) * hd;
  for (int d = tid; d < hd; d += blockDim.x) {
    k_pages[dst + d] = k_new[new0 + d];
    v_pages[dst + d] = v_new[new0 + d];
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pages,
           void* v_pages, const void* page_table, const void* context_lens,
           void* out, int B, int n_q, int n_kv, int hd, int ps, int max_pages,
           float scale, cudaStream_t stream) {
  const int R = n_q / n_kv;
  const size_t smem = xllm::walk_smem_bytes(R, hd);
  static bool attr_set = false;  // raise the dynamic shared-memory cap once
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  dim3 grid(n_kv, B);
  fused_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_pages),
      static_cast<T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(context_lens), static_cast<T*>(out), n_q, n_kv,
      hd, ps, max_pages, scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Query heads per KV head the kernel takes at this head dim and page size
// (0: the shape is not supported).
int fused_decode_attention_max_group(int hd, int ps) {
  return xllm::walk_max_rows(kThreads, hd, ps);
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of the launch.
int fused_decode_attention_launch(const void* q, const void* k_new,
                                  const void* v_new, void* k_pages,
                                  void* v_pages, const void* page_table,
                                  const void* context_lens, void* out, int B,
                                  int n_q, int n_kv, int hd, int ps,
                                  int max_pages, int dtype, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_pages, v_pages,
                                 page_table, context_lens, out, B, n_q, n_kv,
                                 hd, ps, max_pages, scale, s);
  return launch<float>(q, k_new, v_new, k_pages, v_pages, page_table,
                       context_lens, out, B, n_q, n_kv, hd, ps, max_pages,
                       scale, s);
}

}  // extern "C"
