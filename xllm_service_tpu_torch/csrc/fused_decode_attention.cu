// Fused decode step for Hopper (sm_90a): append the new token's K/V to its
// tail page AND attend, in one launch.
//
// Replaces the TPU kernel
//   xllm_service_tpu/ops/pallas_fused_decode_attention.py::
//     fused_decode_attention_pallas (_fused_impl, body _kernel).
//
// context_lens INCLUDE the new token, whose K/V arrive as operands
// k_new/v_new [B, n_kv, hd] and are not in the pool yet. pos = max(ctx - 1,
// 0) is the new token's position.
//
// What bounds it on this card: reading K/V bytes, as kernel 1. At Llama-3-8B
// decode shapes (B 8, ctx 1024, n_kv 8, hd 128, bf16) one call reads 33.5 MB
// of K/V, about 10 us at 3.35 TB/s; the appended rows add 2 * B * n_kv * hd
// elements (32 KB). What fusing saves is the unfused path's separate write
// of the new rows (several small launches per layer).
//
// The design: kernel 1's split-K walk (split_decode.cuh) with the
// FusedDecode policy. The walk covers the pooled tokens [0, ctx - 1); slot
// pos is never staged (a cp.async of source size 0 reads nothing). The new
// token is one more partial in the final merge, in log2 units: m = q . k_new
// * scale * log2(e), l = 1, acc = v_new; so a row with ctx 0 (an inactive
// slot) outputs v_new, as the reference does. The block that runs the final
// merge (the only one, or the last by the ticket) also writes the new K and
// V rows straight into slot pos % ps of page page_table[b, min(pos / ps,
// max_pages - 1)]: every split's walk has ended by then, and tail pages are
// private to their sequence, so the write races no read. A ctx-0 row writes
// slot 0 of page_table[b, 0], which the engine points at the garbage page
// 0, where concurrent writes are harmless.
//
// The TPU kernel read-modify-writes the whole tail page, because Mosaic
// tiles HBM (8, 128) and cannot DMA one token's row; global memory here is
// byte-addressable, so only the row itself is written.
//
// The scale is fixed at 1/sqrt(hd), with no softcap or window (the engine
// takes this route only then, as the reference does).

#include "split_decode.cuh"

using xllm::split::Args;
using xllm::split::FusedDecode;

extern "C" {

// Query heads per KV head the kernel takes at this head dim and page size
// (0: the shape is not supported).
int fused_decode_attention_max_group(int hd, int ps) {
  return xllm::split::max_group(hd, ps);
}

// dtype: 0 = float32, 1 = bfloat16. splits, scratch and tickets as
// paged_attention_launch. Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a shape it does not take.
int fused_decode_attention_launch(const void* q, const void* k_new,
                                  const void* v_new, void* k_pages,
                                  void* v_pages, const void* page_table,
                                  const void* context_lens, void* out,
                                  void* scratch, void* tickets, int B,
                                  int n_q, int n_kv, int hd, int ps,
                                  int max_pages, int dtype, int splits,
                                  float scale, void* stream) {
  Args a = {};
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.page_table = static_cast<const int*>(page_table);
  a.context_lens = static_cast<const int*>(context_lens);
  a.out = out;
  a.scratch = static_cast<float*>(scratch);
  a.tickets = static_cast<unsigned int*>(tickets);
  a.n_q = n_q;
  a.n_kv = n_kv;
  a.ps = ps;
  a.max_pages = max_pages;
  a.scale = scale;
  a.k_new = k_new;
  a.v_new = v_new;
  return xllm::split::checked_launch<FusedDecode>(a, B, hd, dtype, splits,
                                                  stream);
}

// Blocks of the kernel that one SM holds (negative: a cudaError_t). For the
// run's log.
int fused_decode_attention_blocks_per_sm(int hd, int group, int dtype) {
  return xllm::split::blocks_per_sm<FusedDecode>(hd, group, dtype);
}

}  // extern "C"
