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
// What bounds it on this card, and the design: the split-K walk of
// split_decode.cuh with its Decode policy (slot c holds position c, the walk
// covers [0, ctx), the output is normalised). At Llama-3-8B decode shapes
// (B 8, ctx 1024, n_kv 8, hd 128, bf16) one call reads 33.5 MB of K/V,
// about 10 us at 3.35 TB/s; it runs once per layer per decode step (32
// launches per step).
//
// l is floored at 1e-9 (a row with ctx == 0 writes zeros), and a window
// starts the walk at the unit that holds position ctx - window. Softcap,
// sliding window and an explicit scale follow the TPU kernel (gemma-2
// options; the Llama path passes scale = 1/sqrt(hd) and neither of the
// others).

#include "split_decode.cuh"

using xllm::split::Args;
using xllm::split::Decode;

extern "C" {

// Query heads per KV head the kernel takes at this head dim and page size
// (0: the shape is not supported): head dim 32, 64 or 128, page size a power
// of two up to 64.
int paged_attention_max_group(int hd, int ps) {
  return xllm::split::max_group(hd, ps);
}

// dtype: 0 = float32, 1 = bfloat16. splits >= 1 blocks per (row, KV head);
// with splits > 1, scratch holds B * n_q * splits * (hd + 2) floats and
// tickets B * n_kv zeroed counters (the kernel leaves them zero). Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a shape it
// does not take.
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* context_lens, void* out, void* scratch,
                           void* tickets, int B, int n_q, int n_kv, int hd,
                           int ps, int max_pages, int dtype, int splits,
                           float scale, float softcap, int window,
                           void* stream) {
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
  a.softcap = softcap;
  a.window = window;
  return xllm::split::checked_launch<Decode>(a, B, hd, dtype, splits, stream);
}

// Blocks of the kernel for this head dim, GQA group and dtype that one SM
// holds, by the occupancy calculator; negative: a cudaError_t. For the run's
// log.
int paged_attention_blocks_per_sm(int hd, int group, int dtype) {
  return xllm::split::blocks_per_sm<Decode>(hd, group, dtype);
}

}  // extern "C"
