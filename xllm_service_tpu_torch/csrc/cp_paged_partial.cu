// Context-parallel paged decode partial for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   xllm_service_tpu/ops/cp_paged_attention.py::_paged_partial_pallas
//   (_paged_partial_impl, body _partial_kernel).
//
// Under a `seq` mesh axis the KV page pool is sharded by page range; each
// shard runs this kernel over ITS pool shard and returns the raw flash
// statistics of one query token per sequence over the pages it owns:
//   m[b, h]      running max of the scaled scores (natural-log units),
//   l[b, h]      sum of exp(s - m),
//   acc[b, h, :] sum of exp(s - m) * v, unnormalised,
// all f32. The log-sum-exp merge across shards runs outside the kernel
// (ops/cp_paged_attention.py::merge_partials), which also floors l.
//
// The table is compacted by the caller (compact_local_table): the row's
// owned, occupied entries come first (n_local[b] of them, as LOCAL page
// indices) and starts[b, j] is entry j's global token start.
//
// What bounds it on this card: reading the shard's owned, occupied K/V
// bytes. At Llama-3-8B decode shapes over four shards (B 8, ctx 1024,
// n_kv 8, hd 128, bf16) a shard reads about a quarter of kernel 1's
// 33.5 MB, so the dependent loads at a block's head and tail weigh more.
//
// The design: kernel 1's split-K walk (split_decode.cuh) with the Partial
// policy. The walk covers compacted slots [0, n_local * ps), read on the
// device, in 16-slot units; slot c sits at position starts[c / ps] + c % ps.
// With pages of 16 tokens or more a unit lies on one entry (one local_pt
// and one starts load); with smaller pages each slot looks its entry up.
// A slot is staged and visible only while its position is below ctx;
// entries past n_local are never loaded. The epilogue writes the raw
// statistics, the splits merged by the ticket as in kernel 1, m converted
// from the walk's log2 units by m * ln 2. The invariants of the TPU kernel
// (cp_paged_attention.py:137-153) hold: V rows at positions >= ctx are zero
// before the product; p is zero on masked scores; a row whose shard owns
// none of its occupied pages returns exactly m = -1e30 (never scaled),
// l = 0, acc = 0, which the merge weighs 0. The TPU's lane-padded
// [B, n_q, 128] statistics are the TPU's shape and are not carried over: m
// and l come out [B, n_q].

#include "split_decode.cuh"

using xllm::split::Args;
using xllm::split::Partial;

extern "C" {

// Query heads per KV head the kernel takes at this head dim and page size
// (0: the shape is not supported).
int cp_paged_partial_max_group(int hd, int ps) {
  return xllm::split::max_group(hd, ps);
}

// dtype: 0 = float32, 1 = bfloat16 (q and the pool shard; the statistics
// are always f32). splits, scratch and tickets as paged_attention_launch.
// Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// shape it does not take.
int cp_paged_partial_launch(const void* q, const void* k_pages,
                            const void* v_pages, const void* local_pt,
                            const void* starts, const void* n_local,
                            const void* context_lens, void* m, void* l,
                            void* acc, void* scratch, void* tickets, int B,
                            int n_q, int n_kv, int hd, int ps, int max_pages,
                            int dtype, int splits, float scale,
                            void* stream) {
  Args a = {};
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.page_table = static_cast<const int*>(local_pt);
  a.context_lens = static_cast<const int*>(context_lens);
  a.out = acc;
  a.scratch = static_cast<float*>(scratch);
  a.tickets = static_cast<unsigned int*>(tickets);
  a.n_q = n_q;
  a.n_kv = n_kv;
  a.ps = ps;
  a.max_pages = max_pages;
  a.scale = scale;
  a.starts = static_cast<const int*>(starts);
  a.n_local = static_cast<const int*>(n_local);
  a.m_out = static_cast<float*>(m);
  a.l_out = static_cast<float*>(l);
  return xllm::split::checked_launch<Partial>(a, B, hd, dtype, splits,
                                              stream);
}

// Blocks of the kernel that one SM holds (negative: a cudaError_t). For the
// run's log.
int cp_paged_partial_blocks_per_sm(int hd, int group, int dtype) {
  return xllm::split::blocks_per_sm<Partial>(hd, group, dtype);
}

}  // extern "C"
