// Kernel 1's two bf16 routes at head dim 256, one beside the other, for
// benchmarks/hd256_routes.py: the tensor-core kernel that the dispatch of
// split_decode.cuh takes (route 0) and the CUDA-core kernel in f32 that it
// could take instead (route 1). The serving path never loads this library;
// it exists to time the choice the dispatch makes.

#include "split_decode.cuh"

using xllm::split::Args;
using xllm::split::Decode;

namespace {

int route_launch(const Args& a, int B, int splits, int route,
                 cudaStream_t stream) {
  if (route == 0)
    return xllm::split::launch_mma<Decode, 256>(a, B, splits, stream);
  if (route == 1)
    return xllm::split::launch_fma_group<Decode, __nv_bfloat16, 256>(
        a, B, splits, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// paged_attention_launch's operands at head dim 256 in bf16, and the route.
int split_routes_launch(const void* q, const void* k_pages,
                        const void* v_pages, const void* page_table,
                        const void* context_lens, void* out, void* scratch,
                        void* tickets, int B, int n_q, int n_kv, int ps,
                        int max_pages, int splits, float scale, float softcap,
                        int window, int route, void* stream) {
  const int G = n_kv > 0 ? n_q / n_kv : 0;
  if (G < 1 || G > xllm::split::max_group(256, ps) || splits < 1)
    return int(cudaErrorInvalidValue);
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
  return route_launch(a, B, splits, route, static_cast<cudaStream_t>(stream));
}

// Blocks of the route's kernel at this GQA group that one SM holds, by the
// occupancy calculator; negative: a cudaError_t.
int split_routes_blocks_per_sm(int group, int route) {
  if (group < 1 || group > xllm::split::max_group(256, 16))
    return -int(cudaErrorInvalidValue);
  Args a = {};
  a.n_q = group;
  a.n_kv = 1;
  return -route_launch(a, 1, 0, route, nullptr);
}

}  // extern "C"
