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
// (~6.5 us).
//
// What the design does about it, for bf16 (mq_wgmma_kernel):
// - Both products run on the tensor cores through wgmma.mma_async
//   (wgmma_bf16.cuh), bf16 inputs and f32 accumulators: a warpgroup owns 64
//   rows of (query, GQA head), a block two warpgroups on one KV head, so the
//   group's heads and a tile of 32 queries share every K/V byte staged. The
//   tensor cores read K and V from shared memory themselves, once per
//   warpgroup. (A first version with mma.sync fed by ldmatrix, a warp per 16
//   rows, read each chunk once per warp and ran slower; PERF.md has both.)
// - K/V stay bf16 in shared memory (16 KB + 16 KB per 64-token chunk),
//   staged by 16-byte cp.async into a ring of four chunks in the 128-byte
//   swizzle wgmma reads, the loads of chunk c + 2 in flight while chunk c is
//   multiplied. K feeds the score product as stored (K-major); V feeds the
//   value product as stored too, as a transposed (MN-major) operand.
// - The softmax never leaves registers: scores arrive in the accumulator
//   layout, the row maximum and sum are reduced with shuffles among the four
//   lanes of a row, one multiply-add and one ex2 per score on scores scaled
//   by scale * log2(e), and P, rounded to bf16, is already the A operand of
//   P V. The loop is software-pipelined: the value product of chunk c - 1
//   and the scores of chunk c + 1 are on the tensor cores while the softmax
//   of chunk c runs on the CUDA cores, and with two warpgroups one group's
//   products also run under the other's softmax.
// - Only chunks that cross a warp's causal diagonal (or hold a padding
//   query) are masked; chunks wholly below it take no mask and no bound
//   check, and a tile walks only the chunks its last valid query can see.
//   Tiles with the most chunks are scheduled first.
// - The invariants of page_walk.cuh, restated for tensor cores (0 x NaN is
//   NaN inside a product): K/V at positions >= prefix + block are zero in
//   shared memory (a cp.async of source size 0), the mask is a select on the
//   score, p is zero where the score is the sentinel, l is floored at 1e-9,
//   and padding queries and rows with no visible key write zeros.
//
// f32 inputs keep full f32 arithmetic on the CUDA cores: they take the shared
// walk of page_walk.cuh (mq_walk_kernel), as does a bf16 call whose head dim
// or GQA group the tensor-core path does not take (a head dim other than 64
// or 128, a group that does not divide 64). The wrapper picks the route from
// mq_paged_attention_mma_rows and says so in its docstring.

#include "kv_ring.cuh"
#include "mma_bf16.cuh"
#include "page_walk.cuh"
#include "wgmma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kChunk = 64;  // keys per ring stage

// ------------------------------------------------------------------ the walk
// f32 (and bf16 shapes the tensor-core kernel does not take): f32 arithmetic
// on the CUDA cores over the shared walk.

constexpr int kWalkThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kWalkThreads)
    mq_walk_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int* __restrict__ page_table,
                   const int* __restrict__ prefix_lens,
                   const int* __restrict__ block_lens, T* __restrict__ out,
                   int s_q, int n_q, int n_kv, int hd, int ps, int max_pages,
                   int q_tile, float scale) {
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
  }
  __syncthreads();

  float acc[xllm::kMaxAccRows];
#pragma unroll
  for (int i = 0; i < xllm::kMaxAccRows; ++i) acc[i] = 0.f;

  // The tile's last valid query bounds the pages it needs.
  const int s_end = min(s0 + q_tile, blk);
  const int p_hi =
      s_end > s0 ? min((prefix + s_end + ps - 1) / ps, max_pages) : 0;
  xllm::page_walk<T>(k_pages, v_pages, page_table + size_t(b) * max_pages,
                     p_hi, n_kv, kv, ps, hd, R, ctx, sm, acc);
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
int launch_walk(const void* q, const void* k_pages, const void* v_pages,
                const void* page_table, const void* prefix_lens,
                const void* block_lens, void* out, int B, int s_q, int n_q,
                int n_kv, int hd, int ps, int max_pages, int q_tile,
                float scale, cudaStream_t stream) {
  const int R = q_tile * (n_q / n_kv);
  const size_t smem = xllm::walk_smem_bytes(R, hd);
  static bool attr_set = false;  // raise the dynamic shared-memory cap once
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        mq_walk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (e != cudaSuccess) return int(e);
    attr_set = true;
  }
  dim3 grid((s_q + q_tile - 1) / q_tile, n_kv, B);
  mq_walk_kernel<T><<<grid, kWalkThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(prefix_lens),
      static_cast<const int*>(block_lens), static_cast<T*>(out), s_q, n_q,
      n_kv, hd, ps, max_pages, q_tile, scale);
  return int(cudaGetLastError());
}

// ------------------------------------------------------- the tensor-core path
// bf16: both products started by the whole warpgroup (wgmma_bf16.cuh). A stage
// holds K and V each as HD / 64 tiles of 64 keys x 64 columns (128-byte rows,
// 128-byte swizzle).

// Stage one 64-key chunk in the wgmma layout. Keys at or past ctx, or past
// the table, are zero-filled.
template <int HD, int NT>
__device__ __forceinline__ void stage_chunk_sw128(
    uint32_t stage, const bf16* __restrict__ k_pages,
    const bf16* __restrict__ v_pages, const int* __restrict__ pt_row,
    int start, int ctx, int n_kv, int kv, int ps, int ps_shift,
    int max_pages) {
  constexpr int kPieces = HD * 2 / 16;
  constexpr int kVBase = kChunk * HD * 2;
#pragma unroll
  for (int i = threadIdx.x; i < kChunk * kPieces; i += NT) {
    const int t = i / kPieces;
    const int c = i % kPieces;
    const int pos = start + t;
    const int page = pos >> ps_shift;
    const bool live = pos < ctx && page < max_pages;
    size_t off = 0;
    if (live)
      off = ((size_t(pt_row[page]) * n_kv + kv) * ps + (pos & (ps - 1))) * HD +
            c * 8;
    // Tile c / 8 (64 columns), row t, piece c % 8 swizzled with the row.
    const uint32_t dst = stage + (c >> 3) * (kChunk * 128) + t * 128 +
                         (((c & 7) ^ (t & 7)) << 4);
    xllm::cp_async_16(dst, k_pages + off, live);
    xllm::cp_async_16(dst + kVBase, v_pages + off, live);
  }
}

// 2^x by the special-function unit alone (ex2.approx: 2 ulp, tiny results
// flushed to zero), where exp2f spends further instructions on range
// handling; the result is rounded to bf16 or summed in f32 next.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One block: NWG warpgroups of 64 rows of (query, GQA head) each, on one KV
// head, sharing every staged chunk; the loop over chunks is software-
// pipelined per warpgroup (see step below).
template <int HD, int NWG, int STAGES>
__global__ void __launch_bounds__(NWG * 128)
    mq_wgmma_kernel(const bf16* __restrict__ q,
                    const bf16* __restrict__ k_pages,
                    const bf16* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ prefix_lens,
                    const int* __restrict__ block_lens, bf16* __restrict__ out,
                    int s_q, int n_q, int n_kv, int ps, int max_pages,
                    float scale_log2e) {
  static_assert(STAGES >= 4, "chunks c - 1 (V), c, c + 1 (K), one in flight");
  constexpr int NT = NWG * 128;
  constexpr int ROWS = NWG * 64;
  constexpr int kTileBytes = kChunk * 128;          // 64 keys x 64 columns
  constexpr int kStageBytes = 2 * kChunk * HD * 2;  // K tiles, then V tiles
  constexpr int KS = HD / 16;     // k-steps of the score product
  constexpr int NJ = kChunk / 8;  // 8-key tiles of a chunk
  constexpr int ND = HD / 8;      // 8-column tiles of the output
  extern __shared__ __align__(16) char smem[];
  // The swizzle is a function of the address: tiles start 1024-byte aligned.
  const uint32_t ring = (xllm::smem_u32(smem) + 1023u) & ~1023u;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;  // within the block; 4 per warpgroup
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // The tiles that see the most keys first.
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int G = n_q / n_kv;
  const int q_tile = ROWS / G;
  const int s0 = tile * q_tile;
  const int ps_shift = __ffs(ps) - 1;

  const int prefix = prefix_lens[b];
  const int blk = min(block_lens[b], s_q);
  const int ctx = prefix + blk;
  const int* pt_row = page_table + size_t(b) * max_pages;

  // The tile's last valid query bounds the chunks it walks.
  const int s_end = min(s0 + q_tile, blk);
  const int n_tok = s_end > s0 ? min(prefix + s_end, max_pages * ps) : 0;
  const int n_chunks = (n_tok + kChunk - 1) / kChunk;

  if (n_chunks == 0) {  // the whole block: a tile of padding queries
    for (int i = threadIdx.x; i < ROWS * (HD / 2); i += NT) {
      const int r = i / (HD / 2);
      const int s = s0 + r / G;
      if (s < s_q)
        reinterpret_cast<uint32_t*>(
            out + (size_t(b) * s_q + s) * n_q * HD +
            (size_t(kv) * G + r % G) * HD)[i % (HD / 2)] = 0u;
    }
    return;
  }

  auto stage = [&](int c) {  // chunk c into its stage, as one cp.async group
    if (c < n_chunks)
      stage_chunk_sw128<HD, NT>(ring + (c % STAGES) * kStageBytes, k_pages,
                                v_pages, pt_row, c * kChunk, ctx, n_kv, kv, ps,
                                ps_shift, max_pages);
    xllm::cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < STAGES - 2; ++c) stage(c);

  // This thread's two rows (g and g + 8 of the warp's 16) and their queries.
  const int r_a = warp * 16 + g;
  const int r_b = r_a + 8;
  const int s_a = s0 + r_a / G;
  const int s_b = s0 + r_b / G;
  const size_t q_pos = size_t(n_q) * HD;  // one query position
  const size_t base = size_t(b) * s_q * q_pos + size_t(kv) * G * HD;
  const size_t off_a = base + size_t(s_a) * q_pos + size_t(r_a % G) * HD;
  const size_t off_b = base + size_t(s_b) * q_pos + size_t(r_b % G) * HD;
  // Keys row a / b sees: positions below hi (0: a padding query).
  const int hi_a = s_a < blk ? prefix + s_a + 1 : 0;
  const int hi_b = s_b < blk ? prefix + s_b + 1 : 0;

  // Q as A fragments, straight from device memory (read once per block).
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int d = ks * 16 + 2 * t4;
    qf[ks][0] = qf[ks][1] = qf[ks][2] = qf[ks][3] = 0u;
    if (s_a < s_q) {
      qf[ks][0] = *reinterpret_cast<const uint32_t*>(q + off_a + d);
      qf[ks][2] = *reinterpret_cast<const uint32_t*>(q + off_a + d + 8);
    }
    if (s_b < s_q) {
      qf[ks][1] = *reinterpret_cast<const uint32_t*>(q + off_b + d);
      qf[ks][3] = *reinterpret_cast<const uint32_t*>(q + off_b + d + 8);
    }
  }

  // What the warp sees decides whether a chunk needs a mask.
  const int sw_lo = s0 + (warp * 16) / G;
  const int sw_hi = s0 + (warp * 16 + 15) / G;
  const bool warp_full = sw_hi < blk;          // no padding query
  const int clear_below = prefix + sw_lo + 1;  // every row sees keys below

  float o[ND * 4];
#pragma unroll
  for (int j = 0; j < ND * 4; ++j) o[j] = 0.f;
  // What the output is rescaled by before the next value product.
  float al_a = 1.f, al_b = 1.f;
  // Running maxima in raw score units, denominators per lane.
  float m_a = xllm::kNegInf, m_b = xllm::kNegInf;
  float l_a = 0.f, l_b = 0.f;

  // S = Q K^T of chunk c for 64 rows x 64 keys, started, not committed: k-step
  // ks covers columns [16 ks, 16 ks + 16) of the head dim, 32 bytes inside
  // tile ks / 4 of the stage. A chunk past the tile's end (the odd count's
  // last step) takes the last real chunk's K: finite, and masked whole.
  auto start_scores = [&](float(&s)[NJ * 4], int c) {
    const uint32_t k_tiles =
        ring + (min(c, n_chunks - 1) % STAGES) * kStageBytes;
    xllm::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      xllm::wgmma_m64n64k16<0>(
          s, qf[ks],
          xllm::wgmma_desc_sw128(
              k_tiles + (ks >> 2) * kTileBytes + (ks & 3) * 32, 16, 1024),
          ks > 0);
  };

  // O = O * alpha + P V of chunk c, P rounded to bf16 in registers as the A
  // operand: k-step kk covers keys [16 kk, 16 kk + 16), two 8-row atoms 1024
  // bytes apart, and the HD / 64 column tiles lie kTileBytes apart. The
  // rescale runs while nothing is in flight; the products are started, not
  // committed.
  auto start_values = [&](const uint32_t(&pa)[kChunk / 16][4], int c) {
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[4 * j] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }
    // Chunk -1 (the first step) multiplies a zero P, and a chunk past the
    // tile's end a P masked to zero, against a real chunk's finite V.
    const uint32_t v_tiles = ring +
                             (min(max(c, 0), n_chunks - 1) % STAGES) *
                                 kStageBytes +
                             kChunk * HD * 2;
    // The rescale above is complete before the fence: no ordinary
    // instruction may write an accumulator once the stage has begun.
    xllm::wgmma_pin(o);
    xllm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const uint64_t desc =
          xllm::wgmma_desc_sw128(v_tiles + kk * 16 * 128, kTileBytes, 1024);
      if constexpr (HD == 128)
        xllm::wgmma_m64n128k16<1>(o, pa[kk], desc, 1);
      else
        xllm::wgmma_m64n64k16<1>(o, pa[kk], desc, 1);
    }
  };

  // One step of the pipeline. On entry the scores of chunk c are in flight
  // into s_cur and the value product of chunk c - 2 into o. The step starts
  // the value product of chunk c - 1 (from pa_prev) and the scores of chunk
  // c + 1 (into s_next) as one group, and under them runs the softmax of
  // chunk c on the CUDA cores (into pa_cur): between their start and the next
  // wait no ordinary instruction touches an accumulator of that group.
  auto step = [&](float(&s_cur)[NJ * 4], float(&s_next)[NJ * 4],
                  uint32_t(&pa_cur)[kChunk / 16][4],
                  uint32_t(&pa_prev)[kChunk / 16][4], int c) {
    xllm::wgmma_wait<0>();
    xllm::wgmma_pin(s_cur);
    xllm::wgmma_pin(o);
    xllm::wgmma_pin(pa_cur);  // read by the value product of chunk c - 2
    // Chunk c + 1 has landed; make it visible to the tensor cores. One
    // barrier per chunk: behind it every warpgroup is done with chunk c - 2,
    // whose stage the next load takes.
    xllm::cp_async_wait<STAGES - 4>();
    xllm::fence_proxy_async();
    __syncthreads();
    stage(c + STAGES - 2);
    start_values(pa_prev, c - 1);
    start_scores(s_next, c + 1);
    xllm::wgmma_commit();

    // Softmax of chunk c, reading the scores where the tensor cores left
    // them and writing only P: no accumulator is written between the start
    // above and the next wait. The mask (where the chunk crosses the
    // diagonal, the context bound or a padding query) is a select on the
    // score, never arithmetic.
    const int start = c * kChunk;
    const bool masked = !(warp_full && start + kChunk <= clear_below);
    auto score = [&](int j, int i) {
      const int pos = start + 8 * j + 2 * t4 + (i & 1);
      return masked && pos >= (i < 2 ? hi_a : hi_b) ? xllm::kNegInf
                                                    : s_cur[4 * j + i];
    };
    float mx_a = xllm::kNegInf, mx_b = xllm::kNegInf;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(score(j, 0), score(j, 1)));
      mx_b = fmaxf(mx_b, fmaxf(score(j, 2), score(j, 3)));
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, w));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, w));
    }
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    // What the output is rescaled by before this chunk's value product.
    al_a = fast_exp2((m_a - mn_a) * scale_log2e);
    al_b = fast_exp2((m_b - mn_b) * scale_log2e);
    m_a = mn_a;
    m_b = mn_b;
    // p = 2^(s * c - m * c), one multiply-add and one ex2 per score; p is
    // zero where the score is the sentinel (a fully masked row has
    // m = NEG_INF, and 2^0 = 1 would pollute l and acc).
    const float off_ma = mn_a * scale_log2e;
    const float off_mb = mn_b * scale_log2e;
    auto prob = [&](int j, int i) {
      const float y = score(j, i);
      const float p =
          fast_exp2(fmaf(y, scale_log2e, -(i < 2 ? off_ma : off_mb)));
      return masked && y <= 0.5f * xllm::kNegInf ? 0.f : p;
    };
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the two 8-key tiles of the k-step
        const int j = 2 * kk + h;
        const float p0 = prob(j, 0), p1 = prob(j, 1);
        const float p2 = prob(j, 2), p3 = prob(j, 3);
        sum_a += p0 + p1;
        sum_b += p2 + p3;
        pa_cur[kk][2 * h] = xllm::pack_bf16(p0, p1);
        pa_cur[kk][2 * h + 1] = xllm::pack_bf16(p2, p3);
      }
    }
    l_a = l_a * al_a + sum_a;  // per lane; the four lanes add up at the end
    l_b = l_b * al_b + sum_b;
  };

  // Chunk 0 has landed: its scores open the pipeline.
  xllm::cp_async_wait<STAGES - 3>();
  xllm::fence_proxy_async();
  __syncthreads();
  float s_even[NJ * 4], s_odd[NJ * 4];
  uint32_t pa_even[kChunk / 16][4], pa_odd[kChunk / 16][4];
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa_even[kk][i] = pa_odd[kk][i] = 0u;
  xllm::wgmma_pin(o);  // zeroed before the first stage begins
  start_scores(s_even, 0);
  xllm::wgmma_commit();
  // Every wgmma is started on a path all threads take: the steps run in pairs
  // (the two score buffers swap roles), and with an odd count the last step
  // works on a chunk past the tile's end, which is masked whole (p = 0, the
  // maxima stay) against the last real chunk's finite K/V.
  for (int c = 0; c < n_chunks; c += 2) {
    step(s_even, s_odd, pa_even, pa_odd, c);
    step(s_odd, s_even, pa_odd, pa_even, c + 1);
  }
  // The value product of the last step's chunk.
  xllm::wgmma_wait<0>();
  xllm::wgmma_pin(o);
  xllm::wgmma_pin(pa_even);
  start_values(pa_odd, ((n_chunks + 1) & ~1) - 1);
  xllm::wgmma_commit();
  xllm::wgmma_wait<0>();
  xllm::wgmma_pin(o);
  xllm::wgmma_pin(pa_even);
  xllm::wgmma_pin(pa_odd);

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, w);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, w);
  }
  const float inv_a = 1.f / fmaxf(l_a, xllm::kLFloor);
  const float inv_b = 1.f / fmaxf(l_b, xllm::kLFloor);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int d = 8 * j + 2 * t4;
    if (s_a < s_q)
      *reinterpret_cast<uint32_t*>(out + off_a + d) =
          xllm::pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    if (s_b < s_q)
      *reinterpret_cast<uint32_t*>(out + off_b + d) =
          xllm::pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

// Raise the kernel's dynamic shared-memory cap and ask for the largest
// shared-memory carveout. Returns the blocks of `threads` threads and `smem`
// bytes that one SM holds, or a negative cudaError_t.
template <typename Kernel>
int prepare_kernel(Kernel kernel, int threads, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  return e == cudaSuccess ? blocks : -int(e);
}

constexpr int kWarpgroups = 2;  // 128 rows per block
constexpr int kStages = 4;      // chunks c - 1 (V), c, c + 1 (K), c + 2 loading

// Launches the tensor-core kernel, or, with blocks_per_sm set, only reports
// how many of its blocks one SM holds.
template <int HD>
int launch_wgmma(const void* q, const void* k_pages, const void* v_pages,
                 const void* page_table, const void* prefix_lens,
                 const void* block_lens, void* out, int B, int s_q, int n_q,
                 int n_kv, int ps, int max_pages, float scale,
                 cudaStream_t stream, int* blocks_per_sm) {
  // The ring, and room to align it to 1024 bytes.
  constexpr int smem = kStages * 2 * kChunk * HD * 2 + 1024;
  constexpr int threads = kWarpgroups * 128;
  auto kernel = mq_wgmma_kernel<HD, kWarpgroups, kStages>;
  static int per_sm = 0;  // prepared once
  if (per_sm <= 0) {
    per_sm = prepare_kernel(kernel, threads, smem);
    if (per_sm < 0) return -per_sm;
  }
  if (blocks_per_sm) {
    *blocks_per_sm = per_sm;
    return 0;
  }
  const int q_tile = kWarpgroups * 64 / (n_q / n_kv);
  dim3 grid((s_q + q_tile - 1) / q_tile, n_kv, B);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(prefix_lens),
      static_cast<const int*>(block_lens), static_cast<bf16*>(out), s_q, n_q,
      n_kv, ps, max_pages, scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows (queries in a tile x GQA group) one block of the walk takes at this
// head dim and page size (0: the shape is not supported).
int mq_paged_attention_max_rows(int hd, int ps) {
  return xllm::walk_max_rows(kWalkThreads, hd, ps);
}

// Rows per block of the tensor-core kernel (128) where it takes bf16 inputs
// of this head dim, page size and GQA group, else 0 (such a call takes the
// walk).
int mq_paged_attention_mma_rows(int hd, int ps, int group) {
  const bool ps_ok = ps > 0 && ps <= kChunk && (ps & (ps - 1)) == 0;
  const bool ok =
      (hd == 64 || hd == 128) && ps_ok && group > 0 && 64 % group == 0;
  return ok ? kWarpgroups * 64 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. use_mma: 0 for the walk (q_tile queries
// per block), 1 for the tensor-core kernel (bf16 only, shapes for which
// mq_paged_attention_mma_rows is not 0; q_tile is ignored). Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// combination it does not take.
int mq_paged_attention_launch(const void* q, const void* k_pages,
                              const void* v_pages, const void* page_table,
                              const void* prefix_lens, const void* block_lens,
                              void* out, int B, int s_q, int n_q, int n_kv,
                              int hd, int ps, int max_pages, int q_tile,
                              int dtype, int use_mma, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!use_mma) {
    if (dtype == 1)
      return launch_walk<bf16>(q, k_pages, v_pages, page_table, prefix_lens,
                               block_lens, out, B, s_q, n_q, n_kv, hd, ps,
                               max_pages, q_tile, scale, s);
    return launch_walk<float>(q, k_pages, v_pages, page_table, prefix_lens,
                              block_lens, out, B, s_q, n_q, n_kv, hd, ps,
                              max_pages, q_tile, scale, s);
  }
  if (dtype != 1 || n_kv <= 0 ||
      !mq_paged_attention_mma_rows(hd, ps, n_q / n_kv))
    return int(cudaErrorInvalidValue);
  if (hd == 128)
    return launch_wgmma<128>(q, k_pages, v_pages, page_table, prefix_lens,
                             block_lens, out, B, s_q, n_q, n_kv, ps, max_pages,
                             scale, s, nullptr);
  return launch_wgmma<64>(q, k_pages, v_pages, page_table, prefix_lens,
                          block_lens, out, B, s_q, n_q, n_kv, ps, max_pages,
                          scale, s, nullptr);
}

// Blocks of the tensor-core kernel for this head dim (64 or 128) that one SM
// holds, by the occupancy calculator; negative: a cudaError_t. For the run's
// log.
int mq_paged_attention_blocks_per_sm(int hd) {
  int blocks = 0;
  int e = int(cudaErrorInvalidValue);
  if (hd == 128)
    e = launch_wgmma<128>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, 1, 1, 1, 1, 16, 1, 1.f, nullptr, &blocks);
  else if (hd == 64)
    e = launch_wgmma<64>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, 1, 1, 1, 1, 16, 1, 1.f, nullptr, &blocks);
  return e == 0 ? blocks : -e;
}

}  // extern "C"
