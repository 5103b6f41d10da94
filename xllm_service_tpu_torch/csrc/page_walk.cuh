// The f32 page walk of kernel 2's CUDA-core route (mq_paged_attention.cu:
// f32 inputs, and bf16 shapes its tensor-core route does not take).
//
// Carries the invariants of the reference's ops/pallas_page_dma.py (its
// 2-slot VMEM DMA ring is the TPU's shape and is not carried over):
//
// - masked_kv_f32 (pallas_page_dma.py:282): K/V rows at positions >= the
//   context bound are zero in shared memory (they are never read), so
//   0 x NaN never reaches the accumulator. A pool made with torch.empty, or
//   page 0 after garbage writes, can hold NaN.
// - flash_accumulate (pallas_page_dma.py:309): p is re-zeroed where the
//   score is the mask sentinel, so a fully masked chunk adds nothing
//   (without it exp(NEG_INF - NEG_INF) = 1 would pollute l and acc).
// - NEG_INF = -1e30, and l is clamped at 1e-9 on output
//   (pallas_paged_attention.py:103-104): a row that sees no key (a padding
//   query) writes zeros.
//
// One thread block owns R query rows that share one KV head (a tile of
// queries times the G query heads of a GQA group) and walks that head's
// pages a chunk of kChunkTokens tokens at a time (64 / page_size pages): the
// chunk is staged in shared memory as f32 and used by every row. Per chunk:
//   1. scores: thread (token t, row group) holds t's K row and dots it with
//      its rows' queries (float4 shared-memory reads, K rows padded so a
//      warp's reads are conflict-free);
//   2. online softmax, one warp per row: chunk max, p = exp(s - m_new)
//      re-zeroed on masked keys, running l and the rescale alpha;
//   3. acc = acc * alpha + p @ V: thread (column d, row group) keeps its
//      rows' f32 accumulators in registers and reads each V element once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xllm {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-9f;
constexpr int kChunkTokens = 64;  // tokens staged per step of the walk
constexpr int kMaxScoreRows = 8;  // rows per thread in the score step
constexpr int kMaxAccRows = 16;   // rows per thread in the p @ V step
constexpr int kKPad = 4;          // floats of padding per staged K row
// The softmax step gives each lane of a warp two of a chunk's tokens.
static_assert(kChunkTokens == 64, "one warp covers a chunk in two halves");

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <>
struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);
  }
};

// Rows one block can own for a head dim and page size, with nthreads
// threads: 0 where the walk does not take the shape. The wrappers size
// their row tiles from this.
__host__ __device__ inline int walk_max_rows(int nthreads, int hd, int ps) {
  if (hd <= 0 || hd % 32 || nthreads % hd || ps <= 0 ||
      kChunkTokens % ps)
    return 0;
  const int by_scores = kMaxScoreRows * (nthreads / kChunkTokens);
  const int by_acc = kMaxAccRows * (nthreads / hd);
  return by_scores < by_acc ? by_scores : by_acc;
}

// Shared-memory carve-up of one block (all f32 except the two bound rows).
struct WalkSmem {
  float* q;      // [R][hd]                  queries, pre-scaled
  float* k;      // [kChunkTokens][hd+kKPad] the chunk's K
  float* v;      // [kChunkTokens][hd]       the chunk's V
  float* s;      // [R][kChunkTokens]        scores, then probabilities
  float* m;      // [R]                      running max
  float* l;      // [R]                      running denominator
  float* alpha;  // [R]                      rescale of acc for this chunk
  int* hi;       // [R]                      row r sees keys below hi[r]
};

__host__ __device__ inline size_t walk_smem_bytes(int R, int hd) {
  return sizeof(float) *
             (size_t(R) * hd + size_t(kChunkTokens) * (hd + kKPad) +
              size_t(kChunkTokens) * hd + size_t(R) * kChunkTokens +
              3 * size_t(R)) +
         sizeof(int) * size_t(R);
}

__device__ inline WalkSmem carve_smem(char* base, int R, int hd) {
  WalkSmem sm;
  float* f = reinterpret_cast<float*>(base);
  sm.q = f;
  f += size_t(R) * hd;
  sm.k = f;
  f += size_t(kChunkTokens) * (hd + kKPad);
  sm.v = f;
  f += size_t(kChunkTokens) * hd;
  sm.s = f;
  f += size_t(R) * kChunkTokens;
  sm.m = f;
  f += R;
  sm.l = f;
  f += R;
  sm.alpha = f;
  f += R;
  sm.hi = reinterpret_cast<int*>(f);
  return sm;
}

// Widen 16 bytes of T to f32.
template <typename T>
__device__ __forceinline__ void widen16(const uint4& raw, float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) dst[i] = Elt<T>::to_f(e[i]);
}

// masked_kv_f32 for one chunk: pages [p0, p0 + 64/ps) of the row's table
// (those below p_hi), K/V of head kv, into shared memory as f32; tokens at
// positions >= bound (or on pages >= p_hi) are zero and never read.
template <typename T>
__device__ __forceinline__ void load_chunk(
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int* __restrict__ pt_row, int p0, int p_hi, int n_kv, int kv,
    int ps, int hd, int bound, const WalkSmem& sm) {
  constexpr int kVec = 16 / sizeof(T);
  const int n_vec = kChunkTokens * hd / kVec;
  const int start = p0 * ps;
#pragma unroll 4
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const int e = i * kVec;
    const int t = e / hd;
    const int d = e - t * hd;
    const int page = p0 + t / ps;
    float kf[kVec];
    float vf[kVec];
    if (page < p_hi && start + t < bound) {
      const size_t off = (size_t(pt_row[page]) * n_kv + kv) * ps * hd +
                         size_t(t % ps) * hd + d;
      widen16<T>(*reinterpret_cast<const uint4*>(k_pages + off), kf);
      widen16<T>(*reinterpret_cast<const uint4*>(v_pages + off), vf);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) kf[j] = vf[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      sm.k[t * (hd + kKPad) + d + j] = kf[j];
      sm.v[t * hd + d + j] = vf[j];
    }
  }
}

// Walk pages [0, p_hi) of one row's page table for R query rows against
// KV head `kv`; entry j holds positions [j * ps, (j + 1) * ps). acc[i]
// accumulates row (threadIdx.x / hd + i * (blockDim.x / hd)), column
// threadIdx.x % hd, unnormalised; sm.m / sm.l hold the softmax state. The
// caller has filled sm.q and sm.hi, set m = NEG_INF and l = 0, and
// synchronised. R <= walk_max_rows(blockDim.x, hd, ps).
template <typename T>
__device__ void page_walk(const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const int* __restrict__ pt_row, int p_hi, int n_kv,
                          int kv, int ps, int hd, int R, int bound,
                          const WalkSmem& sm, float (&acc)[kMaxAccRows]) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  const int pages_per_chunk = kChunkTokens / ps;
  // Score step: this thread's token and first row.
  const int st = tid % kChunkTokens;
  const int s_row0 = tid / kChunkTokens;
  const int s_rows_step = nt / kChunkTokens;
  // p @ V step: this thread's column and first row.
  const int pd = tid % hd;
  const int p_row0 = tid / hd;
  const int p_rows_step = nt / hd;
  const int hd4 = hd / 4;

  for (int p0 = 0; p0 < p_hi; p0 += pages_per_chunk) {
    const int start = p0 * ps;
    load_chunk<T>(k_pages, v_pages, pt_row, p0, p_hi, n_kv, kv, ps, hd,
                  bound, sm);
    __syncthreads();

    // 1. Scores, masked to each row's visible keys.
    {
      float x[kMaxScoreRows];
#pragma unroll
      for (int i = 0; i < kMaxScoreRows; ++i) x[i] = 0.f;
      const float4* kr =
          reinterpret_cast<const float4*>(sm.k + st * (hd + kKPad));
      for (int d4 = 0; d4 < hd4; ++d4) {
        const float4 kk = kr[d4];
#pragma unroll
        for (int i = 0; i < kMaxScoreRows; ++i) {
          const int r = s_row0 + i * s_rows_step;
          if (r < R) {
            const float4 qq = reinterpret_cast<const float4*>(sm.q + r * hd)[d4];
            x[i] = fmaf(qq.x, kk.x, x[i]);
            x[i] = fmaf(qq.y, kk.y, x[i]);
            x[i] = fmaf(qq.z, kk.z, x[i]);
            x[i] = fmaf(qq.w, kk.w, x[i]);
          }
        }
      }
      const int pos = start + st;
#pragma unroll
      for (int i = 0; i < kMaxScoreRows; ++i) {
        const int r = s_row0 + i * s_rows_step;
        if (r < R)
          sm.s[r * kChunkTokens + st] = pos < sm.hi[r] ? x[i] : kNegInf;
      }
    }
    __syncthreads();

    // 2. flash_accumulate statistics, one warp per row.
    for (int r = warp; r < R; r += n_warps) {
      float* sr = sm.s + r * kChunkTokens;
      const float a0 = sr[lane];
      const float a1 = sr[lane + 32];
      float m_cur = fmaxf(a0, a1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, o));
      const float m_prev = sm.m[r];
      const float m_new = fmaxf(m_prev, m_cur);
      const float p0v = a0 <= 0.5f * kNegInf ? 0.f : expf(a0 - m_new);
      const float p1v = a1 <= 0.5f * kNegInf ? 0.f : expf(a1 - m_new);
      sr[lane] = p0v;
      sr[lane + 32] = p1v;
      float sum = p0v + p1v;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        sm.l[r] = sm.l[r] * a + sum;
        sm.m[r] = m_new;
        sm.alpha[r] = a;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + p @ V.
#pragma unroll
    for (int i = 0; i < kMaxAccRows; ++i) {
      const int r = p_row0 + i * p_rows_step;
      if (r < R) acc[i] *= sm.alpha[r];
    }
    for (int t4 = 0; t4 < kChunkTokens / 4; ++t4) {
      const float* vt = sm.v + (4 * t4) * hd + pd;
      const float v0 = vt[0];
      const float v1 = vt[hd];
      const float v2 = vt[2 * hd];
      const float v3 = vt[3 * hd];
#pragma unroll
      for (int i = 0; i < kMaxAccRows; ++i) {
        const int r = p_row0 + i * p_rows_step;
        if (r < R) {
          const float4 pp =
              reinterpret_cast<const float4*>(sm.s + r * kChunkTokens)[t4];
          float y = acc[i];
          y = fmaf(pp.x, v0, y);
          y = fmaf(pp.y, v1, y);
          y = fmaf(pp.z, v2, y);
          y = fmaf(pp.w, v3, y);
          acc[i] = y;
        }
      }
    }
    __syncthreads();
  }
}

// The row and column of acc[i] for this thread, and the normalised value.
struct AccSlot {
  int row;
  int col;
};

__device__ __forceinline__ AccSlot acc_slot(int i, int hd) {
  return {static_cast<int>(threadIdx.x) / hd + i * static_cast<int>(blockDim.x / hd),
          static_cast<int>(threadIdx.x) % hd};
}

__device__ __forceinline__ float normalised(float acc, const WalkSmem& sm,
                                            int r) {
  return acc / fmaxf(sm.l[r], kLFloor);
}

}  // namespace xllm
