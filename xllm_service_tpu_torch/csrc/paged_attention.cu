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
// step (32 launches per step). A memory-bound kernel needs every SM busy and
// about 25 KB per SM in flight at all times (3.35 TB/s x ~1 us of latency).
//
// What the design does about it:
// - Split-K over the context (flash-decoding): grid (splits, n_kv, B). The
//   host picks `splits` from the shapes and the SM count alone (about two
//   blocks per SM); each block reads ctx on the device and takes its share
//   of the row's 16-token units inside the visible range. The G query heads
//   of a GQA group share a block, so each K/V byte is still read once.
// - Loads in flight: K/V stay in their own type in shared memory, staged by
//   16-byte cp.async (kv_ring.cuh). Each warp owns every fourth unit of the
//   block's share and a private ring of stages, so it starts the loads of
//   units i + 1 .. i + kStages - 1 before it computes unit i and needs only
//   __syncwarp, never a block barrier, inside the walk.
// - Arithmetic stays small and on the CUDA cores in f32 (both types): per
//   unit a lane dots one token's half row with the group's queries (rows
//   swizzled, so the column walk has no bank conflicts and q is a
//   broadcast), the softmax runs on shuffles in base 2, and p @ V gives each
//   lane hd / 32 output columns.
// - The merge: the four warps merge through shared memory; with splits > 1
//   the block writes (m, l, acc) in f32 to scratch, and the last block of a
//   (row, KV head) to finish, found by an atomic ticket after
//   __threadfence(), merges the splits and writes the output in the same
//   launch. The ticket counter resets itself, so no second launch and no
//   zeroing is added. With splits == 1 no scratch is touched.
// - The invariants of page_walk.cuh hold: K/V at positions >= ctx are zero in
//   shared memory (cp.async of source size 0), scores are masked by a
//   select, p is zero where the score is the sentinel, l is floored at 1e-9
//   (a row with ctx == 0 writes zeros), and a window starts the walk at
//   the unit that holds position ctx - window.
//
// Softcap, sliding window and an explicit scale follow the TPU kernel
// (gemma-2 options; the Llama path passes scale = 1/sqrt(hd) and neither of
// the others).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_ring.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnit = 16;      // tokens per warp step
constexpr int kMaxGroup = 16;  // query heads per KV head

// Stages of a warp's ring: three where a block then still leaves room for a
// second one on the SM (bf16: 4 warps x 3 x 8 KB = 96 KB at hd 128), two for
// f32 rows (128 KB).
template <typename T>
constexpr int stages_of() {
  return sizeof(T) == 2 ? 3 : 2;
}

// Eight (bf16) or four (f32) consecutive elements of a staged row as f32.
__device__ __forceinline__ void widen(const uint4& raw, float (&x)[8],
                                      __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void widen(const uint4& raw, float (&x)[4], float) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared memory of one block.
template <typename T, int HD, int GMAX>
struct Smem {
  static constexpr int kStages = stages_of<T>();
  static constexpr int kTileBytes = kUnit * HD * int(sizeof(T));  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
  // After the walk the ring is reused for the warps' partial results.
  static constexpr int kMergeBytes = kWarps * GMAX * (HD + 2) * 4;
  static constexpr int kQBytes = GMAX * HD * 4;       // q, pre-scaled, f32
  static constexpr int kPBytes = kWarps * GMAX * kUnit * 4;  // p per warp
  static constexpr int kRegion0 =
      kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  static constexpr int kBytes = kRegion0 + kQBytes + kPBytes;
};

// Stage unit `u` (tokens [16 u, 16 u + 16) of the row) into a warp's stage:
// K rows then V rows, swizzled; tokens at or past ctx (or the table) zero.
template <typename T, int HD>
__device__ __forceinline__ void stage_unit(
    uint32_t stage, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ pt_row, int u,
    int ctx, int n_kv, int kv, int ps, int ps_shift, int max_pages,
    int lane) {
  constexpr int kPieces = HD * int(sizeof(T)) / 16;
  constexpr int kPerPiece = 16 / int(sizeof(T));
  constexpr int kTileBytes = kUnit * HD * int(sizeof(T));
  // With pages of 16 tokens or more the unit lies on one page: its id is
  // read once, ahead of the copies that depend on it.
  const bool one_page = ps >= kUnit;
  const int page0 = (u * kUnit) >> ps_shift;
  const int id0 =
      one_page && u * kUnit < ctx && page0 < max_pages ? pt_row[page0] : 0;
#pragma unroll
  for (int i = lane; i < kUnit * kPieces; i += 32) {
    const int t = i / kPieces;
    const int c = i % kPieces;
    const int pos = u * kUnit + t;
    const int page = pos >> ps_shift;
    const bool live = pos < ctx && page < max_pages;
    size_t off = 0;
    if (live)
      off = ((size_t(one_page ? id0 : pt_row[page]) * n_kv + kv) * ps +
             (pos & (ps - 1))) * HD +
            c * kPerPiece;
    const uint32_t dst = stage + xllm::staged_offset<kPieces>(t, c);
    xllm::cp_async_16(dst, k_pages + off, live);
    xllm::cp_async_16(dst + kTileBytes, v_pages + off, live);
  }
}

// What a launch passes to every block.
struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* page_table;
  const int* context_lens;
  void* out;
  float* scratch;         // partials of a launch with splits > 1
  unsigned int* tickets;  // one zeroed counter per (row, KV head)
  int n_q, n_kv, ps, max_pages;
  float scale, softcap;
  int window;
};

// This warp's share of row b: the visible range [lo_pos, ctx) in 16-token
// units is cut into gridDim.x runs, and warp w of the block takes units
// first, first + 4, ... (n of them) of the block's run. The query sits at
// position ctx - 1: a window keeps keys >= ctx - window, and units wholly
// below that are never loaded.
struct Share {
  int ctx, lo_pos, first, n;
};

__device__ __forceinline__ Share my_share(const Args& a, int b, int warp) {
  Share s;
  s.ctx = min(a.context_lens[b], a.max_pages * a.ps);
  s.lo_pos = a.window > 0 ? max(s.ctx - a.window, 0) : 0;
  const int splits = gridDim.x;
  const int u_lo = s.lo_pos / kUnit;
  const int u_hi = (s.ctx + kUnit - 1) / kUnit;
  const int per = (max(u_hi - u_lo, 0) + splits - 1) / splits;
  const int u0 = u_lo + blockIdx.x * per;
  const int u1 = min(u0 + per, u_hi);
  s.first = u0 + warp;
  s.n = s.first < u1 ? (u1 - s.first + kWarps - 1) / kWarps : 0;
  return s;
}

// The ring of one warp: `Stages` stages of one unit each. start() puts the
// first Stages - 1 units in flight; next(i) waits for unit i, puts unit
// i + Stages - 1 in flight into the stage unit i - 1 left, and returns the
// byte offset of unit i's stage inside the warp's ring. Only __syncwarp:
// no other warp touches this ring.
template <typename T, int HD, int Stages>
struct WarpRing {
  static constexpr int kStageBytes = 2 * kUnit * HD * int(sizeof(T));
  uint32_t base;  // shared-memory address of the warp's ring
  const T* k_pages;
  const T* v_pages;
  const int* pt_row;
  Share sh;
  int n_kv, kv, ps, ps_shift, max_pages, lane;

  __device__ __forceinline__ void load(int i) {
    if (i < sh.n)
      stage_unit<T, HD>(base + (i % Stages) * kStageBytes, k_pages, v_pages,
                        pt_row, sh.first + i * kWarps, sh.ctx, n_kv, kv, ps,
                        ps_shift, max_pages, lane);
    xllm::cp_async_commit();
  }
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int i = 0; i < Stages - 1; ++i) load(i);
  }
  __device__ __forceinline__ int next(int i) {
    xllm::cp_async_wait<Stages - 2>();  // unit i has landed
    __syncwarp();                       // and unit i - 1 is consumed
    load(i + Stages - 1);
    return (i % Stages) * kStageBytes;
  }
};

template <typename T, int HD, int Stages>
__device__ __forceinline__ WarpRing<T, HD, Stages> make_ring(
    const Args& a, char* smem, const Share& sh, int b, int kv, int warp,
    int lane) {
  WarpRing<T, HD, Stages> r;
  r.base = xllm::smem_u32(smem) + warp * Stages * r.kStageBytes;
  r.k_pages = static_cast<const T*>(a.k_pages);
  r.v_pages = static_cast<const T*>(a.v_pages);
  r.pt_row = a.page_table + size_t(b) * a.max_pages;
  r.sh = sh;
  r.n_kv = a.n_kv;
  r.kv = kv;
  r.ps = a.ps;
  r.ps_shift = __ffs(a.ps) - 1;
  r.max_pages = a.max_pages;
  r.lane = lane;
  return r;
}

// The end of every block. The warps have written their partial results of
// the group's G rows, m in log2 units, into shared memory (w_m and w_l
// [kWarps][GMAX], w_a [kWarps][GMAX][HD]) and the block has synchronised.
// Merges them (the log-sum-exp merge of ops/cp_paged_attention.py::
// merge_partials: a part with nothing visible weighs 0); with one split it
// writes the output, else the block's partial to scratch, and the last block
// of the (row, KV head) to arrive merges the splits.
template <typename T, int HD, int GMAX>
__device__ __forceinline__ void finish_block(const Args& a, const float* w_m,
                                             const float* w_l,
                                             const float* w_a, int b, int kv,
                                             int G) {
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  T* out = static_cast<T*>(a.out);
  const size_t qrow0 = size_t(b) * a.n_q + size_t(kv) * G;  // first query row
  const size_t row0 = qrow0 * HD;
  // Scratch, f32: acc [B][n_q][splits][HD], then m and l [B][n_q][splits].
  const size_t n_rows = size_t(gridDim.z) * a.n_q;
  float* s_acc = a.scratch;
  float* s_m = a.scratch + n_rows * splits * HD;
  float* s_l = s_m + n_rows * splits;

  for (int e = threadIdx.x; e < G * HD; e += kThreads) {
    const int g = e / HD;
    const int d = e - g * HD;
    float mg = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mg = fmaxf(mg, w_m[w * GMAX + g]);
    float lg = 0.f, ag = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = w_m[w * GMAX + g];
      const float wt = mw <= 0.5f * kNegInf ? 0.f : exp2f(mw - mg);
      lg += w_l[w * GMAX + g] * wt;
      ag += w_a[(w * GMAX + g) * HD + d] * wt;
    }
    if (splits == 1) {
      out[row0 + e] = from_f<T>(ag / fmaxf(lg, kLFloor));
    } else {
      const size_t r = (qrow0 + g) * splits + split;
      s_acc[r * HD + d] = ag;
      if (d == 0) {
        s_m[r] = mg;
        s_l[r] = lg;
      }
    }
  }
  if (splits == 1) return;

  // The last block of this (row, KV head) to get here merges the splits.
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int* ticket = a.tickets + size_t(b) * a.n_kv + kv;
    const unsigned int seen = atomicAdd(ticket, 1u);
    is_last = seen == unsigned(splits - 1);
    if (is_last) *ticket = 0u;  // ready for the next launch on this stream
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int e = threadIdx.x; e < G * HD; e += kThreads) {
    const int g = e / HD;
    const int d = e - g * HD;
    const size_t r = (qrow0 + g) * splits;
    float mg = kNegInf;
    for (int i = 0; i < splits; ++i) mg = fmaxf(mg, __ldcg(s_m + r + i));
    float lg = 0.f, ag = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float mi = __ldcg(s_m + r + i);
      const float wt = mi <= 0.5f * kNegInf ? 0.f : exp2f(mi - mg);
      lg += __ldcg(s_l + r + i) * wt;
      ag += __ldcg(s_acc + (r + i) * HD + d) * wt;
    }
    out[row0 + e] = from_f<T>(ag / fmaxf(lg, kLFloor));
  }
}

// ------------------------------------------------ f32 arithmetic, CUDA cores
// Every f32 call (full f32 arithmetic), and bf16 at a head dim of 32.
template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads) paged_attention_fma_kernel(Args a) {
  using S = Smem<T, HD, GMAX>;
  constexpr int kStages = S::kStages;
  constexpr int kPieces = HD * int(sizeof(T)) / 16;  // 16-byte pieces per row
  constexpr int kPerPiece = 16 / int(sizeof(T));     // elements per piece
  constexpr int CPL = HD / 32;                       // output columns per lane
  extern __shared__ __align__(128) char smem[];
  float* q_s = reinterpret_cast<float*>(smem + S::kRegion0);  // [GMAX][HD]
  float* p_all = q_s + GMAX * HD;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.n_q / a.n_kv;
  const Share sh = my_share(a, b, warp);
  auto ring = make_ring<T, HD, kStages>(a, smem, sh, b, kv, warp, lane);
  ring.start();

  // q, pre-scaled, as f32 in shared memory (the loads above are in flight).
  const T* q = static_cast<const T*>(a.q) +
               (size_t(b) * a.n_q + size_t(kv) * G) * HD;
  for (int i = threadIdx.x; i < G * HD; i += kThreads)
    q_s[i] = to_f<T>(q[i]) * a.scale;
  __syncthreads();

  float m[GMAX], l[GMAX], acc[GMAX][CPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[g][c] = 0.f;
  }

  // Score step: lane (token t, half h) dots the pieces c with c % 2 == h of
  // token t's K row with every query of the group.
  const int t = lane & 15;
  const int h = lane >> 4;
  float* p_s = p_all + warp * GMAX * kUnit;  // [GMAX][16] of this warp
  const char* ring_ptr = smem + warp * kStages * S::kStageBytes;

  for (int i = 0; i < sh.n; ++i) {
    const int u = sh.first + i * kWarps;
    const char* k_t = ring_ptr + ring.next(i);
    const char* v_t = k_t + S::kTileBytes;

    // 1. Scores.
    float x[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) x[g] = 0.f;
#pragma unroll
    for (int j = 0; j < kPieces / 2; ++j) {
      const int c = 2 * j + h;
      float kf[kPerPiece];
      widen(*reinterpret_cast<const uint4*>(
                k_t + xllm::staged_offset<kPieces>(t, c)),
            kf, T());
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float4* qp =
              reinterpret_cast<const float4*>(q_s + g * HD + c * kPerPiece);
#pragma unroll
          for (int e = 0; e < kPerPiece / 4; ++e) {
            const float4 qq = qp[e];
            x[g] = fmaf(qq.x, kf[4 * e], x[g]);
            x[g] = fmaf(qq.y, kf[4 * e + 1], x[g]);
            x[g] = fmaf(qq.z, kf[4 * e + 2], x[g]);
            x[g] = fmaf(qq.w, kf[4 * e + 3], x[g]);
          }
        }
      }
    }
    const int pos = u * kUnit + t;
    const bool visible = pos < sh.ctx && pos >= sh.lo_pos;
    float alpha[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        float y = x[g] + __shfl_xor_sync(0xffffffffu, x[g], 16);
        if (a.softcap > 0.f) y = a.softcap * tanhf(y / a.softcap);
        y = visible ? y * kLog2e : kNegInf;  // a select, never arithmetic
        float mx = y;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[g], mx);
        // p is zero where the score is the sentinel.
        const float p = y <= 0.5f * kNegInf ? 0.f : exp2f(y - m_new);
        float sum = p;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        alpha[g] = exp2f(m[g] - m_new);
        l[g] = l[g] * alpha[g] + sum;
        m[g] = m_new;
        if (h == 0) p_s[g * kUnit + t] = p;
      }
    }
    __syncwarp();

    // 2. acc = acc * alpha + p @ V: this lane's CPL columns.
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[g][c] *= alpha[g];
      }
    constexpr int kColBytes = CPL * int(sizeof(T));  // this lane's bytes/row
    struct alignas(kColBytes) Cols {
      T v[CPL];
    };
    const int col_piece = (lane * kColBytes) >> 4;
    const int col_in = (lane * kColBytes) & 15;
#pragma unroll
    for (int t4 = 0; t4 < kUnit / 4; ++t4) {
      float vf[4][CPL];
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const char* src = v_t +
                          xllm::staged_offset<kPieces>(4 * t4 + tt, col_piece) +
                          col_in;
        const Cols cv = *reinterpret_cast<const Cols*>(src);  // one load
#pragma unroll
        for (int c = 0; c < CPL; ++c) vf[tt][c] = to_f<T>(cv.v[c]);
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float4 pp =
              reinterpret_cast<const float4*>(p_s + g * kUnit)[t4];
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            float y = acc[g][c];
            y = fmaf(pp.x, vf[0][c], y);
            y = fmaf(pp.y, vf[1][c], y);
            y = fmaf(pp.z, vf[2][c], y);
            y = fmaf(pp.w, vf[3][c], y);
            acc[g][c] = y;
          }
        }
      }
    }
    __syncwarp();  // p_s is free again
  }
  xllm::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring

  // The four warps' partials, through the ring's memory.
  float* w_m = reinterpret_cast<float*>(smem);  // [kWarps][GMAX]
  float* w_l = w_m + kWarps * GMAX;             // [kWarps][GMAX]
  float* w_a = w_l + kWarps * GMAX;             // [kWarps][GMAX][HD]
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        w_m[warp * GMAX + g] = m[g];
        w_l[warp * GMAX + g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        w_a[(warp * GMAX + g) * HD + lane * CPL + c] = acc[g][c];
    }
  }
  __syncthreads();
  finish_block<T, HD, GMAX>(a, w_m, w_l, w_a, b, kv, G);
}

// ------------------------------------------------- bf16 on the tensor cores
// bf16 at a head dim of 64 or 128: the group's G <= 16 query heads are the
// rows of one m16n8k16 tile (rows past G are zero queries, never written), a
// unit's 16 keys two 8-key tiles of scores, and the softmax stays in
// registers as in mq_paged_attention.cu. Per unit a warp runs 16 ldmatrix
// and 32 mma where the CUDA-core path runs about a thousand instructions,
// so the warp is free to wait on its loads.
using bf16 = __nv_bfloat16;

template <int HD>
__global__ void __launch_bounds__(kThreads) paged_attention_mma_kernel(Args a) {
  using S = Smem<bf16, HD, kMaxGroup>;
  constexpr int kStages = S::kStages;
  constexpr int kRowBytes = HD * 2;
  constexpr int KS = HD / 16;  // k-steps of the score product
  constexpr int ND = HD / 8;   // 8-column tiles of the output
  extern __shared__ __align__(128) char smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.n_q / a.n_kv;
  const Share sh = my_share(a, b, warp);
  auto ring = make_ring<bf16, HD, kStages>(a, smem, sh, b, kv, warp, lane);
  ring.start();

  // Q as A fragments straight from device memory: row g is query head g of
  // the group, row g + 8 head g + 8; heads past G are zero.
  const bf16* q = static_cast<const bf16*>(a.q) +
                  (size_t(b) * a.n_q + size_t(kv) * G) * HD;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int d = ks * 16 + 2 * t4;
    qf[ks][0] = qf[ks][1] = qf[ks][2] = qf[ks][3] = 0u;
    if (g < G) {
      qf[ks][0] = *reinterpret_cast<const uint32_t*>(q + g * HD + d);
      qf[ks][2] = *reinterpret_cast<const uint32_t*>(q + g * HD + d + 8);
    }
    if (g + 8 < G) {
      qf[ks][1] = *reinterpret_cast<const uint32_t*>(q + (g + 8) * HD + d);
      qf[ks][3] = *reinterpret_cast<const uint32_t*>(q + (g + 8) * HD + d + 8);
    }
  }

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  // ldmatrix addresses of this lane inside a stage (see mma_bf16.cuh): K as
  // stored, matrices (keys +0, d +0), (keys +0, d +8), (keys +8, d +0),
  // (keys +8, d +8); V transposed, matrices (keys +0, d +0), (keys +8, d +0),
  // (keys +0, d +8), (keys +8, d +8).
  const int x8 = lane & 7;
  const uint32_t k_row = uint32_t(((lane >> 4) * 8 + x8) * kRowBytes);
  const int k_piece = (lane >> 3) & 1;
  const uint32_t v_row = uint32_t(S::kTileBytes +
                                  (((lane >> 3) & 1) * 8 + x8) * kRowBytes);
  const int v_piece = lane >> 4;

  for (int i = 0; i < sh.n; ++i) {
    const int u = sh.first + i * kWarps;
    const uint32_t stage = ring.base + ring.next(i);

    // S = Q K^T for 16 rows x 16 keys.
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kb[4];
      xllm::ldmatrix_x4(kb, stage + k_row + (((ks * 2 + k_piece) ^ x8) << 4));
      xllm::mma_bf16_16816(s[0], qf[ks], kb[0], kb[1]);
      xllm::mma_bf16_16816(s[1], qf[ks], kb[2], kb[3]);
    }
    // Scale, softcap, mask (a select), into log2 units.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = u * kUnit + 8 * j + 2 * t4 + (e & 1);
        float y = s[j][e] * a.scale;
        if (a.softcap > 0.f) y = a.softcap * tanhf(y / a.softcap);
        s[j][e] = pos < sh.ctx && pos >= sh.lo_pos ? y * kLog2e : kNegInf;
      }
    }
    // Online softmax on rows g and g + 8; four lanes share a row.
    float mx_a = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    float mx_b = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, w));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, w));
    }
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a);
    const float al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // p is zero where the score is the sentinel.
        const float y = s[j][e];
        const float p =
            y <= 0.5f * kNegInf ? 0.f : exp2f(y - (e < 2 ? mn_a : mn_b));
        s[j][e] = p;
        if (e < 2)
          sum_a += p;
        else
          sum_b += p;
      }
    }
    l_a = l_a * al_a + sum_a;  // per lane; the four lanes add up at the end
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= al_a;
      o[j][1] *= al_a;
      o[j][2] *= al_b;
      o[j][3] *= al_b;
    }
    // O += P V, P rounded to bf16 in registers as the A operand.
    uint32_t pa[4];
    pa[0] = xllm::pack_bf16(s[0][0], s[0][1]);
    pa[1] = xllm::pack_bf16(s[0][2], s[0][3]);
    pa[2] = xllm::pack_bf16(s[1][0], s[1][1]);
    pa[3] = xllm::pack_bf16(s[1][2], s[1][3]);
#pragma unroll
    for (int dp = 0; dp < ND / 2; ++dp) {
      uint32_t vb[4];
      xllm::ldmatrix_x4_trans(
          vb, stage + v_row + (((dp * 2 + v_piece) ^ x8) << 4));
      xllm::mma_bf16_16816(o[2 * dp], pa, vb[0], vb[1]);
      xllm::mma_bf16_16816(o[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
  xllm::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, w);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, w);
  }
  // The four warps' partials, through the ring's memory.
  float* w_m = reinterpret_cast<float*>(smem);  // [kWarps][16]
  float* w_l = w_m + kWarps * kMaxGroup;        // [kWarps][16]
  float* w_a = w_l + kWarps * kMaxGroup;        // [kWarps][16][HD]
  if (g < G) {
    float* dst = w_a + (warp * kMaxGroup + g) * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[j][0], o[j][1]);
    if (t4 == 0) {
      w_m[warp * kMaxGroup + g] = m_a;
      w_l[warp * kMaxGroup + g] = l_a;
    }
  }
  if (g + 8 < G) {
    float* dst = w_a + (warp * kMaxGroup + g + 8) * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[j][2], o[j][3]);
    if (t4 == 0) {
      w_m[warp * kMaxGroup + g + 8] = m_b;
      w_l[warp * kMaxGroup + g + 8] = l_b;
    }
  }
  __syncthreads();
  finish_block<bf16, HD, kMaxGroup>(a, w_m, w_l, w_a, b, kv, G);
}

// Raise the kernel's dynamic shared-memory cap, ask for the largest carveout
// (so that two blocks fit on an SM) and count the blocks one SM holds; then
// launch, unless splits == 0 (a query: returns minus that count).
template <typename Kernel>
int launch(Kernel kernel, int smem, int* per_sm, const Args& a, int B,
           int splits, cudaStream_t stream) {
  if (*per_sm <= 0) {  // prepared once per kernel
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kThreads, smem);
    if (e != cudaSuccess) return int(e);
  }
  if (splits == 0) return -*per_sm;
  kernel<<<dim3(splits, a.n_kv, B), kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T, int HD, int GMAX>
int launch_fma(const Args& a, int B, int splits, cudaStream_t stream) {
  static int per_sm = 0;
  return launch(paged_attention_fma_kernel<T, HD, GMAX>,
                Smem<T, HD, GMAX>::kBytes, &per_sm, a, B, splits, stream);
}

template <int HD>
int launch_mma(const Args& a, int B, int splits, cudaStream_t stream) {
  static int per_sm = 0;
  return launch(paged_attention_mma_kernel<HD>,
                Smem<bf16, HD, kMaxGroup>::kRegion0, &per_sm, a, B, splits,
                stream);
}

template <typename T, int HD>
int launch_fma_group(const Args& a, int B, int splits, cudaStream_t stream) {
  const int G = a.n_q / a.n_kv;
  if (G <= 4) return launch_fma<T, HD, 4>(a, B, splits, stream);
  if (G <= 8) return launch_fma<T, HD, 8>(a, B, splits, stream);
  return launch_fma<T, HD, kMaxGroup>(a, B, splits, stream);
}

// The route of a call: bf16 at a head dim of 64 or 128 takes the tensor
// cores, everything else the f32 arithmetic on the CUDA cores.
int dispatch(const Args& a, int B, int hd, int dtype, int splits,
             cudaStream_t stream) {
  if (dtype == 1) {
    if (hd == 128) return launch_mma<128>(a, B, splits, stream);
    if (hd == 64) return launch_mma<64>(a, B, splits, stream);
    if (hd == 32) return launch_fma_group<bf16, 32>(a, B, splits, stream);
    return int(cudaErrorInvalidValue);
  }
  if (hd == 128) return launch_fma_group<float, 128>(a, B, splits, stream);
  if (hd == 64) return launch_fma_group<float, 64>(a, B, splits, stream);
  if (hd == 32) return launch_fma_group<float, 32>(a, B, splits, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Query heads per KV head the kernel takes at this head dim and page size
// (0: the shape is not supported): head dim 32, 64 or 128, page size a power
// of two up to 64.
int paged_attention_max_group(int hd, int ps) {
  const bool hd_ok = hd == 32 || hd == 64 || hd == 128;
  const bool ps_ok = ps > 0 && ps <= 64 && (ps & (ps - 1)) == 0;
  return hd_ok && ps_ok ? kMaxGroup : 0;
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
  const int G = n_kv > 0 ? n_q / n_kv : 0;
  if (G < 1 || G > paged_attention_max_group(hd, ps) || splits < 1)
    return int(cudaErrorInvalidValue);
  const Args a = {q,
                  k_pages,
                  v_pages,
                  static_cast<const int*>(page_table),
                  static_cast<const int*>(context_lens),
                  out,
                  static_cast<float*>(scratch),
                  static_cast<unsigned int*>(tickets),
                  n_q,
                  n_kv,
                  ps,
                  max_pages,
                  scale,
                  softcap,
                  window};
  return dispatch(a, B, hd, dtype, splits, static_cast<cudaStream_t>(stream));
}

// Blocks of the kernel for this head dim, GQA group and dtype that one SM
// holds, by the occupancy calculator; negative: a cudaError_t. For the run's
// log.
int paged_attention_blocks_per_sm(int hd, int group, int dtype) {
  if (group < 1 || group > paged_attention_max_group(hd, 16))
    return -int(cudaErrorInvalidValue);
  Args a = {};
  a.n_q = group;
  a.n_kv = 1;
  return -dispatch(a, 1, hd, dtype, 0, nullptr);
}

}  // extern "C"
