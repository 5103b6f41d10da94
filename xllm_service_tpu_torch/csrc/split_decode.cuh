// The split-K decode walk of the port's single-query attention kernels for
// Hopper (sm_90a), written once: paged_attention.cu (kernel 1),
// fused_decode_attention.cu (kernel 3) and cp_paged_partial.cu (kernel 6).
//
// One query token per sequence attends over the K/V slots its page table
// reaches: slot c of a row's walk lies on table entry c / ps, at c % ps. The
// kernels differ in three things, each a compile-time part of a policy
// (Decode, FusedDecode and Partial at the end of this file):
// - where the token in slot c sits: at position c (kernels 1 and 3), or, in a
//   shard's compacted table, at starts[c / ps] + c % ps (kernel 6);
// - the bound of the walk: ctx (kernel 1), ctx - 1 pooled tokens (kernel 3),
//   n_local * ps compacted slots (kernel 6), read on the device;
// - the epilogue: normalise (kernel 1); merge the new token as one more
//   partial, normalise and append its K/V row (kernel 3); write the raw
//   statistics (m, l, acc) for the cross-shard merge (kernel 6).
//
// What bounds these kernels on this card: reading K/V bytes. At Llama-3-8B
// decode shapes (B 8, ctx 1024, n_kv 8, hd 128, bf16) one call reads
// 8 * 1024 * 8 * 128 * 2 * 2 B = 33.5 MB of K/V, about 10 us at 3.35 TB/s,
// against about 0.13 GFLOP of arithmetic. A memory-bound kernel needs every
// SM busy and about 25 KB per SM in flight at all times (3.35 TB/s x ~1 us
// of latency).
//
// What the design does about it:
// - Split-K over the walk (flash-decoding): grid (splits, n_kv, B). The host
//   picks `splits` from the shapes and the SM count alone (about two blocks
//   per SM); each block reads its bound on the device and takes its share of
//   the row's 16-slot units. The G query heads of a GQA group share a block,
//   so each K/V byte is still read once.
// - Loads in flight: K/V stay in their own type in shared memory, staged by
//   16-byte cp.async (kv_ring.cuh). Each warp owns every fourth unit of the
//   block's share and a private ring of stages, so it starts the loads of
//   units i + 1 .. i + kStages - 1 before it computes unit i and needs only
//   __syncwarp, never a block barrier, inside the walk.
// - bf16 at a head dim of 64, 128 or 256 multiplies on the tensor cores
//   (mma.sync, mma_bf16.cuh); f32, and bf16 at a head dim of 32, on the
//   CUDA cores in f32. Both run the softmax in base 2.
// - Head dim 256 (the Gemma configs): a bf16 unit is 16 KB of K/V, so the
//   three-stage rings of the four warps take 192 KB and one block fills an
//   SM; f32 rows take one stage (128 KB). The GQA group is capped at 8 there
//   (every Gemma config has 2 or 8), which halves the merge and the q tile.
//   The host sizes its split count from the blocks per SM the occupancy
//   calculator reports (blocks_per_sm).
// - The merge: the four warps merge through shared memory; with splits > 1
//   the block writes (m, l, acc) in f32 to scratch, and the last block of a
//   (row, KV head) to finish, found by an atomic ticket after
//   __threadfence(), merges the splits and runs the epilogue in the same
//   launch. The ticket counter resets itself, so no second launch and no
//   zeroing is added. With splits == 1 no scratch is touched.
// - The invariants of the reference's ops/pallas_page_dma.py: K/V of a slot
//   that is not staged (past the bound, or for kernel 6 at a position at or
//   past ctx) are zero in shared memory (cp.async of source size 0, so NaN
//   in a dead slot never reaches a product), scores are masked by a select,
//   p is zero where the score is the sentinel, and a part with nothing
//   visible weighs 0 in every merge.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_ring.cuh"
#include "mma_bf16.cuh"

namespace xllm {
namespace split {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnit = 16;      // slots per warp step
constexpr int kMaxGroup = 16;  // query heads per KV head
constexpr int kMaxStages = 3;  // of a warp's ring (stages_of)
constexpr int kMaxGroupHd256 = 8;  // query heads per KV head at head dim 256

// Stages of a warp's ring: three where a block then still leaves room for a
// second one on the SM (bf16: 4 warps x 3 x 8 KB = 96 KB at hd 128), two for
// f32 rows (128 KB). At head dim 256 one block fills the SM either way:
// bf16 keeps three stages (4 x 3 x 16 KB = 192 KB), f32 takes one (4 x
// 32 KB = 128 KB; two would be 256 KB, over the 227 KB a block may have).
template <typename T, int HD>
constexpr int stages_of() {
  return sizeof(T) == 2 ? 3 : (HD <= 128 ? 2 : 1);
}

// Query heads per KV head the kernels take at this head dim and page size
// (0: the shape is not supported): head dim 32, 64 or 128 (groups up to 16)
// or 256 (up to 8), page size a power of two up to 64.
inline int max_group(int hd, int ps) {
  const bool ps_ok = ps > 0 && ps <= 64 && (ps & (ps - 1)) == 0;
  if (!ps_ok) return 0;
  if (hd == 32 || hd == 64 || hd == 128) return kMaxGroup;
  return hd == 256 ? kMaxGroupHd256 : 0;
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
  static constexpr int kStages = stages_of<T, HD>();
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

// What a launch passes to every block. Kernel 1 fills the first part; kernel
// 3 adds the new token's rows, kernel 6 its compacted table and statistics.
struct Args {
  const void* q;             // [B, n_q, hd]
  const void* k_pages;       // [P, n_kv, ps, hd]; kernel 3 appends to them
  const void* v_pages;
  const int* page_table;     // [B, max_pages]; kernel 6: the local table
  const int* context_lens;   // [B]
  void* out;                 // [B, n_q, hd]: T, or f32 acc for kernel 6
  float* scratch;            // partials of a launch with splits > 1
  unsigned int* tickets;     // one zeroed counter per (row, KV head)
  int n_q, n_kv, ps, max_pages;
  float scale, softcap;
  int window;
  const void* k_new;         // kernel 3: [B, n_kv, hd]
  const void* v_new;
  const int* starts;         // kernel 6: [B, max_pages], entry j's position
  const int* n_local;        // kernel 6: [B], owned entries
  float* m_out;              // kernel 6: [B, n_q], natural-log units
  float* l_out;              // kernel 6: [B, n_q]
};

// The slots a row's walk covers, read on the device: [0, n) of its table
// (n within the table). A slot is visible from slot lo on (a window) and,
// in a compacted table, while its token's position is below ctx.
struct Walk {
  int n, lo, ctx;
};

// This warp's share of the walk: the units [lo / 16, ceil(n / 16)) are cut
// into gridDim.x runs, and warp w of the block takes units first,
// first + 4, ... (n of them) of the block's run. Units wholly below lo are
// never loaded.
struct Share {
  int first, n;
};

__device__ __forceinline__ Share my_share(const Walk& w, int warp) {
  const int splits = gridDim.x;
  const int u_lo = w.lo / kUnit;
  const int u_hi = (w.n + kUnit - 1) / kUnit;
  const int per = (max(u_hi - u_lo, 0) + splits - 1) / splits;
  const int u0 = u_lo + blockIdx.x * per;
  const int u1 = min(u0 + per, u_hi);
  Share s;
  s.first = u0 + warp;
  s.n = s.first < u1 ? (u1 - s.first + kWarps - 1) / kWarps : 0;
  return s;
}

// Stage unit `u` (slots [16 u, 16 u + 16) of the walk) into a warp's stage:
// K rows then V rows, swizzled. A slot is staged while it lies below the
// walk's bound and, in a compacted table, while its position is below ctx;
// any other slot is zero. Returns, for a compacted table, the unit's staged
// slots as bits 0-15 (0 otherwise: slot c is staged while c < w.n).
template <typename T, int HD, bool kCompacted>
__device__ __forceinline__ uint32_t stage_unit(
    uint32_t stage, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ pt_row,
    const int* __restrict__ starts_row, int u, const Walk& w, int n_kv,
    int kv, int ps, int ps_shift, int lane) {
  constexpr int kPieces = HD * int(sizeof(T)) / 16;
  constexpr int kPerPiece = 16 / int(sizeof(T));
  constexpr int kTileBytes = kUnit * HD * int(sizeof(T));
  const int c0 = u * kUnit;
  // With pages of 16 tokens or more the unit lies on one entry: its page id
  // (and, compacted, its start) is read once, ahead of the copies.
  const bool one_page = ps >= kUnit;
  const int id0 = one_page && c0 < w.n ? pt_row[c0 >> ps_shift] : 0;
  uint32_t staged = 0;
  if constexpr (kCompacted) {
    // Lane t (and t + 16) looks up slot c0 + t's position; entries past
    // the bound are never read.
    const int c = c0 + (lane & (kUnit - 1));
    const bool live =
        c < w.n && starts_row[c >> ps_shift] + (c & (ps - 1)) < w.ctx;
    staged = __ballot_sync(0xffffffffu, live) & 0xffffu;
  }
#pragma unroll
  for (int i = lane; i < kUnit * kPieces; i += 32) {
    const int t = i / kPieces;
    const int c = i % kPieces;
    const int slot = c0 + t;
    const bool live = kCompacted ? (staged >> t) & 1u : slot < w.n;
    size_t off = 0;
    if (live)
      off = ((size_t(one_page ? id0 : pt_row[slot >> ps_shift]) * n_kv + kv) *
                 ps +
             (slot & (ps - 1))) *
                HD +
            c * kPerPiece;
    const uint32_t dst = stage + xllm::staged_offset<kPieces>(t, c);
    xllm::cp_async_16(dst, k_pages + off, live);
    xllm::cp_async_16(dst + kTileBytes, v_pages + off, live);
  }
  return staged;
}

// The ring of one warp: `Stages` stages of one unit each. start() puts the
// first Stages - 1 units in flight; next(i) waits for unit i, puts unit
// i + Stages - 1 in flight into the stage unit i - 1 left, and returns the
// byte offset of unit i's stage inside the warp's ring; staged(i) is unit
// i's mask of staged slots (compacted tables). Only __syncwarp: no other
// warp touches this ring.
template <typename T, int HD, int Stages, bool kCompacted>
struct WarpRing {
  static constexpr int kStageBytes = 2 * kUnit * HD * int(sizeof(T));
  uint32_t base;   // shared-memory address of the warp's ring
  uint32_t* masks;  // [Stages] in shared memory, compacted tables only
  const T* k_pages;
  const T* v_pages;
  const int* pt_row;
  const int* starts_row;
  Walk w;
  Share sh;
  int n_kv, kv, ps, ps_shift, lane;

  __device__ __forceinline__ void load(int i) {
    if (i < sh.n) {
      const uint32_t staged = stage_unit<T, HD, kCompacted>(
          base + (i % Stages) * kStageBytes, k_pages, v_pages, pt_row,
          starts_row, sh.first + i * kWarps, w, n_kv, kv, ps, ps_shift, lane);
      if constexpr (kCompacted) {
        if (lane == 0) masks[i % Stages] = staged;
      }
    }
    xllm::cp_async_commit();
  }
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int i = 0; i < Stages - 1; ++i) load(i);
  }
  __device__ __forceinline__ int next(int i) {
    if constexpr (Stages == 1) {
      // One stage: unit i - 1 is consumed, then unit i is loaded and waited
      // for (nothing is in flight while a unit is computed).
      __syncwarp();
      load(i);
      xllm::cp_async_wait<0>();
      __syncwarp();
    } else {
      xllm::cp_async_wait<Stages - 2>();  // unit i has landed
      __syncwarp();                       // and unit i - 1 is consumed
      load(i + Stages - 1);
    }
    return (i % Stages) * kStageBytes;
  }
  __device__ __forceinline__ uint32_t staged(int i) const {
    return masks[i % Stages];
  }
};

template <typename T, int HD, int Stages, bool kCompacted>
__device__ __forceinline__ WarpRing<T, HD, Stages, kCompacted> make_ring(
    const Args& a, char* smem, uint32_t* masks, const Walk& w,
    const Share& sh, int b, int kv, int warp, int lane) {
  WarpRing<T, HD, Stages, kCompacted> r;
  r.base = xllm::smem_u32(smem) + warp * Stages * r.kStageBytes;
  r.masks = masks + warp * Stages;
  r.k_pages = static_cast<const T*>(a.k_pages);
  r.v_pages = static_cast<const T*>(a.v_pages);
  r.pt_row = a.page_table + size_t(b) * a.max_pages;
  r.starts_row = kCompacted ? a.starts + size_t(b) * a.max_pages : nullptr;
  r.w = w;
  r.sh = sh;
  r.n_kv = a.n_kv;
  r.kv = kv;
  r.ps = a.ps;
  r.ps_shift = __ffs(a.ps) - 1;
  r.lane = lane;
  return r;
}

// ------------------------------------------------------------ the policies
enum class Epilogue { kNormalise, kAppend, kRawStats };

// Kernel 1: slot c holds position c; the walk covers [0, ctx), a window
// starts it at ctx - window; the output is normalised.
struct Decode {
  static constexpr bool kCompacted = false;
  static constexpr Epilogue kEpilogue = Epilogue::kNormalise;
  __device__ static Walk walk(const Args& a, int b) {
    const int ctx = min(a.context_lens[b], a.max_pages * a.ps);
    return {ctx, a.window > 0 ? max(ctx - a.window, 0) : 0, ctx};
  }
};

// Kernel 3: context_lens include the new token, whose K/V arrive as
// operands; the walk covers the ctx - 1 pooled tokens, the new token is one
// more partial in the final merge, and the block that runs the final merge
// appends its K/V row.
struct FusedDecode {
  static constexpr bool kCompacted = false;
  static constexpr Epilogue kEpilogue = Epilogue::kAppend;
  __device__ static Walk walk(const Args& a, int b) {
    const int n = min(max(a.context_lens[b] - 1, 0), a.max_pages * a.ps);
    return {n, 0, n};
  }
};

// Kernel 6: a shard's compacted table, its n_local owned entries first;
// entry j holds positions starts[j] .. starts[j] + ps - 1, visible below
// ctx; the raw statistics leave the kernel.
struct Partial {
  static constexpr bool kCompacted = true;
  static constexpr Epilogue kEpilogue = Epilogue::kRawStats;
  __device__ static Walk walk(const Args& a, int b) {
    const int n_pages = min(max(a.n_local[b], 0), a.max_pages);
    return {n_pages * a.ps, 0, a.context_lens[b]};
  }
};

// Kernel 3's part of the final merge, run by the one block that runs it
// (the only block, or the last by the ticket): the new token's score per
// group row into s_new (log2 units), and the append of its K and V rows to
// slot pos % ps of page page_table[b, min(pos / ps, max_pages - 1)], pos =
// max(ctx - 1, 0). Every split's walk has ended by then, so nothing of this
// launch reads the slot while it is written; tail pages are private to
// their row (the page manager donates only whole pages). Every thread of
// the block calls it.
template <typename T, int HD, typename P>
__device__ __forceinline__ void new_token(const Args& a, int b, int kv, int G,
                                          float* s_new) {
  if constexpr (P::kEpilogue == Epilogue::kAppend) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const T* q = static_cast<const T*>(a.q) +
                 (size_t(b) * a.n_q + size_t(kv) * G) * HD;
    const size_t new0 = (size_t(b) * a.n_kv + kv) * HD;
    const T* k_new = static_cast<const T*>(a.k_new) + new0;
    const T* v_new = static_cast<const T*>(a.v_new) + new0;
    for (int g = warp; g < G; g += kWarps) {
      float x = 0.f;
      for (int d = lane; d < HD; d += 32)
        x = fmaf(to_f<T>(q[g * HD + d]), to_f<T>(k_new[d]), x);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) s_new[g] = x * a.scale * kLog2e;
    }
    const int pos = max(a.context_lens[b] - 1, 0);
    const int page = a.page_table[size_t(b) * a.max_pages +
                                  min(pos / a.ps, a.max_pages - 1)];
    const size_t dst =
        ((size_t(page) * a.n_kv + kv) * a.ps + (pos & (a.ps - 1))) * HD;
    T* k_pool = static_cast<T*>(const_cast<void*>(a.k_pages));
    T* v_pool = static_cast<T*>(const_cast<void*>(a.v_pages));
    for (int d = threadIdx.x; d < HD; d += kThreads) {
      k_pool[dst + d] = k_new[d];
      v_pool[dst + d] = v_new[d];
    }
    __syncthreads();
  }
}

// The epilogue of element (query row qrow = row b's head kv * G + g, column
// d), given the merged (m, l, acc) of the walk, m in log2 units.
template <typename T, int HD, typename P>
__device__ __forceinline__ void emit(const Args& a, size_t qrow, int b,
                                     int kv, int g, int d, float m, float l,
                                     float acc, const float* s_new) {
  if constexpr (P::kEpilogue == Epilogue::kRawStats) {
    // m leaves in natural-log units; the sentinel of a row with nothing
    // visible leaves exactly as it is, with l = 0 and acc = 0.
    static_cast<float*>(a.out)[qrow * HD + d] = acc;
    if (d == 0) {
      a.m_out[qrow] = m <= 0.5f * kNegInf ? kNegInf : m * kLn2;
      a.l_out[qrow] = l;
    }
  } else {
    if constexpr (P::kEpilogue == Epilogue::kAppend) {
      // The new token as one more partial: m = its score, l = 1, acc = v.
      const float mn = s_new[g];
      const float mx = fmaxf(m, mn);
      const float wt = m <= 0.5f * kNegInf ? 0.f : exp2f(m - mx);
      const float wn = exp2f(mn - mx);
      const float vn =
          to_f<T>(static_cast<const T*>(a.v_new)[(size_t(b) * a.n_kv + kv) *
                                                      HD +
                                                  d]);
      l = l * wt + wn;
      acc = fmaf(vn, wn, acc * wt);
    }
    static_cast<T*>(a.out)[qrow * HD + d] = from_f<T>(acc / fmaxf(l, kLFloor));
  }
}

// The end of every block. The warps have written their partial results of
// the group's G rows, m in log2 units, into shared memory (w_m and w_l
// [kWarps][GMAX], w_a [kWarps][GMAX][HD]) and the block has synchronised.
// Merges them (the log-sum-exp merge of ops/cp_paged_attention.py::
// merge_partials: a part with nothing visible weighs 0); with one split it
// runs the epilogue, else it writes the block's partial to scratch, and the
// last block of the (row, KV head) to arrive merges the splits and runs it.
template <typename T, int HD, int GMAX, typename P>
__device__ __forceinline__ void finish_block(const Args& a, const float* w_m,
                                             const float* w_l,
                                             const float* w_a, int b, int kv,
                                             int G) {
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const size_t qrow0 = size_t(b) * a.n_q + size_t(kv) * G;  // first query row
  // Scratch, f32: acc [B][n_q][splits][HD], then m and l [B][n_q][splits].
  const size_t n_rows = size_t(gridDim.z) * a.n_q;
  float* s_acc = a.scratch;
  float* s_m = a.scratch + n_rows * splits * HD;
  float* s_l = s_m + n_rows * splits;
  __shared__ float s_new[kMaxGroup];  // kernel 3: the new token's scores

  if (splits == 1) new_token<T, HD, P>(a, b, kv, G, s_new);
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
      emit<T, HD, P>(a, qrow0 + g, b, kv, g, d, mg, lg, ag, s_new);
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
  new_token<T, HD, P>(a, b, kv, G, s_new);
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
    emit<T, HD, P>(a, qrow0 + g, b, kv, g, d, mg, lg, ag, s_new);
  }
}

// ------------------------------------------------ f32 arithmetic, CUDA cores
// Every f32 call (full f32 arithmetic), and bf16 at a head dim of 32.
template <typename T, int HD, int GMAX, typename P>
__global__ void __launch_bounds__(kThreads) fma_kernel(Args a) {
  using S = Smem<T, HD, GMAX>;
  constexpr int kStages = S::kStages;
  static_assert(kStages <= kMaxStages, "the masks hold every stage");
  constexpr int kPieces = HD * int(sizeof(T)) / 16;  // 16-byte pieces per row
  constexpr int kPerPiece = 16 / int(sizeof(T));     // elements per piece
  constexpr int CPL = HD / 32;                       // output columns per lane
  extern __shared__ __align__(128) char smem[];
  __shared__ uint32_t masks[kWarps * kMaxStages];
  float* q_s = reinterpret_cast<float*>(smem + S::kRegion0);  // [GMAX][HD]
  float* p_all = q_s + GMAX * HD;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.n_q / a.n_kv;
  const Walk wk = P::walk(a, b);
  const Share sh = my_share(wk, warp);
  auto ring = make_ring<T, HD, kStages, P::kCompacted>(a, smem, masks, wk, sh,
                                                       b, kv, warp, lane);
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

  // Score step: lane (slot t, half h) dots the pieces c with c % 2 == h of
  // slot t's K row with every query of the group.
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
    const int slot = u * kUnit + t;
    bool visible;
    if constexpr (P::kCompacted)
      visible = (ring.staged(i) >> t) & 1u;
    else
      visible = slot < wk.n && slot >= wk.lo;
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
    // This lane's bytes of a row, loaded in pieces of at most 16 bytes: a
    // row's logical pieces are not adjacent in the swizzled stage.
    constexpr int kColBytes = CPL * int(sizeof(T));
    constexpr int kLoadBytes = kColBytes < 16 ? kColBytes : 16;
    constexpr int kLoads = kColBytes / kLoadBytes;
    constexpr int kPerLoad = kLoadBytes / int(sizeof(T));
    struct alignas(kLoadBytes) Cols {
      T v[kPerLoad];
    };
    const int col_piece = (lane * kColBytes) >> 4;
    const int col_in = (lane * kColBytes) & 15;
#pragma unroll
    for (int t4 = 0; t4 < kUnit / 4; ++t4) {
      float vf[4][CPL];
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const char* src =
              v_t + xllm::staged_offset<kPieces>(4 * t4 + tt, col_piece + j) +
              col_in;
          const Cols cv = *reinterpret_cast<const Cols*>(src);  // one load
#pragma unroll
          for (int c = 0; c < kPerLoad; ++c)
            vf[tt][j * kPerLoad + c] = to_f<T>(cv.v[c]);
        }
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
  finish_block<T, HD, GMAX, P>(a, w_m, w_l, w_a, b, kv, G);
}

// ------------------------------------------------- bf16 on the tensor cores
// bf16 at a head dim of 64, 128 or 256: the group's G <= 16 query heads are
// the rows of one m16n8k16 tile (rows past G are zero queries, never
// written), a unit's 16 keys two 8-key tiles of scores, and the softmax
// stays in registers as in mq_paged_attention.cu. Per unit a warp runs 16
// ldmatrix and 32 mma (twice that at head dim 256) where the CUDA-core path
// runs about a thousand instructions, so the warp is free to wait on its
// loads.
using bf16 = __nv_bfloat16;

template <int HD, typename P>
__global__ void __launch_bounds__(kThreads) mma_kernel(Args a) {
  using S = Smem<bf16, HD, kMaxGroup>;
  constexpr int kStages = S::kStages;
  static_assert(kStages <= kMaxStages, "the masks hold every stage");
  constexpr int kRowBytes = HD * 2;
  constexpr int KS = HD / 16;  // k-steps of the score product
  constexpr int ND = HD / 8;   // 8-column tiles of the output
  extern __shared__ __align__(128) char smem[];
  __shared__ uint32_t masks[kWarps * kMaxStages];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.n_q / a.n_kv;
  const Walk wk = P::walk(a, b);
  const Share sh = my_share(wk, warp);
  auto ring = make_ring<bf16, HD, kStages, P::kCompacted>(a, smem, masks, wk,
                                                          sh, b, kv, warp,
                                                          lane);
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
    uint32_t staged = 0;
    if constexpr (P::kCompacted) staged = ring.staged(i);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = 8 * j + 2 * t4 + (e & 1);
        const int slot = u * kUnit + tt;
        bool visible;
        if constexpr (P::kCompacted)
          visible = (staged >> tt) & 1u;
        else
          visible = slot < wk.n && slot >= wk.lo;
        float y = s[j][e] * a.scale;
        if (a.softcap > 0.f) y = a.softcap * tanhf(y / a.softcap);
        s[j][e] = visible ? y * kLog2e : kNegInf;
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
  finish_block<bf16, HD, kMaxGroup, P>(a, w_m, w_l, w_a, b, kv, G);
}

// ---------------------------------------------------------------- launches
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

// Each library built from this header prepares its own kernels: the
// launchers are static (internal linkage), so their per_sm flags are the
// library's own. As inline templates of external linkage the flags were
// GNU_UNIQUE symbols, one per process: a library whose kernel another
// library had prepared launched it without its shared-memory cap raised
// (cudaErrorInvalidValue: split_routes' mma route after kernel 1 at head
// dim 256, as the compile gate ran them).
template <typename P, typename T, int HD, int GMAX>
static int launch_fma(const Args& a, int B, int splits,
                      cudaStream_t stream) {
  static int per_sm = 0;
  return launch(fma_kernel<T, HD, GMAX, P>, Smem<T, HD, GMAX>::kBytes,
                &per_sm, a, B, splits, stream);
}

template <typename P, int HD>
static int launch_mma(const Args& a, int B, int splits,
                      cudaStream_t stream) {
  static int per_sm = 0;
  return launch(mma_kernel<HD, P>, Smem<bf16, HD, kMaxGroup>::kRegion0,
                &per_sm, a, B, splits, stream);
}

template <typename P, typename T, int HD>
static int launch_fma_group(const Args& a, int B, int splits,
                            cudaStream_t stream) {
  const int G = a.n_q / a.n_kv;
  if (G <= 4) return launch_fma<P, T, HD, 4>(a, B, splits, stream);
  if constexpr (HD > 128) {  // groups up to kMaxGroupHd256
    return launch_fma<P, T, HD, kMaxGroupHd256>(a, B, splits, stream);
  } else {
    if (G <= 8) return launch_fma<P, T, HD, 8>(a, B, splits, stream);
    return launch_fma<P, T, HD, kMaxGroup>(a, B, splits, stream);
  }
}

// The route of a call: bf16 at a head dim of 64, 128 or 256 takes the
// tensor cores, everything else the f32 arithmetic on the CUDA cores. dtype:
// 0 = float32, 1 = bfloat16; splits 0 asks for the blocks per SM (negated).
// At head dim 256 the tensor-core kernel holds 245 registers without a
// spill (ptxas -v, in chip_smoke.py's build log) and ran faster than the
// CUDA-core route on the card at Gemma-2-9B's shapes.
template <typename P>
static int dispatch(const Args& a, int B, int hd, int dtype, int splits,
                    cudaStream_t stream) {
  if (dtype == 1) {
    if (hd == 128) return launch_mma<P, 128>(a, B, splits, stream);
    if (hd == 64) return launch_mma<P, 64>(a, B, splits, stream);
    if (hd == 32) return launch_fma_group<P, bf16, 32>(a, B, splits, stream);
    if (hd == 256) return launch_mma<P, 256>(a, B, splits, stream);
    return int(cudaErrorInvalidValue);
  }
  if (hd == 256) return launch_fma_group<P, float, 256>(a, B, splits, stream);
  if (hd == 128) return launch_fma_group<P, float, 128>(a, B, splits, stream);
  if (hd == 64) return launch_fma_group<P, float, 64>(a, B, splits, stream);
  if (hd == 32) return launch_fma_group<P, float, 32>(a, B, splits, stream);
  return int(cudaErrorInvalidValue);
}

// A launch of policy P after the checks every entry point makes (a GQA
// group of 1 to kMaxGroup, a shape the kernels take, splits >= 1).
template <typename P>
static int checked_launch(const Args& a, int B, int hd, int dtype,
                          int splits, void* stream) {
  const int G = a.n_kv > 0 ? a.n_q / a.n_kv : 0;
  if (G < 1 || G > max_group(hd, a.ps) || splits < 1)
    return int(cudaErrorInvalidValue);
  return dispatch<P>(a, B, hd, dtype, splits,
                     static_cast<cudaStream_t>(stream));
}

// Blocks of policy P's kernel for this head dim, GQA group and dtype that
// one SM holds, by the occupancy calculator; negative: a cudaError_t.
template <typename P>
static int blocks_per_sm(int hd, int group, int dtype) {
  if (group < 1 || group > max_group(hd, 16))
    return -int(cudaErrorInvalidValue);
  Args a = {};
  a.n_q = group;
  a.n_kv = 1;
  return -dispatch<P>(a, 1, hd, dtype, 0, nullptr);
}

}  // namespace split
}  // namespace xllm
