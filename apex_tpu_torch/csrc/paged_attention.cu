// Paged attention for serving: T new query tokens per row attend to the
// row's KV history, read through its page table, plus the T new keys.
//
// Replaces: apex_tpu/ops/attention.py::_paged_fused_kernel (launched by
// paged_fused_attention).  Same function: cache key j is visible to query
// t iff j < len[b] and j <= pos[b, t]; new key t' iff pos[b, t'] <=
// pos[b, t] (and block_mask[t, t'] when a mask is given); the scores are
// q.k times `scale`; int8 pages are dequantized against their per-token
// fp32 scales; all softmax and accumulation math is fp32; the output is
// written in q's dtype.  The full 5-D pool (pages, L, H, page_len, D) is
// read at `layer`: the gathered view never exists in device memory.
//
// The TPU kernel assembled a whole row's (H, S, D) K and V in fp32 VMEM
// before one softmax; a Hopper block has 227 KB of shared memory, so here
// the history streams through an online softmax (running max m, sum l and
// an fp32 accumulator per query row), in one of three designs, which the
// caller picks (design codes kFma, kDecode, kTensorCores):
//
// 1. Decode, paged_decode_kernel: T <= kDecodeMaxT new tokens (decode
//    steps, short speculative verify blocks; the wrapper sends bf16 work
//    from T = 8 on to design 2).  Bound on the H100: bytes.  Each visible K
//    and V element is read once for at most 16 queries, far below the
//    card's operations-to-bytes ratio; a GPT-2-small step (B 8, H 12, D 64,
//    bf16 pages, ~512-key histories) moves 12.6 MB, 3.8 us at 3.35 TB/s.
//    - Split-K over whole pages: the grid is (split, h, b); a split is a
//      fixed run of `split_pages` pages (64 keys at page_len 16), and one
//      more split takes the T new keys, so a decode step has hundreds of
//      blocks loading at once.  A split past its row's visible keys exits
//      at once: the merge reads only the splits that hold keys, so it
//      writes nothing.
//    - Every load that depends on nothing (length, positions, q, the
//      split's page entries or the new keys) is issued before the first
//      barrier; the page entries are read once per page.  The keys are
//      staged 64 at a time by 16-byte cp.async copies (8 bf16, 16 int8 or
//      4 fp32 values), two threads a key row, in a two-stage ring when a
//      split holds more than 64 keys.
//    - Each warp takes 16 keys of a stage and keeps its own online softmax
//      (no barrier between its steps): a key's dot is split over a group
//      of lanes (one 16-byte vector each) reduced by shuffles, so a warp
//      scores 2 to 16 keys at once; int8 keys are scaled once per key after
//      the dot, and the value scale is folded into p.  The block combines
//      its warps' states in warp order.
//    - A split writes (m, l, acc) of its T rows to an fp32 workspace and
//      takes a ticket (one acq_rel atomic); the last split of the (b, h)
//      merges the partials in split order (the same bits whichever block
//      is last; no float atomics), resets its ticket to 0 for the next
//      call and writes the output.
// 2. Prefill chunks with bf16 q and bf16 or int8 pages, paged_prefill_tc.
//    Each staged key serves up to 64 queries, so the work leans toward
//    the operation bound.  A block of 4 warps per (64 query rows, split,
//    h, b), as flash_attention.cu's forward: q.k^T and p.V on the tensor
//    cores (mma.sync m16n8k16 bf16, fp32 accumulation), the online softmax
//    on the accumulators in fp32, 64-key tiles of the split's history
//    staged by cp.async through a two-stage ring, the split's page entries
//    read once per page (a split covers at most kPageWin - 2 pages); each
//    64-key tile of the new keys is a split of its own.  The splits merge
//    as in design 1.  Exactness: q is bf16 (exact) and `scale` multiplies
//    the fp32 score after the product; int8 keys are exact in bf16 and
//    their scale multiplies the score's column; p (times the value scale
//    for int8 pages) is split into bf16 hi + lo (two products, at most
//    2^-16 of p off); fp32 new keys and values (the dequantized keys of an
//    int8 model) are split the same way.  No dequantized key is rounded to
//    bf16 before its dot.
// 3. fp32 q or fp32 pages past T = 16: the fp32 FMA kernel
//    paged_fma_kernel, one block per (16 query rows, h, b) staging 32 keys
//    at a time as fp32 (the design every call took before the two above).
//
// Masked scores contribute exactly 0 (p is zeroed, not only pushed to
// -1e30), so a row whose first keys are masked is exact too; a row with
// no visible key at all (only possible with a block_mask whose diagonal
// is false) is written as 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_sync.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 128;  // every design: 4 warps
constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 128;
constexpr int kDecodeMaxT = 16;  // the decode kernel's largest T
constexpr int kChunk = 64;       // keys a stage (decode) or a tile (prefill)
constexpr int kWarps = kThreads / 32;
constexpr int kWarpKeys = kChunk / kWarps;  // a decode warp's keys of a chunk
constexpr int kMergeBatch = 16;  // decode partials read at once by a merge
constexpr int kPageWin = 1024;   // page entries of a prefill split, at most

// dtype codes of the C interface
constexpr int kF32 = 0, kBf16 = 1, kI8 = 2;
// the three designs, as the caller picks them
constexpr int kFma = 0, kDecode = 1, kTensorCores = 2;

struct Args {
  const void* q;
  const void* k_new;
  const void* v_new;
  const void* pool_k;
  const void* pool_v;
  const float* k_scale;  // null unless the pool is int8
  const float* v_scale;
  const int32_t* page_table;  // (B, n_pages)
  const int32_t* lengths;     // (B,)
  const int32_t* positions;   // (B, T)
  const uint8_t* block_mask;  // (T, T) or null
  void* out;                  // (B, H, T, D), contiguous
  float* ws;                  // the split kernels' partials (C interface)
  int* tickets;               // their tickets, 0 between calls
  int64_t q_sb, q_sh, q_st;   // element strides of q, k_new, v_new
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int B, H, T, D, L, layer, page_len, n_pages;
  // a split: split_pages pages (decode) or 64-key tiles (prefill);
  // stages: the decode kernel's ring
  int split_pages, n_splits, stages;
  int q_dtype, kv_dtype;
  // q, k_new, v_new rows may be read 4 elements at a time (aligned)
  int q_vec, k_vec, v_vec;
  float scale;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f32(const int8_t* p) {
  return static_cast<float>(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Elements e .. e + 3 of a row of q, k_new or v_new (fp32 or bf16, by
// `dtype`), as fp32: one 16- or 8-byte load when `vec`, else four.
__device__ __forceinline__ float4 load4(const void* base, int dtype,
                                        int64_t e, bool vec) {
  if (dtype == kF32) {
    const float* p = static_cast<const float*>(base) + e;
    if (vec) return *reinterpret_cast<const float4*>(p);
    return make_float4(p[0], p[1], p[2], p[3]);
  }
  const bf16* p = static_cast<const bf16*>(base) + e;
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, c.x, c.y);
  }
  return make_float4(__bfloat162float(p[0]), __bfloat162float(p[1]),
                     __bfloat162float(p[2]), __bfloat162float(p[3]));
}

// The ticket of a split that has written its partial: the old value of
// *p, incremented.  acq_rel at GPU scope: after a __syncthreads it
// releases the whole block's partial (cumulatively, as CUTLASS's
// semaphores do), and it acquires the partials released by the splits
// that took the earlier tickets; a __syncthreads after it hands them on
// to the block.  One atomic instead of a fence in every thread.
__device__ __forceinline__ int take_ticket(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// Physical token index of key j of row b at head h (the pool's
// (page, layer, head, slot) flattened), from the page entry `page`.
__device__ __forceinline__ int64_t token_of(const Args& a, int64_t page,
                                            int h, int j) {
  return ((page * a.L + a.layer) * a.H + h) * a.page_len + j % a.page_len;
}

// ---------------------------------------------------------------------------
// 1. Decode: split-K over pages with an in-kernel ordered merge
// ---------------------------------------------------------------------------

// A key row of D elements of ET as 16-byte vectors, and the lanes (a power
// of two) that score one key: one vector each, idle past the row's end.
template <typename ET, int D>
struct Row {
  static constexpr int kBytes = D * static_cast<int>(sizeof(ET));
  static constexpr int kVecs = kBytes / 16;
  static constexpr int kElems = 16 / static_cast<int>(sizeof(ET));
  static constexpr int kLanes = kVecs <= 1   ? 1
                                : kVecs <= 2 ? 2
                                : kVecs <= 4 ? 4
                                : kVecs <= 8 ? 8
                                : kVecs <= 16 ? 16
                                              : 32;
};

// 16 bytes of ET as fp32 values.
template <typename ET>
__device__ __forceinline__ void unpack16(const void* src,
                                         float (&x)[16 / sizeof(ET)]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (std::is_same<ET, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(w[i]);
  } else if constexpr (std::is_same<ET, bf16>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
  }
}

// The decode block's dynamic shared memory, in bytes from its start: the
// same computation on the host (to size the launch) and the device.
struct DecSmem {
  int stage_k, stage_v, scales, q, kn, vn, acc, wacc, wsc, ml, wml, pos,
      pages, total;
};
__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline DecSmem dec_smem(int T, int D, int elem_bytes,
                                            int stages, int split_pages) {
  DecSmem l;
  int off = 0;
  l.stage_k = off;  // [stage][kChunk][D] pool elements
  off += stages * kChunk * D * elem_bytes;
  l.stage_v = off;
  off += stages * kChunk * D * elem_bytes;
  l.scales = off;  // [stage][k | v][kChunk] fp32 (int8 pools)
  off += stages * 2 * kChunk * 4;
  l.q = off;  // [T][D] fp32, and the new keys and values
  off += T * D * 4;
  l.kn = off;
  off += T * D * 4;
  l.vn = off;
  off += T * D * 4;
  l.acc = off;  // the block's [T][D] fp32
  off += T * D * 4;
  l.wacc = off;  // each warp's [T][D] fp32
  off += kWarps * T * D * 4;
  l.wsc = off;  // each warp's [T][kWarpKeys] scores, then p
  off += kWarps * T * kWarpKeys * 4;
  l.ml = off;  // the block's m, l: [2][T] fp32
  off += up16(2 * T * 4);
  l.wml = off;  // each warp's m, l, alpha: [kWarps][3][T] fp32
  off += up16(kWarps * 3 * T * 4);
  l.pos = off;  // [T] int32
  off += up16(T * 4);
  l.pages = off;  // [split_pages] int32
  off += up16(split_pages * 4);
  l.total = off;
  return l;
}

// Rows 0 .. T - 1 of q, k_new or v_new for (b, h), as fp32 [T][D].
template <int D>
__device__ __forceinline__ void rows_f32(float* dst, const void* src,
                                         int dtype, int64_t base,
                                         int64_t row_stride, int T, bool vec) {
  for (int e = threadIdx.x; e < T * (D / 4); e += kThreads) {
    const int t = e / (D / 4), c = (e % (D / 4)) * 4;
    *reinterpret_cast<float4*>(dst + t * D + c) =
        load4(src, dtype, base + t * row_stride + c, vec);
  }
}

// The decode block's chunk is split over its warps, kWarpKeys keys each:
// each warp keeps its own online softmax (m, l, acc) over its keys, with
// no barrier between its steps, and the block combines the four at the
// end (combine_warps).

// sc[t][kk] = q_t . k for this warp's nw keys at `keys` (rows of D
// elements of ET): a group of Row::kLanes lanes per key, one 16-byte
// vector each, reduced by shuffles.
template <typename ET, int D>
__device__ __forceinline__ void warp_scores(const unsigned char* keys, int nw,
                                            const float* q, int T, float* sc) {
  using R = Row<ET, D>;
  constexpr int kGroups = 32 / R::kLanes;
  const int lane = threadIdx.x % 32;
  const int grp = lane / R::kLanes, sub = lane % R::kLanes;
  const bool has = sub < R::kVecs;
  for (int kk0 = 0; kk0 < nw; kk0 += kGroups) {  // uniform over the warp
    const int kk = kk0 + grp;
    float k[R::kElems];
    if (has && kk < nw)
      unpack16<ET>(keys + kk * R::kBytes + sub * 16, k);
    else
#pragma unroll
      for (int e = 0; e < R::kElems; ++e) k[e] = 0.f;
    for (int t = 0; t < T; ++t) {
      float part = 0.f;
      if (has) {
        const float* qt = q + t * D + sub * R::kElems;
#pragma unroll
        for (int e = 0; e < R::kElems; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qt + e);
          part = fmaf(qv.x, k[e], part);
          part = fmaf(qv.y, k[e + 1], part);
          part = fmaf(qv.z, k[e + 2], part);
          part = fmaf(qv.w, k[e + 3], part);
        }
      }
#pragma unroll
      for (int o = R::kLanes / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (sub == 0 && kk < nw) sc[t * kWarpKeys + kk] = part;
    }
  }
  __syncwarp();
}

// The warp's online-softmax step over its nw scored keys, lane kk holding
// key kk: the scores times `scale` (times the key's scale `ksc[kk]` for
// int8 pages), key kk visible to row t iff vis(t, kk).  p (times `vsc[kk]`,
// the value scale, for int8) replaces the score; the warp's m, l and the
// rescale alpha of each row move.
template <typename Vis>
__device__ __forceinline__ void warp_softmax(float* sc, int nw, int T,
                                             float scale, const float* ksc,
                                             const float* vsc, float* wm,
                                             float* wl, float* walpha,
                                             Vis vis) {
  const int lane = threadIdx.x % 32;
  for (int t = 0; t < T; ++t) {
    const bool ok = lane < nw && vis(t, lane);
    const float x =
        ok ? sc[t * kWarpKeys + lane] * scale * (ksc ? ksc[lane] : 1.f)
           : kNegInf;
    const float m_old = wm[t];
    const float m_new = fmaxf(m_old, warp_max(x));
    const float al = expf(m_old - m_new);
    const float p = ok ? expf(x - m_new) : 0.f;
    const float sum = warp_sum(p);
    if (lane < nw) sc[t * kWarpKeys + lane] = vsc ? p * vsc[lane] : p;
    __syncwarp();
    if (lane == 0) {
      wm[t] = m_new;
      wl[t] = wl[t] * al + sum;
      walpha[t] = al;
    }
  }
  __syncwarp();
}

// Two consecutive ET values at `src` as fp32.
template <typename ET>
__device__ __forceinline__ float2 load2(const unsigned char* src) {
  if constexpr (std::is_same<ET, float>::value) {
    return *reinterpret_cast<const float2*>(src);
  } else if constexpr (std::is_same<ET, bf16>::value) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
  } else {
    const char2 c = *reinterpret_cast<const char2*>(src);
    return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
  }
}

// The warp's acc[t][:] = acc[t][:] * alpha[t] + sum_kk p[t][kk] v_kk over
// its nw values at `vals` (rows of D elements of ET); a lane owns pairs
// of output dims.
template <typename ET, int D>
__device__ __forceinline__ void warp_pv(const unsigned char* vals, int nw,
                                        const float* p, int T,
                                        const float* walpha, float* wacc) {
  constexpr int kBytes = D * static_cast<int>(sizeof(ET));
  for (int e = threadIdx.x % 32; e < T * D / 2; e += 32) {
    const int t = e / (D / 2), d = (e % (D / 2)) * 2;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < nw; ++kk) {
      const float pk = p[t * kWarpKeys + kk];
      const float2 v = load2<ET>(vals + kk * kBytes + d * sizeof(ET));
      s0 = fmaf(pk, v.x, s0);
      s1 = fmaf(pk, v.y, s1);
    }
    float* a = wacc + t * D + d;
    a[0] = a[0] * walpha[t] + s0;
    a[1] = a[1] * walpha[t] + s1;
  }
  __syncwarp();
}

// The block's (m, l, acc) from its warps', in warp order.
template <int D>
__device__ __forceinline__ void combine_warps(const float* wml,
                                              const float* wacc, int T,
                                              float* m, float* l,
                                              float* acc) {
  for (int e = threadIdx.x; e < T * (D + 1); e += kThreads) {
    const bool row = e >= T * D;
    const int t = row ? e - T * D : e / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wml[w * 3 * T + t]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float x = row ? wml[w * 3 * T + T + t] : wacc[w * T * D + e];
      sum += x * expf(wml[w * 3 * T + t] - mx);
    }
    if (row) {
      m[t] = mx;
      l[t] = sum;
    } else {
      acc[e] = sum;
    }
  }
}

// Key row r of a 64-key stage is copied by threads 2 r and 2 r + 1, which
// take turns over its 16-byte vectors (a warp's copy instruction then
// reads whole 32-byte sectors of 16 rows): each thread works out one
// row's pool address a stage.
constexpr int kRowThreads = kThreads / kChunk;

// Keys [c0, c0 + n) of the split (c0 from the split's first key k_begin)
// into stage `st`: cp.async 16 bytes at a time, rows past n zero-filled,
// the page entry of each key from the split's page list `pages`.
template <typename PT, int D>
__device__ __forceinline__ void stage_keys(const Args& a, unsigned char* sk,
                                           unsigned char* sv, float* ksc,
                                           float* vsc, const int* pages,
                                           int h, int k_begin, int c0, int n) {
  using R = Row<PT, D>;
  const int r = threadIdx.x / kRowThreads, part = threadIdx.x % kRowThreads;
  const bool valid = r < n;
  int64_t tok = 0;
  if (valid) {
    const int j = c0 + r;
    tok = token_of(a, pages[(j - k_begin) / a.page_len], h, j);
  }
  const unsigned char* pk =
      static_cast<const unsigned char*>(a.pool_k) + tok * R::kBytes;
  const unsigned char* pv =
      static_cast<const unsigned char*>(a.pool_v) + tok * R::kBytes;
#pragma unroll
  for (int c = part * 16; c < R::kBytes; c += kRowThreads * 16) {
    cp_async16(sk + r * R::kBytes + c, pk + c, valid);
    cp_async16(sv + r * R::kBytes + c, pv + c, valid);
  }
  if (std::is_same<PT, int8_t>::value && part == 0) {
    cp_async4(ksc + r, a.k_scale + tok, valid);
    cp_async4(vsc + r, a.v_scale + tok, valid);
  }
}

// The partials of a row's (or query tile's) splits, n_act of them in
// split order: the history's first n_cache splits, then the splits of the
// new keys from index `first_new` on.
__device__ __forceinline__ int part_index(int i, int n_cache, int first_new) {
  return i < n_cache ? i : first_new + (i - n_cache);
}

template <typename PT, int D>
__global__ void __launch_bounds__(kThreads, 8)
paged_decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kInt8 = std::is_same<PT, int8_t>::value;
  using R = Row<PT, D>;
  // splits 0 .. n_splits - 1 hold the history, split n_splits the T new
  // keys
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const bool new_keys = split == a.n_splits;
  const int T = a.T;
  const DecSmem lay =
      dec_smem(T, D, sizeof(PT), a.stages, a.split_pages);
  unsigned char* const sk = smem + lay.stage_k;
  unsigned char* const sv = smem + lay.stage_v;
  float* const scl = reinterpret_cast<float*>(smem + lay.scales);
  float* const qs = reinterpret_cast<float*>(smem + lay.q);
  float* const kn = reinterpret_cast<float*>(smem + lay.kn);
  float* const vn = reinterpret_cast<float*>(smem + lay.vn);
  float* const acc = reinterpret_cast<float*>(smem + lay.acc);
  float* const m = reinterpret_cast<float*>(smem + lay.ml);
  float* const l = m + T;
  float* const wml = reinterpret_cast<float*>(smem + lay.wml);
  float* const wacc_all = reinterpret_cast<float*>(smem + lay.wacc);
  // this warp's state: m, l, alpha, acc, and its keys' scores
  const int warp = threadIdx.x / 32;
  float* const wm = wml + warp * 3 * T;
  float* const wl = wm + T;
  float* const walpha = wl + T;
  float* const wacc = wacc_all + warp * T * D;
  float* const wsc = reinterpret_cast<float*>(smem + lay.wsc) +
                     warp * T * kWarpKeys;
  int* const pos = reinterpret_cast<int*>(smem + lay.pos);
  int* const pages = reinterpret_cast<int*>(smem + lay.pages);
  __shared__ int ticket;

  // Every load that needs nothing loaded first, issued together: the
  // row's length and positions, q, and this split's page entries (all of
  // them, before the length says how many are visible) or the new keys
  // and values.
  const int32_t* pos_g = a.positions + static_cast<int64_t>(b) * T;
  const int len = a.lengths[b];
  const int p0 = split * a.split_pages;
  if (!new_keys) {
    const int32_t* table =
        a.page_table + static_cast<int64_t>(b) * a.n_pages;
    for (int i = threadIdx.x; i < min(a.split_pages, a.n_pages - p0);
         i += kThreads)
      pages[i] = table[p0 + i];
  } else {
    rows_f32<D>(kn, a.k_new, a.kv_dtype, b * a.k_sb + h * a.k_sh, a.k_st,
                T, a.k_vec);
    rows_f32<D>(vn, a.v_new, a.kv_dtype, b * a.v_sb + h * a.v_sh, a.v_st,
                T, a.v_vec);
  }
  for (int t = threadIdx.x; t < T; t += kThreads) pos[t] = pos_g[t];
  for (int i = threadIdx.x % 32; i < T; i += 32) {
    wm[i] = kNegInf;
    wl[i] = 0.f;
  }
  for (int e = threadIdx.x % 32; e < T * D; e += 32) wacc[e] = 0.f;
  rows_f32<D>(qs, a.q, a.q_dtype, b * a.q_sb + h * a.q_sh, a.q_st, T,
              a.q_vec);
  __syncthreads();

  // the row's visible history and this split's share of it
  int max_pos = INT_MIN;
  for (int t = 0; t < T; ++t) max_pos = max(max_pos, pos[t]);
  const int n_vis = max(0, min(min(len, max_pos + 1), a.n_pages * a.page_len));
  const int split_keys = a.split_pages * a.page_len;
  const int n_cache = (n_vis + split_keys - 1) / split_keys;
  if (!new_keys && split >= n_cache) return;  // no key: the merge skips it

  if (new_keys) {
    // -- the T new keys (T <= 16: warp 0's), causal by position (+ the
    // optional mask)
    if (warp == 0) {
      warp_scores<float, D>(reinterpret_cast<const unsigned char*>(kn), T,
                            qs, T, wsc);
      const uint8_t* mask = a.block_mask;
      warp_softmax(wsc, T, T, a.scale, nullptr, nullptr, wm, wl, walpha,
                   [&](int t, int j) {
                     return pos[j] <= pos[t] &&
                            (mask == nullptr || mask[t * T + j] != 0);
                   });
      warp_pv<float, D>(reinterpret_cast<const unsigned char*>(vn), T, wsc,
                        T, walpha, wacc);
    }
  } else {
    // -- this split's history, 64 keys a stage, 16 a warp ---------------
    const int k_begin = split * split_keys;
    const int k_end = min(n_vis, k_begin + split_keys);
    const int n_chunks = (k_end - k_begin + kChunk - 1) / kChunk;
    const int stage_bytes = kChunk * R::kBytes;
    stage_keys<PT, D>(a, sk, sv, scl, scl + kChunk, pages, h, k_begin,
                      k_begin, min(kChunk, k_end - k_begin));
    cp_async_commit();
    for (int c = 0; c < n_chunks; ++c) {
      const int st = c % a.stages;
      if (c + 1 < n_chunks) {
        __syncthreads();  // the stage refilled below (chunk c - 1's) is read
        const int nx = (c + 1) % a.stages;
        const int c1 = k_begin + (c + 1) * kChunk;
        stage_keys<PT, D>(a, sk + nx * stage_bytes, sv + nx * stage_bytes,
                          scl + nx * 2 * kChunk,
                          scl + nx * 2 * kChunk + kChunk, pages, h, k_begin,
                          c1, min(kChunk, k_end - c1));
      }
      cp_async_commit();
      cp_async_wait<1>();  // every group but the one just committed
      __syncthreads();
      // this warp's keys of the chunk: [c0, c0 + nw)
      const int c0 = k_begin + c * kChunk + warp * kWarpKeys;
      const int nw = min(kWarpKeys, k_end - c0);
      if (nw > 0) {
        const int kw = warp * kWarpKeys;  // in the stage
        warp_scores<PT, D>(sk + st * stage_bytes + kw * R::kBytes, nw, qs, T,
                           wsc);
        const float* ksc = kInt8 ? scl + st * 2 * kChunk + kw : nullptr;
        const float* vsc = kInt8 ? scl + st * 2 * kChunk + kChunk + kw
                                 : nullptr;
        warp_softmax(wsc, nw, T, a.scale, ksc, vsc, wm, wl, walpha,
                     [&](int t, int kk) { return c0 + kk <= pos[t]; });
        warp_pv<PT, D>(sv + st * stage_bytes + kw * R::kBytes, nw, wsc, T,
                       walpha, wacc);
      }
    }
    cp_async_wait<0>();
  }
  __syncthreads();
  combine_warps<D>(wml, wacc_all, T, m, l, acc);
  __syncthreads();

  // -- the ordered merge of the row's partials --------------------------
  const int n_act = n_cache + 1;
  if (n_act > 1) {
    const int stride = T * (D + 2);
    const int64_t bh = static_cast<int64_t>(b) * a.H + h;
    float* const ws = a.ws + bh * (a.n_splits + 1) * stride;
    float* const mine = ws + split * stride;
    for (int t = threadIdx.x; t < T; t += kThreads) {
      mine[t] = m[t];
      mine[T + t] = l[t];
    }
    for (int e = threadIdx.x; e < T * D; e += kThreads)
      mine[2 * T + e] = acc[e];
    __syncthreads();
    if (threadIdx.x == 0) ticket = take_ticket(a.tickets + bh);
    __syncthreads();
    if (ticket != n_act - 1) return;
    if (threadIdx.x == 0) a.tickets[bh] = 0;  // ready for the next call
    // One pass: item e < T * D is an element of acc, e >= T * D row
    // e - T * D's l.  The partials are read kMergeBatch at a time, every
    // load of a batch independent of the others, and summed in split
    // order (rescaled when a later batch raises the maximum).
    for (int e = threadIdx.x; e < T * (D + 1); e += kThreads) {
      const bool row = e >= T * D;
      const int t = row ? e - T * D : e / D;
      const int at = row ? T + t : 2 * T + e;  // l, or the element
      float mx = kNegInf, sum = 0.f;
      for (int i0 = 0; i0 < n_act; i0 += kMergeBatch) {
        float mv[kMergeBatch], xv[kMergeBatch];
#pragma unroll
        for (int k = 0; k < kMergeBatch; ++k) {
          const float* part =
              ws + part_index(min(i0 + k, n_act - 1), n_cache, a.n_splits) *
                       stride;
          mv[k] = i0 + k < n_act ? __ldcg(part + t) : kNegInf;
          xv[k] = i0 + k < n_act ? __ldcg(part + at) : 0.f;
        }
        float bm = mx;
#pragma unroll
        for (int k = 0; k < kMergeBatch; ++k) bm = fmaxf(bm, mv[k]);
        sum *= expf(mx - bm);
#pragma unroll
        for (int k = 0; k < kMergeBatch; ++k) sum += xv[k] * expf(mv[k] - bm);
        mx = bm;
      }
      if (row)
        l[t] = sum;
      else
        acc[e] = sum;
    }
    __syncthreads();
  }

  // -- normalise and write ---------------------------------------------
  const int64_t o0 = (static_cast<int64_t>(b) * a.H + h) * T * D;
  for (int e = threadIdx.x; e < T * D; e += kThreads) {
    const float lt = l[e / D];
    const float o = lt > 0.f ? acc[e] / lt : 0.f;
    if (a.q_dtype == kF32)
      store_f32(static_cast<float*>(a.out) + o0 + e, o);
    else
      store_f32(static_cast<bf16*>(a.out) + o0 + e, o);
  }
}

// ---------------------------------------------------------------------------
// 2. Prefill chunks on the tensor cores: bf16 q, bf16 or int8 pages
// ---------------------------------------------------------------------------

template <typename PT, int D>
struct Pf {
  static constexpr bool kInt8 = std::is_same<PT, int8_t>::value;
  static constexpr int kTile = kChunk * kLdOf<D>;  // bf16 elements
  // q, two stages of K and V (bf16 operands); int8: two stages of raw K
  // and V, their scales; then the tile's query and key positions and the
  // page window
  static constexpr int kRaw = kInt8 ? 4 * kChunk * D : 0;
  static constexpr int kScales = kInt8 ? 4 * kChunk * 4 : 0;
  static constexpr int kSmem =
      5 * kTile * 2 + kRaw + kScales + (2 * kChunk + kPageWin) * 4;
};

// Rows [r0, r0 + 64) of q, k_new or v_new (fp32 or bf16) for (b, h) into
// bf16 tiles: hi = bf16(x) and, when `lo` is given, lo = bf16(x - hi).
// Rows past T are zeros.
template <int D>
__device__ __forceinline__ void rows_bf16(bf16* hi, bf16* lo, const void* src,
                                          int dtype, int64_t base,
                                          int64_t row_stride, int r0, int T,
                                          bool vec) {
  for (int e = threadIdx.x; e < kChunk * (D / 4); e += kThreads) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T)
      x = load4(src, dtype, base + (r0 + r) * row_stride + c, vec);
    uint2 h2, l2;
    if (lo != nullptr) {
      split_bf16(x.x, x.y, h2.x, l2.x);
      split_bf16(x.z, x.w, h2.y, l2.y);
      *reinterpret_cast<uint2*>(lo + r * kLdOf<D> + c) = l2;
    } else {
      h2.x = pack_bf16(x.x, x.y);
      h2.y = pack_bf16(x.z, x.w);
    }
    *reinterpret_cast<uint2*>(hi + r * kLdOf<D> + c) = h2;
  }
}

// History keys [k0, k0 + 64) into a stage: bf16 pages straight into the
// operand tiles, int8 pages (and their scales) into the raw buffers;
// keys at or past k_end zero-filled.  `pg` holds the page entries from
// page w0 on.  Two threads a row, as stage_keys.
template <typename PT, int D>
__device__ __forceinline__ void stage_tile(const Args& a, bf16* kt, bf16* vt,
                                           int8_t* rk, int8_t* rv, float* ksc,
                                           float* vsc, const int* pg, int w0,
                                           int h, int k0, int k_end) {
  constexpr int kRowBytes = D * static_cast<int>(sizeof(PT));
  const int r = threadIdx.x / kRowThreads, part = threadIdx.x % kRowThreads;
  const int j = k0 + r;
  const bool valid = j < k_end;
  const int64_t tok = valid ? token_of(a, pg[j / a.page_len - w0], h, j) : 0;
  const unsigned char* pk =
      static_cast<const unsigned char*>(a.pool_k) + tok * kRowBytes;
  const unsigned char* pv =
      static_cast<const unsigned char*>(a.pool_v) + tok * kRowBytes;
#pragma unroll
  for (int c = part * 16; c < kRowBytes; c += kRowThreads * 16) {
    if constexpr (Pf<PT, D>::kInt8) {
      cp_async16(rk + r * D + c, pk + c, valid);
      cp_async16(rv + r * D + c, pv + c, valid);
    } else {
      cp_async16(kt + r * kLdOf<D> + c / 2, pk + c, valid);
      cp_async16(vt + r * kLdOf<D> + c / 2, pv + c, valid);
    }
  }
  if (Pf<PT, D>::kInt8 && part == 0) {
    cp_async4(ksc + r, a.k_scale + tok, valid);
    cp_async4(vsc + r, a.v_scale + tok, valid);
  }
}

// int8 rows of a staged tile into bf16 operand rows (exact: |v| <= 127).
template <int D>
__device__ __forceinline__ void widen_tile(bf16* dst, const int8_t* src) {
  for (int e = threadIdx.x; e < kChunk * (D / 4); e += kThreads) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    const uint32_t w = *reinterpret_cast<const uint32_t*>(src + r * D + c);
    uint2 o;
    o.x = pack_bf16(static_cast<float>(static_cast<int8_t>(w)),
                    static_cast<float>(static_cast<int8_t>(w >> 8)));
    o.y = pack_bf16(static_cast<float>(static_cast<int8_t>(w >> 16)),
                    static_cast<float>(static_cast<int8_t>(w >> 24)));
    *reinterpret_cast<uint2*>(dst + r * kLdOf<D> + c) = o;
  }
}

// One 64-key tile of a warp's online softmax on the accumulators: s[n][i]
// is row `rows[i >> 1]` (of the tile), key column 8 n + 2 t + (i & 1);
// bit 4 n + i of `vis` says whether it is visible (all are unless `edge`).
// The scores are scaled by `scale` (and the key scales `ksc`); p replaces
// them, times the value scales `vsc` when given, and l, m and acc move.
template <int D>
__device__ __forceinline__ void tile_softmax(float (&s)[8][4], uint32_t vis,
                                             bool edge, float scale,
                                             const float* ksc,
                                             const float* vsc, float (&m)[2],
                                             float (&l)[2],
                                             float (&acc)[D / 8][4]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = s[n][i] * scale;
      if (ksc != nullptr) x *= ksc[n * 8 + 2 * t + (i & 1)];
      s[n][i] = (!edge || (vis >> (4 * n + i) & 1)) ? x : kNegInf;
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mx = fmaxf(mx, fmaxf(s[n][2 * hh], s[n][2 * hh + 1]));
    const float m_new = fmaxf(m[hh], quad_max(mx));
    const float al = exp2_ftz((m[hh] - m_new) * kLog2e);
    const float m_l2 = m_new * kLog2e;
    float rs = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = 2 * hh + j;
        float p = exp2_ftz(fmaf(s[n][i], kLog2e, -m_l2));
        if (edge && !(vis >> (4 * n + i) & 1)) p = 0.f;
        rs += p;
        s[n][i] = vsc != nullptr ? p * vsc[n * 8 + 2 * t + j] : p;
      }
    l[hh] = al * l[hh] + quad_sum(rs);
    m[hh] = m_new;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][2 * hh] *= al;
      acc[i][2 * hh + 1] *= al;
    }
  }
}

// The scores of this warp's 16 rows against a staged key tile: s = q.k^T
// (+ q.lo^T when `lo` is given).
template <int D>
__device__ __forceinline__ void tile_scores(float (&s)[8][4],
                                            const uint32_t (&qf)[D / 16][4],
                                            const bf16* kt, const bf16* lo) {
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) s[x][y] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    mma_scores<D>(s, qf[kk], kt, kk);
    if (lo != nullptr) mma_scores<D>(s, qf[kk], lo, kk);
  }
}

// acc += p . v for a staged value tile, p split into hi + lo; with `lo`
// (fp32 values split likewise) also + p_hi . lo.
template <int D>
__device__ __forceinline__ void tile_pv(float (&acc)[D / 8][4],
                                        const float (&s)[8][4],
                                        const bf16* vt, const bf16* lo) {
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    uint32_t ph[4], pl[4];
    a_frag<true>(s, kk, ph, pl);
    mma_rows<D, true>(acc, ph, pl, vt, kk);
    if (lo != nullptr) mma_rows<D, false>(acc, ph, pl, lo, kk);
  }
}

template <typename PT, int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_tc(const Args a) {
  using P = Pf<PT, D>;
  constexpr int kT = P::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const qs = reinterpret_cast<bf16*>(smem);
  bf16* const kts = qs + kT;       // two stages
  bf16* const vts = kts + 2 * kT;  // two stages
  int8_t* const raw = reinterpret_cast<int8_t*>(vts + 2 * kT);  // [st][k|v]
  float* const scl = reinterpret_cast<float*>(raw + P::kRaw);   // [st][k|v]
  int* const posq = reinterpret_cast<int*>(scl + P::kScales / 4);
  int* const posk = posq + kChunk;
  int* const pg = posk + kChunk;
  __shared__ int red[3];  // max and min query position; min key position

  // blockIdx.x: (query tile, split); splits 0 .. n_splits - 1 hold the
  // history, split_keys a split, the n_new after them the T new keys, one
  // 64-key tile a split
  const int split_keys = a.split_pages * kChunk;  // split_pages: tiles here
  const int n_new = (a.T + kChunk - 1) / kChunk;
  const int n_all = a.n_splits + n_new;
  const int qt = blockIdx.x / n_all, split = blockIdx.x % n_all;
  const bool new_keys = split >= a.n_splits;
  const int b = blockIdx.z, h = blockIdx.y, q0 = qt * kChunk;
  const int T = a.T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int32_t* pos_g = a.positions + static_cast<int64_t>(b) * T;
  const int len = a.lengths[b];
  // a history split's keys and the entries of every page they can touch
  // (the host sizes a split to at most kPageWin - 2 pages' keys), loaded
  // before the length says how many are visible
  // A new-key split's tile: hi in stage 0, lo (fp32 inputs) in stage 1.
  const int k_begin = new_keys ? 0 : split * split_keys;
  const int w0 = k_begin / a.page_len;
  const int t0 = (split - a.n_splits) * kChunk;
  const bool split_kv = a.kv_dtype == kF32;
  bf16* const khi = kts;
  bf16* const klo = split_kv ? kts + kT : nullptr;
  bf16* const vhi = vts;
  bf16* const vlo = split_kv ? vts + kT : nullptr;
  if (!new_keys) {
    const int n_pg =
        min(a.n_pages, (k_begin + split_keys - 1) / a.page_len + 1) - w0;
    for (int i = threadIdx.x; i < n_pg; i += kThreads)
      pg[i] = a.page_table[static_cast<int64_t>(b) * a.n_pages + w0 + i];
  } else {
    if (threadIdx.x < kChunk)
      posk[threadIdx.x] = t0 + threadIdx.x < T ? pos_g[t0 + threadIdx.x]
                                               : INT_MAX;
    rows_bf16<D>(khi, klo, a.k_new, a.kv_dtype, b * a.k_sb + h * a.k_sh,
                 a.k_st, t0, T, a.k_vec);
    rows_bf16<D>(vhi, vlo, a.v_new, a.kv_dtype, b * a.v_sb + h * a.v_sh,
                 a.v_st, t0, T, a.v_vec);
  }
  if (threadIdx.x == 0) {
    red[0] = INT_MIN;
    red[1] = red[2] = INT_MAX;
  }
  if (threadIdx.x < kChunk)
    posq[threadIdx.x] =
        q0 + threadIdx.x < T ? pos_g[q0 + threadIdx.x] : INT_MIN;
  rows_bf16<D>(qs, nullptr, a.q, kBf16, b * a.q_sb + h * a.q_sh, a.q_st, q0,
               T, a.q_vec);
  __syncthreads();
  if (threadIdx.x < kChunk && q0 + threadIdx.x < T) {
    atomicMax(&red[0], posq[threadIdx.x]);
    atomicMin(&red[1], posq[threadIdx.x]);
  }
  if (new_keys && threadIdx.x < kChunk) atomicMin(&red[2], posk[threadIdx.x]);
  __syncthreads();
  const int qmax = red[0], qmin = red[1], kmin = red[2];
  const int n_vis = max(0, min(min(len, qmax + 1), a.n_pages * a.page_len));
  const int n_cache = (n_vis + split_keys - 1) / split_keys;
  if (!new_keys && split >= n_cache) return;  // no key: the merge skips it
  // keys below `full` are visible to every row of the tile
  const int full = max(0, min(len, qmin + 1));
  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};  // rows in the tile

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) a_rows<D>(qf[kk], qs, warp * 16, kk);
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (!new_keys) {
    // -- this split's history, 64 keys a tile through a two-stage ring --
    const int k_end = min(n_vis, k_begin + split_keys);
    const int kb0 = k_begin / kChunk;
    const int nkt = (k_end - k_begin + kChunk - 1) / kChunk;
    auto stage = [&](int i) {
      const int st = i & 1;
      stage_tile<PT, D>(a, kts + st * kT, vts + st * kT,
                        raw + st * 2 * kChunk * D,
                        raw + st * 2 * kChunk * D + kChunk * D,
                        scl + st * 2 * kChunk, scl + st * 2 * kChunk + kChunk,
                        pg, w0, h, (kb0 + i) * kChunk, k_end);
    };
    stage(0);
    cp_async_commit();
    for (int i = 0; i < nkt; ++i) {
      const int st = i & 1, k0 = (kb0 + i) * kChunk;
      __syncthreads();  // the stage refilled below (tile i - 1's) is consumed
      if (i + 1 < nkt) stage(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      bf16* const kt = kts + st * kT;
      bf16* const vt = vts + st * kT;
      const float* ksc = nullptr;
      const float* vsc = nullptr;
      if (P::kInt8) {
        widen_tile<D>(kt, raw + st * 2 * kChunk * D);
        widen_tile<D>(vt, raw + st * 2 * kChunk * D + kChunk * D);
        ksc = scl + st * 2 * kChunk;
        vsc = ksc + kChunk;
        __syncthreads();
      }
      float s[8][4];
      tile_scores<D>(s, qf, kt, nullptr);
      const bool edge = k0 + kChunk > full;
      uint32_t vis = ~0u;
      if (edge) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = k0 + n * 8 + 2 * t4 + (e & 1);
            if (j >= len || j > posq[rl[e >> 1]]) vis &= ~(1u << (4 * n + e));
          }
      }
      tile_softmax<D>(s, vis, edge, a.scale, ksc, vsc, m, l, acc);
      tile_pv<D>(acc, s, vt, nullptr);
    }
    cp_async_wait<0>();
  } else if (kmin <= qmax) {  // this split's new keys, when one is visible
    const uint8_t* mask = a.block_mask;
    float s[8][4];
    tile_scores<D>(s, qf, khi, klo);
    uint32_t vis = 0u;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        const int r = rl[e >> 1];
        bool ok = t0 + col < T && posk[col] <= posq[r];
        if (ok && mask != nullptr)
          ok = mask[static_cast<int64_t>(q0 + r) * T + t0 + col] != 0;
        if (ok) vis |= 1u << (4 * n + e);
      }
    tile_softmax<D>(s, vis, true, a.scale, nullptr, nullptr, m, l, acc);
    tile_pv<D>(acc, s, vhi, vlo);
  }

  // -- the ordered merge of the query tile's partials -------------------
  // A partial is (m, l) of the 64 rows, then acc [64][D]: each thread
  // writes and reads the elements of its own fragments.
  const int n_act = n_cache + n_new;
  if (n_act > 1) {
    const int stride = kChunk * (D + 2);
    const int n_qt = gridDim.x / n_all;
    const int64_t tile = (static_cast<int64_t>(b) * a.H + h) * n_qt + qt;
    float* const ws = a.ws + tile * n_all * stride;
    float* const mine = ws + split * stride;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (t4 == 0) {
        mine[rl[hh]] = m[hh];
        mine[kChunk + rl[hh]] = l[hh];
      }
#pragma unroll
      for (int x = 0; x < D / 8; ++x)
        *reinterpret_cast<float2*>(mine + 2 * kChunk + rl[hh] * D + x * 8 +
                                   2 * t4) =
            make_float2(acc[x][2 * hh], acc[x][2 * hh + 1]);
    }
    __syncthreads();
    if (threadIdx.x == 0) red[2] = take_ticket(a.tickets + tile);
    __syncthreads();
    if (red[2] != n_act - 1) return;
    if (threadIdx.x == 0) a.tickets[tile] = 0;  // ready for the next call
    // Each thread's two rows, the partials read four at a time (every
    // load of a batch independent of the others) and summed in split
    // order, rescaled when a later batch raises the maximum.
    constexpr int kB4 = 4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rl[hh];
      float mx = kNegInf, lsum = 0.f;
      float a0[D / 8], a1[D / 8];
#pragma unroll
      for (int x = 0; x < D / 8; ++x) a0[x] = a1[x] = 0.f;
      for (int i0 = 0; i0 < n_act; i0 += kB4) {
        float mv[kB4], lv[kB4];
        float2 v[kB4][D / 8];
#pragma unroll
        for (int k = 0; k < kB4; ++k) {
          const bool in = i0 + k < n_act;
          const float* part =
              ws + part_index(min(i0 + k, n_act - 1), n_cache, a.n_splits) *
                       stride;
          mv[k] = in ? __ldcg(part + r) : kNegInf;
          lv[k] = in ? __ldcg(part + kChunk + r) : 0.f;
#pragma unroll
          for (int x = 0; x < D / 8; ++x)
            v[k][x] = in ? __ldcg(reinterpret_cast<const float2*>(
                               part + 2 * kChunk + r * D + x * 8 + 2 * t4))
                         : make_float2(0.f, 0.f);
        }
        float bm = mx;
#pragma unroll
        for (int k = 0; k < kB4; ++k) bm = fmaxf(bm, mv[k]);
        const float rs = expf(mx - bm);
        lsum *= rs;
#pragma unroll
        for (int x = 0; x < D / 8; ++x) {
          a0[x] *= rs;
          a1[x] *= rs;
        }
#pragma unroll
        for (int k = 0; k < kB4; ++k) {
          const float w = expf(mv[k] - bm);
          lsum += lv[k] * w;
#pragma unroll
          for (int x = 0; x < D / 8; ++x) {
            a0[x] += v[k][x].x * w;
            a1[x] += v[k][x].y * w;
          }
        }
        mx = bm;
      }
      l[hh] = lsum;
#pragma unroll
      for (int x = 0; x < D / 8; ++x) {
        acc[x][2 * hh] = a0[x];
        acc[x][2 * hh + 1] = a1[x];
      }
    }
  }

  // -- normalise and write ---------------------------------------------
  bf16* const out = static_cast<bf16*>(a.out) +
                    (static_cast<int64_t>(b) * a.H + h) * T * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + rl[hh];
    if (t >= T) continue;
    const float inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(t) * D +
                                         i * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[i][2 * hh] * inv,
                                acc[i][2 * hh + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// 3. fp32 prefill (fp32 q or fp32 pages): FMA kernel
// ---------------------------------------------------------------------------

constexpr int kDPerLane = kMaxD / 32;
constexpr int kKeys = 32;
constexpr int kMaxRowsPerWarp = 4;
constexpr int kMaxTile = kWarps * kMaxRowsPerWarp;

// Shared state of one block.
struct Smem {
  float q[kMaxTile][kMaxD];     // scaled query tile
  float k[kKeys][kMaxD + 1];    // staged keys, padded rows
  float v[kKeys][kMaxD];        // staged values
  float p[kWarps][kKeys];       // one warp's probabilities for a chunk
};

// One online-softmax step of a warp's row over a staged chunk of nk keys:
// lane `lane` holds score `s` of key `lane`, valid or not.
__device__ __forceinline__ void online_update(
    Smem& sm, int warp, int lane, int nk, int D, bool valid, float s,
    float& m, float& l, float (&acc)[kDPerLane]) {
  const float m_new = fmaxf(m, warp_max(valid ? s : kNegInf));
  const float alpha = expf(m - m_new);
  const float p = valid ? expf(s - m_new) : 0.f;
  l = l * alpha + warp_sum(p);
  sm.p[warp][lane] = p;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kDPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) {
      float a = acc[i] * alpha;
      for (int kk = 0; kk < nk; ++kk) a += sm.p[warp][kk] * sm.v[kk][d];
      acc[i] = a;
    }
  }
  __syncwarp();
  m = m_new;
}

__device__ __forceinline__ float dot_row(const Smem& sm, int r, int key,
                                         int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s += sm.q[r][d] * sm.k[key][d];
  return s;
}

// One block of four warps owns one (b, h, tile of up to 16 query rows);
// each warp up to four rows, a lane one staged key.
template <typename QT, typename KT, typename PT>
__global__ void __launch_bounds__(kThreads)
paged_fma_kernel(const Args a) {
  __shared__ Smem sm;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int D = a.D;
  const int T = a.T;
  const int rpw = min(kMaxRowsPerWarp, (T + kWarps - 1) / kWarps);
  const int tile_rows = kWarps * rpw;
  const int t0 = blockIdx.x * tile_rows;
  const int32_t* pos = a.positions + static_cast<int64_t>(b) * T;

  // the scaled query tile; rows past T are zeros nobody reads
  const QT* q = static_cast<const QT*>(a.q) + b * a.q_sb + h * a.q_sh;
  for (int i = threadIdx.x; i < tile_rows * D; i += kThreads) {
    const int r = i / D, d = i % D, t = t0 + r;
    sm.q[r][d] = t < T ? load_f32(q + t * a.q_st + d) * a.scale : 0.f;
  }
  int max_pos = -1;
  for (int r = 0; r < tile_rows && t0 + r < T; ++r)
    max_pos = max(max_pos, pos[t0 + r]);
  const int len = a.lengths[b];
  const int n_vis =
      max(0, min(min(len, max_pos + 1), a.n_pages * a.page_len));

  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp];
  float acc[kMaxRowsPerWarp][kDPerLane];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDPerLane; ++j) acc[i][j] = 0.f;
  }
  __syncthreads();

  // -- the history, read through the page table ------------------------
  const PT* pk = static_cast<const PT*>(a.pool_k);
  const PT* pv = static_cast<const PT*>(a.pool_v);
  for (int c0 = 0; c0 < n_vis; c0 += kKeys) {
    const int nk = min(kKeys, n_vis - c0);
    for (int i = threadIdx.x; i < kKeys * D; i += kThreads) {
      const int kk = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (kk < nk) {
        const int j = c0 + kk;
        const int64_t tok = token_of(
            a, a.page_table[static_cast<int64_t>(b) * a.n_pages +
                            j / a.page_len], h, j);
        kv = load_f32(pk + tok * D + d);
        vv = load_f32(pv + tok * D + d);
        if (a.k_scale != nullptr) {
          kv *= a.k_scale[tok];
          vv *= a.v_scale[tok];
        }
      }
      sm.k[kk][d] = kv;
      sm.v[kk][d] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      const int r = warp * rpw + i;
      if (i >= rpw || t0 + r >= T) continue;  // uniform across the warp
      const int j = c0 + lane;
      const bool valid = lane < nk && j < len && j <= pos[t0 + r];
      const float s = valid ? dot_row(sm, r, lane, D) : kNegInf;
      online_update(sm, warp, lane, nk, D, valid, s, m[i], l[i], acc[i]);
    }
    __syncthreads();
  }

  // -- the T new keys, causal by position (+ the optional mask) --------
  const KT* kn = static_cast<const KT*>(a.k_new) + b * a.k_sb + h * a.k_sh;
  const KT* vn = static_cast<const KT*>(a.v_new) + b * a.v_sb + h * a.v_sh;
  for (int c0 = 0; c0 < T; c0 += kKeys) {
    const int nk = min(kKeys, T - c0);
    for (int i = threadIdx.x; i < kKeys * D; i += kThreads) {
      const int kk = i / D, d = i % D;
      const bool in = kk < nk;
      sm.k[kk][d] = in ? load_f32(kn + (c0 + kk) * a.k_st + d) : 0.f;
      sm.v[kk][d] = in ? load_f32(vn + (c0 + kk) * a.v_st + d) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      const int r = warp * rpw + i;
      const int t = t0 + r;
      if (i >= rpw || t >= T) continue;
      const int tk = c0 + lane;
      bool valid = lane < nk && pos[tk < T ? tk : 0] <= pos[t];
      if (valid && a.block_mask != nullptr)
        valid = a.block_mask[static_cast<int64_t>(t) * T + tk] != 0;
      const float s = valid ? dot_row(sm, r, lane, D) : kNegInf;
      online_update(sm, warp, lane, nk, D, valid, s, m[i], l[i], acc[i]);
    }
    __syncthreads();
  }

  // -- normalise and write ---------------------------------------------
  QT* out = static_cast<QT*>(a.out);
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    const int t = t0 + warp * rpw + i;
    if (i >= rpw || t >= T) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    QT* o = out + ((static_cast<int64_t>(b) * a.H + h) * T + t) * D;
#pragma unroll
    for (int j = 0; j < kDPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < D) store_f32(o + d, acc[i][j] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch_dyn(K kern, dim3 grid, int smem, const Args& a,
                       cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename PT>
cudaError_t launch_decode(const Args& a, cudaStream_t s) {
  const dim3 grid(a.n_splits + 1, a.H, a.B);  // + the new keys' split
  const int smem =
      dec_smem(a.T, a.D, sizeof(PT), a.stages, a.split_pages).total;
  switch (a.D) {
    case 32: return launch_dyn(paged_decode_kernel<PT, 32>, grid, smem, a, s);
    case 64: return launch_dyn(paged_decode_kernel<PT, 64>, grid, smem, a, s);
    case 96: return launch_dyn(paged_decode_kernel<PT, 96>, grid, smem, a, s);
    case 128:
      return launch_dyn(paged_decode_kernel<PT, 128>, grid, smem, a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename PT>
cudaError_t launch_prefill_tc(const Args& a, cudaStream_t s) {
  const int n_qt = (a.T + kChunk - 1) / kChunk;
  const dim3 grid(n_qt * (a.n_splits + n_qt), a.H, a.B);  // + new-key tiles
  switch (a.D) {
    case 32: return launch_dyn(paged_prefill_tc<PT, 32>, grid,
                               Pf<PT, 32>::kSmem, a, s);
    case 64: return launch_dyn(paged_prefill_tc<PT, 64>, grid,
                               Pf<PT, 64>::kSmem, a, s);
    case 96: return launch_dyn(paged_prefill_tc<PT, 96>, grid,
                               Pf<PT, 96>::kSmem, a, s);
    case 128: return launch_dyn(paged_prefill_tc<PT, 128>, grid,
                                Pf<PT, 128>::kSmem, a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT, typename KT>
cudaError_t launch_fma_pool(const Args& a, int pool_dtype, cudaStream_t s) {
  const int rpw = std::min(kMaxRowsPerWarp, (a.T + kWarps - 1) / kWarps);
  const int tile = kWarps * rpw;
  const dim3 grid((a.T + tile - 1) / tile, a.H, a.B);
  switch (pool_dtype) {
    case kF32:
      paged_fma_kernel<QT, KT, float><<<grid, kThreads, 0, s>>>(a);
      break;
    case kBf16:
      paged_fma_kernel<QT, KT, bf16><<<grid, kThreads, 0, s>>>(a);
      break;
    case kI8:
      paged_fma_kernel<QT, KT, int8_t><<<grid, kThreads, 0, s>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// fp32 q with any new keys and pages, or bf16 q with fp32 pages (bf16 q
// with bf16 or int8 pages takes the tensor cores).
cudaError_t launch_fma(const Args& a, int pool_dtype, cudaStream_t s) {
  if (a.q_dtype == kF32)
    return a.kv_dtype == kF32 ? launch_fma_pool<float, float>(a, pool_dtype, s)
                              : launch_fma_pool<float, bf16>(a, pool_dtype, s);
  if (pool_dtype != kF32) return cudaErrorInvalidValue;
  return a.kv_dtype == kF32 ? launch_fma_pool<bf16, float>(a, kF32, s)
                            : launch_fma_pool<bf16, bf16>(a, kF32, s);
}

// Rows of `es`-byte elements at `p` + b sb + h sh + t st may be read 16
// bytes (fp32) or 8 bytes (bf16) at a time.
bool vec_ok(const void* p, int es, int64_t sb, int64_t sh, int64_t st) {
  const int64_t align = es == 4 ? 16 : 8;
  const int64_t elems = align / es;
  return reinterpret_cast<uintptr_t>(p) % align == 0 && sb % elems == 0 &&
         sh % elems == 0 && st % elems == 0;
}

}  // namespace

// ptrs (host array, 14 entries, in this order): q, k_new, v_new, pool_k,
//   pool_v, k_scale, v_scale, page_table, lengths, positions, block_mask,
//   out, ws, tickets.
// dims (host array, 20 int64 entries, in this order): B, H, T, D, L,
//   layer, page_len, n_pages, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb,
//   v_sh, v_st, split, n_splits, design.
// design: 0 the fp32 FMA kernel (any dtypes), 1 the decode kernel (T <=
//   16), 2 the tensor-core prefill kernel (bf16 q, bf16 or int8 pages).
// The decode and tensor-core kernels split the history: `split` pages a
//   split for the first, `split` 64-key tiles (at most kPageWin - 2
//   pages) for the second, n_splits splits covering all n_pages pages;
//   the new keys are one more split (decode) or one more a 64-key tile
//   (tensor cores).  Both take ws, an fp32 partial of T (decode) or 64
//   rows of D + 2 values for each split of each (b, h) and, tensor
//   cores, each 64-row query tile, and tickets, one int for each of those
//   rows or tiles, 0 on entry (the kernels leave them 0).  The fp32
//   kernel takes neither.
// dtype codes: q / k_new+v_new: 0 float32, 1 bfloat16; pool: 0 float32,
//   1 bfloat16, 2 int8.  Pools start on 16 bytes.  D is 32, 64, 96 or 128.
// Returns cudaGetLastError() after the launch.
extern "C" int apex_paged_attention(const void* ptrs_, const void* dims_,
                                    float scale, int q_dtype, int kv_dtype,
                                    int pool_dtype, void* stream) {
  const void* const* p = static_cast<const void* const*>(ptrs_);
  const long long* d = static_cast<const long long*>(dims_);
  Args a;
  a.q = p[0];
  a.k_new = p[1];
  a.v_new = p[2];
  a.pool_k = p[3];
  a.pool_v = p[4];
  a.k_scale = static_cast<const float*>(p[5]);
  a.v_scale = static_cast<const float*>(p[6]);
  a.page_table = static_cast<const int32_t*>(p[7]);
  a.lengths = static_cast<const int32_t*>(p[8]);
  a.positions = static_cast<const int32_t*>(p[9]);
  a.block_mask = static_cast<const uint8_t*>(p[10]);
  a.out = const_cast<void*>(p[11]);
  a.ws = static_cast<float*>(const_cast<void*>(p[12]));
  a.tickets = static_cast<int*>(const_cast<void*>(p[13]));
  a.B = static_cast<int>(d[0]);
  a.H = static_cast<int>(d[1]);
  a.T = static_cast<int>(d[2]);
  a.D = static_cast<int>(d[3]);
  a.L = static_cast<int>(d[4]);
  a.layer = static_cast<int>(d[5]);
  a.page_len = static_cast<int>(d[6]);
  a.n_pages = static_cast<int>(d[7]);
  a.q_sb = d[8];
  a.q_sh = d[9];
  a.q_st = d[10];
  a.k_sb = d[11];
  a.k_sh = d[12];
  a.k_st = d[13];
  a.v_sb = d[14];
  a.v_sh = d[15];
  a.v_st = d[16];
  a.split_pages = static_cast<int>(d[17]);
  a.n_splits = static_cast<int>(d[18]);
  a.scale = scale;
  a.q_dtype = q_dtype;
  a.kv_dtype = kv_dtype;
  const int q_es = q_dtype == kF32 ? 4 : 2, kv_es = kv_dtype == kF32 ? 4 : 2;
  a.q_vec = vec_ok(a.q, q_es, a.q_sb, a.q_sh, a.q_st);
  a.k_vec = vec_ok(a.k_new, kv_es, a.k_sb, a.k_sh, a.k_st);
  a.v_vec = vec_ok(a.v_new, kv_es, a.v_sb, a.v_sh, a.v_st);
  if (a.D % 32 != 0 || a.D > kMaxD || a.T < 1 || a.B < 1 || a.H < 1 ||
      q_dtype < kF32 || q_dtype > kBf16 || kv_dtype < kF32 ||
      kv_dtype > kBf16 || pool_dtype < kF32 || pool_dtype > kI8 ||
      reinterpret_cast<uintptr_t>(a.pool_k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.pool_v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int design = static_cast<int>(d[19]);
  if (design != kFma && (a.ws == nullptr || a.tickets == nullptr ||
                         a.split_pages < 1 || a.n_splits < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (design == kDecode) {
    if (a.T > kDecodeMaxT) return static_cast<int>(cudaErrorInvalidValue);
    if (a.n_splits * a.split_pages < a.n_pages)
      return static_cast<int>(cudaErrorInvalidValue);
    a.stages = a.split_pages * a.page_len > kChunk ? 2 : 1;
    err = pool_dtype == kF32    ? launch_decode<float>(a, s)
          : pool_dtype == kBf16 ? launch_decode<bf16>(a, s)
                                : launch_decode<int8_t>(a, s);
  } else if (design == kTensorCores) {
    if (q_dtype != kBf16 || pool_dtype == kF32)
      return static_cast<int>(cudaErrorInvalidValue);
    // split_pages counts 64-key tiles here; a split's pages fit the window
    const int64_t keys = static_cast<int64_t>(a.split_pages) * kChunk;
    if (keys > static_cast<int64_t>(kPageWin - 2) * a.page_len ||
        a.n_splits * keys < static_cast<int64_t>(a.n_pages) * a.page_len)
      return static_cast<int>(cudaErrorInvalidValue);
    err = pool_dtype == kBf16 ? launch_prefill_tc<bf16>(a, s)
                              : launch_prefill_tc<int8_t>(a, s);
  } else if (design == kFma) {
    err = launch_fma(a, pool_dtype, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
