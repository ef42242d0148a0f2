// Paged attention for serving: T new query tokens per row attend to the
// row's KV history, read through its page table, plus the T new keys.
//
// Replaces: apex_tpu/ops/attention.py::_paged_fused_kernel (launched by
// paged_fused_attention).  Same function: cache key j is visible to query
// t iff j < len[b] and j <= pos[b, t]; new key t' iff pos[b, t'] <=
// pos[b, t] (and block_mask[t, t'] when a mask is given); q is scaled by
// `scale` before the dots; int8 pages are dequantized against their
// per-token fp32 scales; all softmax and accumulation math is fp32; the
// output is written in q's dtype.
//
// Bound on the H100: bytes.  At decode (T = 1) every visible K and V
// element is read once for one query, so a call moves 2 * B * H * len * D
// pool elements and does 4 flops per element: far below the card's
// flop-to-byte ratio.  Prefill chunks (T up to 512) reuse each staged key
// T times and move toward the operation bound.
//
// Design.  The TPU kernel assembled a whole row's (H, S, D) K and V in
// fp32 VMEM before one softmax; at S = 1024 that is 3 MB per tensor and a
// Hopper block has 227 KB of shared memory.  Here one block of four warps
// owns one (b, h, tile of up to 16 query rows):
//   - the block reads page_table[b, j / page_len] itself (no scalar
//     prefetch) and walks keys only up to min(len[b], largest tile
//     position + 1): keys past that are masked for every row of the tile,
//     so skipping them is exact;
//   - keys are staged 32 at a time in shared memory as fp32, dequantized
//     on the way in (K rows padded by one float so the per-lane dot
//     products hit 32 different banks);
//   - each warp owns up to four query rows; a lane scores one staged key,
//     and the warp keeps an online softmax per row (running max, running
//     sum, fp32 accumulator with D / 32 values per lane), first over the
//     cache keys and then over the T new keys;
//   - a masked key contributes exactly 0, and every row sees at least its
//     own new key, so the result equals the reference's single softmax up
//     to the order of the sums.
// The staged loads are plain coalesced loads; cp.async or TMA double
// buffering, split-K over pages for long histories and tensor-core dots
// for long prefill chunks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;
constexpr int kDPerLane = kMaxD / 32;
constexpr int kKeys = 32;
constexpr int kMaxRowsPerWarp = 4;
constexpr int kMaxTile = kWarps * kMaxRowsPerWarp;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f32(const int8_t* p) {
  return static_cast<float>(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
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
  int64_t q_sb, q_sh, q_st;   // element strides of q, k_new, v_new
  int64_t k_sb, k_sh, k_st;
  int64_t v_sb, v_sh, v_st;
  int B, H, T, D, L, layer, page_len, n_pages, rows_per_warp;
  float scale;
};

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

template <typename QT, typename KT, typename PT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Args a) {
  __shared__ Smem sm;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int D = a.D;
  const int T = a.T;
  const int rpw = a.rows_per_warp;
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
        const int64_t page = a.page_table[static_cast<int64_t>(b) *
                                              a.n_pages + j / a.page_len];
        const int64_t tok =
            ((page * a.L + a.layer) * a.H + h) * a.page_len + j % a.page_len;
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
    const float inv = 1.f / l[i];
    QT* o = out + ((static_cast<int64_t>(b) * a.H + h) * T + t) * D;
#pragma unroll
    for (int j = 0; j < kDPerLane; ++j) {
      const int d = lane + 32 * j;
      if (d < D) store_f32(o + d, acc[i][j] * inv);
    }
  }
}

template <typename QT, typename KT>
cudaError_t launch_pool(const Args& a, int pool_dtype, dim3 grid,
                        cudaStream_t s) {
  switch (pool_dtype) {
    case 0:
      paged_attention_kernel<QT, KT, float><<<grid, kThreads, 0, s>>>(a);
      break;
    case 1:
      paged_attention_kernel<QT, KT, __nv_bfloat16>
          <<<grid, kThreads, 0, s>>>(a);
      break;
    case 2:
      paged_attention_kernel<QT, KT, int8_t><<<grid, kThreads, 0, s>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_kv(const Args& a, int kv_dtype, int pool_dtype,
                      dim3 grid, cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return launch_pool<QT, float>(a, pool_dtype, grid, s);
    case 1:
      return launch_pool<QT, __nv_bfloat16>(a, pool_dtype, grid, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ptrs (host array, 12 entries, in this order): q, k_new, v_new, pool_k,
//   pool_v, k_scale, v_scale, page_table, lengths, positions, block_mask,
//   out.
// dims (host array, 17 int64 entries, in this order): B, H, T, D, L,
//   layer, page_len, n_pages, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb,
//   v_sh, v_st.
// dtype codes: q / k_new+v_new: 0 float32, 1 bfloat16; pool: 0 float32,
//   1 bfloat16, 2 int8.  The caller guarantees D % 32 == 0, D <= 128.
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
  a.scale = scale;
  if (a.D % 32 != 0 || a.D > kMaxD || a.T < 1 || a.B < 1 || a.H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  a.rows_per_warp = std::min(kMaxRowsPerWarp, (a.T + kWarps - 1) / kWarps);
  const int tile = kWarps * a.rows_per_warp;
  const dim3 grid((a.T + tile - 1) / tile, a.H, a.B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype) {
    case 0:
      err = launch_kv<float>(a, kv_dtype, pool_dtype, grid, s);
      break;
    case 1:
      err = launch_kv<__nv_bfloat16>(a, kv_dtype, pool_dtype, grid, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
