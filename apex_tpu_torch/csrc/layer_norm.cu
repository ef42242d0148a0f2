// LayerNorm over the last axis: forward, and the backward with the
// dgamma/dbeta column sums.
//
// Replaces:
// - apex_tpu/ops/layer_norm.py::_ln_fwd_kernel (launched by _ln_fwd_pallas)
//   with apex_ln_fwd.  Same arithmetic: fp32 sums of x and x*x, variance
//   as E[x^2] - mean^2 (not Welford), rsqrt(var + eps), affine in fp32
//   (weight and bias fp32 or bf16, upcast), output rounded once to the
//   input dtype (fp32 or bf16, round to nearest even).
// - apex_tpu/ops/layer_norm.py::_ln_bwd_dx_dwdb_kernel (launched by
//   _ln_bwd_dx_dwdb_pallas) with apex_ln_bwd, and its non-affine twin
//   _ln_bwd_dx_kernel (_ln_bwd_dx_pallas) with the same entry point and a
//   null weight.  Same arithmetic as _ln_dx_math: mean and rstd recomputed
//   from x, dxhat = dy * w, m1 = mean(dxhat), m2 = mean(dxhat * xhat),
//   dx = rstd * (dxhat - m1 - xhat * m2); dgamma = sum_rows dy * xhat and
//   dbeta = sum_rows dy, in fp32, cast once to the weight's dtype.
//
// Bound on the H100: bytes.  The forward reads x once and writes y (at
// (16384, 768) fp32 100.7 MB: 30 us at 3.35 TB/s); the backward reads x
// and dy and writes dx (151 MB: 45 us), a few flops per byte.
//
// Each direction has three designs.  The wrapper (ops/layer_norm.py:
// _ln_fwd_design, _ln_bwd_design) picks one and passes its code; this
// file runs what a code names and refuses a call that the code's kernel
// cannot take.  Every sum is taken in one fixed order, so an input gives
// the same bits on every run; no atomics anywhere.
//
// The warp designs (code 1), for rows of n <= 1024 that are a whole
// number of 16-byte vectors, with 16-byte aligned x, y, dy and dx (every
// ported model: 768 and 1024).  One warp owns a row; each lane holds its
// share of the row in registers as 16-byte vectors (6 float4 a lane at
// n = 768 fp32, 3 uint4 for bf16; lane l's vector v covers columns
// (32 v + l) * VW ..., so a warp's load is 512 contiguous bytes).
// Instantiated for the vector counts of n = 768 and n = 1024 alone
// (narrower rows take the 768 one, their vectors past n masked).  The
// row sums reduce by xor shuffles alone: no shared memory and no block
// barrier per row.  A warp issues its next row's loads before it reduces
// the current one, so each warp keeps two rows of reads in flight.
// Blocks of four warps are persistent, as many as fit on the SMs at once.
// - Forward (ln_fwd_warp_kernel): warp w of block b takes rows
//   b * 4 + w, then every 4 * gridDim.x-th row after it.  y is written
//   from the registers that hold x, so x is read from memory once, and
//   every store is 16 bytes.  Weight and bias sit in shared memory as
//   fp32 (8 KB a block, filled once while the block's first rows load)
//   and are read each row as 16-byte shared-memory vectors: holding them
//   in registers instead would double a lane's registers at n = 1024
//   fp32 (x, the next row's x, w and b: 128 values), which costs blocks
//   an SM and with them rows of loads in flight, the one thing a
//   bytes-bound kernel needs; the shared reads are conflict-free for fp32
//   x and cost a few cycles a row.
// - Backward (ln_bwd_warp_kernel): block b owns rows [b R, b R + R) (R
//   from apex_ln_bwd_geometry), warp w of it the rows w, w + 4, ... of
//   those.  Each lane carries the dgamma/dbeta partials of its columns in
//   registers across its rows; at the end the block adds its warps'
//   partials in warp order in shared memory and writes one (2, n)
//   partial.  w (or ones, without affine) is read from shared memory each
//   row.
//
// The block designs (code 0), every other row up to n = 8192: a block of
// 256 threads keeps a row's C = ceil(n / 256) columns a thread in
// registers (column j of a thread is threadIdx.x + 256 j), so the row is
// read once; the row sums reduce by warp shuffles and a fixed-order
// shared-memory step (two block barriers each).  The forward's blocks are
// persistent and walk the rows gridDim.x apart; the backward's own 16
// consecutive rows each.
//
// The wide designs (code 2), rows of any n (the wrapper sends those past
// 8192 here): a block of 1024 threads strides the row and reads it again
// from memory (the L2) for each pass instead of holding it: the forward
// twice (sums, then normalise and store), the backward three times
// (sums of x; sums of dxhat; dx and the partials).  Blocks are
// persistent, as many as fit on the SMs (2 an SM); the forward's walk the
// rows gridDim.x apart, the backward's own consecutive rows (the rows cut
// evenly) and keep their dgamma/dbeta partial in their own row of the
// partials buffer in device memory (each column updated by one thread, in
// row order) rather than in registers.  It does not replace the block
// designs: a block walks its rows one after another, each waiting on its
// reads and block barriers, and at rows the block designs take it runs
// 2-5x slower (tools/ln_ab.py's wide_ms; PERF.md section 6).
//
// dgamma/dbeta, every backward design: a second kernel (ln_dwdb_kernel)
// adds the (blocks, 2, n) partials: a block of 8 warps owns 32 of the 2n
// partial columns, warp w adds its contiguous eighth of the partial rows
// in order, then the eight warp sums are added in warp order and cast
// once; ceil(2n / 32) blocks (48 at n = 768).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 16;  // the backward's block design
constexpr int kWideThreads = 1024;
constexpr int kBlockMaxC = 32;     // columns a thread, block designs
constexpr int kWarpMaxN = 1024;
constexpr int kRowWarps = 4;  // warps (rows in flight) of a warp-design block
constexpr int kRowThreads = 32 * kRowWarps;

// Design codes, both directions, chosen by ops/layer_norm.py.
constexpr int kBlock = 0;  // a block a row, the row in registers, n <= 8192
constexpr int kWarp = 1;   // a warp a row, 16-byte vectors, n <= 1024
constexpr int kWide = 2;   // a block a row, the row read again, any n

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum a and b over the block of W warps; every thread gets both totals,
// added in warp order (the same order on every run).
template <int W>
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*red)[W]) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32;
  __syncthreads();  // every thread is done reading the previous sums
  if (threadIdx.x % 32 == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    a += red[0][i];
    b += red[1][i];
  }
}

// 16 bytes of T (VW elements) held as loaded.
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void zero() {
    v = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ float get(int e) const {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};
template <>
struct Raw<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { v = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ float get(int e) const {
    const uint32_t u = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
    return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
  }
};

// (a, b) rounded to bf16, a in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Store 16 bytes of values from f, rounded to T.
__device__ __forceinline__ void store_vec(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                 pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

// Both values summed over the warp by an xor butterfly (every lane ends
// with the same totals, added in the same order on every run).
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// A lane's share of one row: NV vectors of VW elements, vector v at
// columns (32 v + lane) * VW ...; vectors past n read as 0.
template <typename T, int VW, int NV>
__device__ __forceinline__ void load_vecs(Raw<T> (&out)[NV], const T* row,
                                          int n, int lane) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int col = (32 * v + lane) * VW;
    if (col < n) {
      out[v].load(row + col);
    } else {
      out[v].zero();
    }
  }
}

// One row of x and dy as a lane holds it (the backward's warp design).
template <typename T, int VW, int NV>
struct Row {
  Raw<T> x[NV], g[NV];
  __device__ __forceinline__ void load(const T* xr, const T* gr, int n,
                                       int lane) {
    load_vecs<T, VW, NV>(x, xr, n, lane);
    load_vecs<T, VW, NV>(g, gr, n, lane);
  }
};

// Every kernel takes its tensors untyped, so one pointer type holds each
// direction's instantiations.
typedef void (*FwdKernel)(const void*, const void*, const void*, void*,
                          long long, int, float);
typedef void (*BwdKernel)(const void*, const void*, const void*, void*,
                          float*, long long, int, long long, float);

// ---- forward -------------------------------------------------------------

// The warp design: see the header.  x, y: (rows, n) of T; w, b: (n,) of W,
// or both null.  n a whole number of 16-byte vectors (VW elements),
// 16-byte aligned x and y; NV * VW * 32 >= n.
template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kRowThreads)
ln_fwd_warp_kernel(const void* x_, const void* w_, const void* b_, void* y_,
                   long long rows, int n, float eps) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int kCols = 32 * NV * VW;  // columns an instantiation covers
  static_assert(kCols <= kWarpMaxN && kCols % kRowThreads == 0,
                "a row fits the shared w and b");
  const T* __restrict__ x = static_cast<const T*>(x_);
  const W* __restrict__ w = static_cast<const W*>(w_);
  const W* __restrict__ b = static_cast<const W*>(b_);
  T* __restrict__ y = static_cast<T*>(y_);
  __shared__ __align__(16) float wsm[kCols];
  __shared__ __align__(16) float bsm[kCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool affine = w != nullptr;
  const long long step = static_cast<long long>(gridDim.x) * kRowWarps;
  long long r = static_cast<long long>(blockIdx.x) * kRowWarps + warp;
  Raw<T> cur[NV], nxt[NV];
  if (r < rows) load_vecs<T, VW, NV>(cur, x + r * n, n, lane);
  // the affine parameters while the first rows load (0 past n)
  if (affine) {
#pragma unroll
    for (int k = 0; k < kCols / kRowThreads; ++k) {
      const int i = threadIdx.x + k * kRowThreads;
      wsm[i] = i < n ? load_f32(w + i) : 0.f;
      bsm[i] = i < n ? load_f32(b + i) : 0.f;
    }
  }
  __syncthreads();
  for (; r < rows; r += step) {
    // the next row's reads in flight while this one is reduced
    const long long rn = r + step;
    if (rn < rows) load_vecs<T, VW, NV>(nxt, x + rn * n, n, lane);
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float xv = cur[v].get(e);
        s += xv;
        ss += xv * xv;
      }
    }
    warp_sum2(s, ss);
    const float mean = s / static_cast<float>(n);
    const float var = ss / static_cast<float>(n) - mean * mean;
    const float rstd = rsqrtf(var + eps);
    T* const yr = y + r * n;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int col = (32 * v + lane) * VW;
      if (col < n) {
        float o[VW];
#pragma unroll
        for (int e = 0; e < VW; ++e) o[e] = (cur[v].get(e) - mean) * rstd;
        if (affine) {
#pragma unroll
          for (int q = 0; q < VW; q += 4) {
            const float4 wq = *reinterpret_cast<const float4*>(wsm + col + q);
            const float4 bq = *reinterpret_cast<const float4*>(bsm + col + q);
            o[q] = o[q] * wq.x + bq.x;
            o[q + 1] = o[q + 1] * wq.y + bq.y;
            o[q + 2] = o[q + 2] * wq.z + bq.z;
            o[q + 3] = o[q + 3] * wq.w + bq.w;
          }
        }
        store_vec(yr + col, o);
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) cur[v] = nxt[v];
  }
}

// The block design: a block a row (persistent, rows gridDim.x apart), C
// columns a thread held in registers, n <= 256 C.
template <typename T, typename W, int C>
__global__ void __launch_bounds__(kThreads)
ln_fwd_block_kernel(const void* x_, const void* w_, const void* b_,
                    void* y_, long long rows, int n, float eps) {
  const T* __restrict__ x = static_cast<const T*>(x_);
  const W* __restrict__ w = static_cast<const W*>(w_);
  const W* __restrict__ b = static_cast<const W*>(b_);
  T* __restrict__ y = static_cast<T*>(y_);
  __shared__ float red[2][kWarps];
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * n;
    float xv[C];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int col = threadIdx.x + j * kThreads;
      xv[j] = col < n ? load_f32(xr + col) : 0.f;
      s += xv[j];
      ss += xv[j] * xv[j];
    }
    block_sum2(s, ss, red);
    const float mean = s / static_cast<float>(n);
    const float var = ss / static_cast<float>(n) - mean * mean;
    const float rstd = rsqrtf(var + eps);
    T* yr = y + r * n;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int col = threadIdx.x + j * kThreads;
      if (col < n) {
        float v = (xv[j] - mean) * rstd;
        if (w != nullptr) v = v * load_f32(w + col) + load_f32(b + col);
        store_f32(yr + col, v);
      }
    }
  }
}

// The wide design: a block a row (persistent), the row strided and read
// twice; any n.
template <typename T, typename W>
__global__ void __launch_bounds__(kWideThreads)
ln_fwd_wide_kernel(const void* x_, const void* w_, const void* b_, void* y_,
                   long long rows, int n, float eps) {
  const T* __restrict__ x = static_cast<const T*>(x_);
  const W* __restrict__ w = static_cast<const W*>(w_);
  const W* __restrict__ b = static_cast<const W*>(b_);
  T* __restrict__ y = static_cast<T*>(y_);
  __shared__ float red[2][kWideThreads / 32];
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * n;
    T* yr = y + r * n;
    float s = 0.f, ss = 0.f;
    for (int i = threadIdx.x; i < n; i += kWideThreads) {
      const float v = load_f32(xr + i);
      s += v;
      ss += v * v;
    }
    block_sum2(s, ss, red);
    const float mean = s / static_cast<float>(n);
    const float var = ss / static_cast<float>(n) - mean * mean;
    const float rstd = rsqrtf(var + eps);
    for (int i = threadIdx.x; i < n; i += kWideThreads) {
      float v = (load_f32(xr + i) - mean) * rstd;
      if (w != nullptr) v = v * load_f32(w + i) + load_f32(b + i);
      store_f32(yr + i, v);
    }
  }
}

// ---- backward --------------------------------------------------------------

// The block design: rows [b R, b R + R) of block b, C columns a thread
// held in registers, n <= 256 C.
template <typename T, typename W, int C>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const void* x_, const void* w_, const void* dy_, void* dx_,
              float* __restrict__ part, long long rows, int n,
              long long rows_per_block, float eps) {
  const T* __restrict__ x = static_cast<const T*>(x_);
  const W* __restrict__ w = static_cast<const W*>(w_);
  const T* __restrict__ dy = static_cast<const T*>(dy_);
  T* __restrict__ dx = static_cast<T*>(dx_);
  __shared__ float red[2][kWarps];
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block
                                                  : rows;
  const bool affine = w != nullptr;
  const float inv_n = 1.f / static_cast<float>(n);
  float wv[C], pw[C], pb[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int col = threadIdx.x + j * kThreads;
    wv[j] = (affine && col < n) ? load_f32(w + col) : 1.f;
    pw[j] = 0.f;
    pb[j] = 0.f;
  }
  for (long long r = r0; r < r1; ++r) {
    const T* xr = x + r * n;
    const T* gr = dy + r * n;
    float xv[C], gv[C];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int col = threadIdx.x + j * kThreads;
      xv[j] = col < n ? load_f32(xr + col) : 0.f;
      gv[j] = col < n ? load_f32(gr + col) : 0.f;
      s += xv[j];
      ss += xv[j] * xv[j];
    }
    block_sum2(s, ss, red);
    const float mean = s / static_cast<float>(n);
    const float var = ss / static_cast<float>(n) - mean * mean;
    const float rstd = rsqrtf(var + eps);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int col = threadIdx.x + j * kThreads;
      xv[j] = (xv[j] - mean) * rstd;  // xhat from here on
      const float dxh = gv[j] * wv[j];
      if (col < n) {
        a += dxh;
        b += dxh * xv[j];
      }
    }
    block_sum2(a, b, red);
    const float m1 = a * inv_n;
    const float m2 = b * inv_n;
    T* dr = dx + r * n;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int col = threadIdx.x + j * kThreads;
      if (col < n) {
        const float dxh = gv[j] * wv[j];
        store_f32(dr + col, rstd * (dxh - m1 - xv[j] * m2));
        pw[j] += gv[j] * xv[j];
        pb[j] += gv[j];
      }
    }
  }
  if (affine) {
    float* pr = part + static_cast<long long>(blockIdx.x) * 2 * n;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int col = threadIdx.x + j * kThreads;
      if (col < n) {
        pr[col] = pw[j];
        pr[n + col] = pb[j];
      }
    }
  }
}

// The wide design: rows [b R, b R + R) of block b, each read three times
// (x; x and dy; x and dy); the block's partial kept in part[b] itself,
// column col updated only by thread col % 1024, row after row.  Any n.
template <typename T, typename W>
__global__ void __launch_bounds__(kWideThreads)
ln_bwd_wide_kernel(const void* x_, const void* w_, const void* dy_,
                   void* dx_, float* __restrict__ part, long long rows,
                   int n, long long rows_per_block, float eps) {
  const T* __restrict__ x = static_cast<const T*>(x_);
  const W* __restrict__ w = static_cast<const W*>(w_);
  const T* __restrict__ dy = static_cast<const T*>(dy_);
  T* __restrict__ dx = static_cast<T*>(dx_);
  __shared__ float red[2][kWideThreads / 32];
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block
                                                  : rows;
  const bool affine = w != nullptr;
  const float inv_n = 1.f / static_cast<float>(n);
  float* const pr =
      affine ? part + static_cast<long long>(blockIdx.x) * 2 * n : nullptr;
  for (long long r = r0; r < r1; ++r) {
    const T* xr = x + r * n;
    const T* gr = dy + r * n;
    float s = 0.f, ss = 0.f;
    for (int i = threadIdx.x; i < n; i += kWideThreads) {
      const float v = load_f32(xr + i);
      s += v;
      ss += v * v;
    }
    block_sum2(s, ss, red);
    const float mean = s / static_cast<float>(n);
    const float var = ss / static_cast<float>(n) - mean * mean;
    const float rstd = rsqrtf(var + eps);
    float a = 0.f, b = 0.f;
    for (int i = threadIdx.x; i < n; i += kWideThreads) {
      const float xh = (load_f32(xr + i) - mean) * rstd;
      const float dxh = load_f32(gr + i) * (affine ? load_f32(w + i) : 1.f);
      a += dxh;
      b += dxh * xh;
    }
    block_sum2(a, b, red);
    const float m1 = a * inv_n;
    const float m2 = b * inv_n;
    T* dr = dx + r * n;
    for (int i = threadIdx.x; i < n; i += kWideThreads) {
      const float xh = (load_f32(xr + i) - mean) * rstd;
      const float g = load_f32(gr + i);
      const float dxh = g * (affine ? load_f32(w + i) : 1.f);
      store_f32(dr + i, rstd * (dxh - m1 - xh * m2));
      if (affine) {
        // 0 + v is v: the same sums as the block design's
        pr[i] = (r == r0 ? 0.f : pr[i]) + g * xh;
        pr[n + i] = (r == r0 ? 0.f : pr[n + i]) + g;
      }
    }
  }
}

// The warp design of the backward: see the header.  x, dy, dx: (rows, n)
// of T; w: (n,) of W or null.  n a whole number of 16-byte vectors (VW
// elements), 16-byte aligned bases; NV * VW * 32 >= n.  bf16 rows of up
// to 768 (half the registers for x and dy) fit three blocks on an SM
// without spilling; the rest take what their registers allow (two at
// n = 768 fp32).
template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kRowThreads, sizeof(T) == 2 && NV <= 3 ? 3
                                                                        : 1)
ln_bwd_warp_kernel(const void* x_, const void* w_, const void* dy_,
                   void* dx_, float* __restrict__ part, long long rows,
                   int n, long long rows_per_block, float eps) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int E = NV * VW;  // elements of a row a lane holds
  static_assert(32 * E <= kWarpMaxN, "a row fits the shared w");
  const T* __restrict__ x = static_cast<const T*>(x_);
  const W* __restrict__ w = static_cast<const W*>(w_);
  const T* __restrict__ dy = static_cast<const T*>(dy_);
  T* __restrict__ dx = static_cast<T*>(dx_);
  __shared__ __align__(16) float wsm[kWarpMaxN];
  __shared__ float red[2][kWarpMaxN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool affine = w != nullptr;
  for (int i = threadIdx.x; i < kWarpMaxN; i += kRowThreads)
    wsm[i] = i < n ? (affine ? load_f32(w + i) : 1.f) : 0.f;
  __syncthreads();
  const float inv_n = 1.f / static_cast<float>(n);
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block
                                                  : rows;
  float pw[E], pb[E];
#pragma unroll
  for (int i = 0; i < E; ++i) pw[i] = pb[i] = 0.f;
  Row<T, VW, NV> cur, nxt;
  long long r = r0 + warp;
  if (r < r1) cur.load(x + r * n, dy + r * n, n, lane);
  for (; r < r1; r += kRowWarps) {
    // the next row's reads in flight while this one is reduced
    const long long rn = r + kRowWarps;
    if (rn < r1) nxt.load(x + rn * n, dy + rn * n, n, lane);
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float xv = cur.x[v].get(e);
        s += xv;
        ss += xv * xv;
      }
    }
    warp_sum2(s, ss);
    const float mean = s / static_cast<float>(n);
    const float var = ss / static_cast<float>(n) - mean * mean;
    const float rstd = rsqrtf(var + eps);
    // past n: dy and w are 0, so these add nothing.  dxhat = dy w is
    // formed again below rather than kept (registers)
    float xh[E];
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int col = (32 * v + lane) * VW;
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        xh[v * VW + e] = (cur.x[v].get(e) - mean) * rstd;
        const float dxh = cur.g[v].get(e) * wsm[col + e];
        a += dxh;
        b += dxh * xh[v * VW + e];
      }
    }
    warp_sum2(a, b);
    const float m1 = a * inv_n;
    const float m2 = b * inv_n;
    T* const dr = dx + r * n;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int col = (32 * v + lane) * VW;
      float o[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int i = v * VW + e;
        const float g = cur.g[v].get(e);
        o[e] = rstd * (g * wsm[col + e] - m1 - xh[i] * m2);
        pw[i] += g * xh[i];
        pb[i] += g;
      }
      if (col < n) store_vec(dr + col, o);
    }
    cur = nxt;
  }
  if (!affine) return;
  // the block's partial: the warps' partials added in warp order
  for (int ww = 0; ww < kRowWarps; ++ww) {
    if (warp == ww) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int col = (32 * v + lane) * VW;
        if (col < n) {
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            const int i = v * VW + e;
            red[0][col + e] = ww == 0 ? pw[i] : red[0][col + e] + pw[i];
            red[1][col + e] = ww == 0 ? pb[i] : red[1][col + e] + pb[i];
          }
        }
      }
    }
    __syncthreads();
  }
  float* const pr = part + static_cast<long long>(blockIdx.x) * 2 * n;
  for (int i = threadIdx.x; i < n; i += kRowThreads) {
    pr[i] = red[0][i];
    pr[n + i] = red[1][i];
  }
}

// dgamma/dbeta from the (blocks, 2, n) partials, read as (blocks, 2n):
// a block of 8 warps owns 32 of the 2n columns; warp w adds partial rows
// [w q, w q + q) (q = ceil(blocks / 8)) in order, then warp 0 adds the
// eight warp sums in warp order and casts once (column j < n is dgamma,
// n + j dbeta).
template <typename W>
__global__ void __launch_bounds__(kThreads)
ln_dwdb_kernel(const float* __restrict__ part, int blocks, int n,
               W* __restrict__ dw, W* __restrict__ db) {
  __shared__ float sa[kWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + lane;  // of 2n
  const int q = (blocks + kWarps - 1) / kWarps;
  const int i0 = warp * q;
  const int i1 = i0 + q < blocks ? i0 + q : blocks;
  float a = 0.f;
  if (col < 2 * n) {
    const float* p = part + col;
    int i = i0;
    // eight loads in flight, added in row order
    for (; i + 8 <= i1; i += 8) {
      float t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        t[u] = p[static_cast<long long>(i + u) * 2 * n];
#pragma unroll
      for (int u = 0; u < 8; ++u) a += t[u];
    }
    for (; i < i1; ++i) a += p[static_cast<long long>(i) * 2 * n];
  }
  sa[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && col < 2 * n) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) t += sa[i][lane];
    if (col < n) {
      store_f32(dw + col, t);
    } else {
      store_f32(db + col - n, t);
    }
  }
}

// ---- host side -------------------------------------------------------------

int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return v;
}

// Blocks of a kernel resident on one SM at `threads` a block, as the
// occupancy query says (asked once per kernel; host threads may call at
// once).
int blocks_per_sm(const void* k, int threads) {
  constexpr int kSlots = 64;  // more than the kernels asked about (48)
  static std::mutex mu;
  static const void* keys[kSlots];
  static int vals[kSlots];
  static int used = 0;
  std::lock_guard<std::mutex> hold(mu);
  for (int i = 0; i < used; ++i) {
    if (keys[i] == k) return vals[i];
  }
  int nb = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, k, threads, 0) !=
          cudaSuccess ||
      nb < 1)
    nb = 1;
  if (used < kSlots) {
    keys[used] = k;
    vals[used++] = nb;
  }
  return nb;
}

// The block designs' instantiation for rows of n: C = ceil(n / 256)
// rounded up to a power of two, or null past kBlockMaxC.
template <typename K, K (*Pick)(int)>
K by_columns(int n) {
  const int c = (n + kThreads - 1) / kThreads;
  int p = 1;
  while (p < c) p *= 2;
  return p <= kBlockMaxC ? Pick(p) : nullptr;
}

template <typename T, typename W>
FwdKernel fwd_block_c(int c) {
  switch (c) {
    case 1: return ln_fwd_block_kernel<T, W, 1>;
    case 2: return ln_fwd_block_kernel<T, W, 2>;
    case 4: return ln_fwd_block_kernel<T, W, 4>;
    case 8: return ln_fwd_block_kernel<T, W, 8>;
    case 16: return ln_fwd_block_kernel<T, W, 16>;
    default: return ln_fwd_block_kernel<T, W, 32>;
  }
}

template <typename T, typename W>
BwdKernel bwd_block_c(int c) {
  switch (c) {
    case 1: return ln_bwd_kernel<T, W, 1>;
    case 2: return ln_bwd_kernel<T, W, 2>;
    case 4: return ln_bwd_kernel<T, W, 4>;
    case 8: return ln_bwd_kernel<T, W, 8>;
    case 16: return ln_bwd_kernel<T, W, 16>;
    default: return ln_bwd_kernel<T, W, 32>;
  }
}

// The kernel of (T, W) that `design` runs for rows of n, or null where it
// cannot take them.  The warp designs: the vector count of n = 768 up to
// 768, that of n = 1024 above (ops/layer_norm.py::ln_fwd_kernel and
// ln_bwd_kernel name the same).
template <typename T, typename W>
FwdKernel fwd_kernel(int n, int design) {
  constexpr int VW = 16 / sizeof(T);
  if (design == kWarp) {
    if (n > kWarpMaxN || n % VW != 0) return nullptr;
    return n <= 768 ? ln_fwd_warp_kernel<T, W, 768 / (32 * VW)>
                    : ln_fwd_warp_kernel<T, W, kWarpMaxN / (32 * VW)>;
  }
  if (design == kBlock) return by_columns<FwdKernel, fwd_block_c<T, W>>(n);
  if (design == kWide) return ln_fwd_wide_kernel<T, W>;
  return nullptr;
}

template <typename T, typename W>
BwdKernel bwd_kernel(int n, int design) {
  constexpr int VW = 16 / sizeof(T);
  if (design == kWarp) {
    if (n > kWarpMaxN || n % VW != 0) return nullptr;
    return n <= 768 ? ln_bwd_warp_kernel<T, W, 768 / (32 * VW)>
                    : ln_bwd_warp_kernel<T, W, kWarpMaxN / (32 * VW)>;
  }
  if (design == kBlock) return by_columns<BwdKernel, bwd_block_c<T, W>>(n);
  if (design == kWide) return ln_bwd_wide_kernel<T, W>;
  return nullptr;
}

// The kernel of a call (dtype codes as the entry points'; w_dtype -1, no
// weight, runs the fp32-weight instantiation, which then reads none), or
// null where none is built.
template <typename K, K (*F32F32)(int, int), K (*F32Bf)(int, int),
          K (*BfF32)(int, int), K (*BfBf)(int, int)>
K pick(int dtype, int w_dtype, int n, int design) {
  if (n < 1 || w_dtype < -1 || w_dtype > 1) return nullptr;
  if (dtype == 0) return w_dtype == 1 ? F32Bf(n, design) : F32F32(n, design);
  if (dtype == 1) return w_dtype == 1 ? BfBf(n, design) : BfF32(n, design);
  return nullptr;
}

typedef __nv_bfloat16 bf16;

FwdKernel pick_fwd(int dtype, int w_dtype, int n, int design) {
  return pick<FwdKernel, fwd_kernel<float, float>, fwd_kernel<float, bf16>,
              fwd_kernel<bf16, float>, fwd_kernel<bf16, bf16>>(
      dtype, w_dtype, n, design);
}

BwdKernel pick_bwd(int dtype, int w_dtype, int n, int design) {
  return pick<BwdKernel, bwd_kernel<float, float>, bwd_kernel<float, bf16>,
              bwd_kernel<bf16, float>, bwd_kernel<bf16, bf16>>(
      dtype, w_dtype, n, design);
}

int threads_of(int design) {
  return design == kWarp ? kRowThreads : design == kWide ? kWideThreads
                                                         : kThreads;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

// The backward's blocks (its partials) and the rows each owns (the last
// block the rest): the block design 16 rows a block; the warp and wide
// designs one persistent block for each slot the SMs hold, at most one a
// row (a kRowWarps rows for the warp design), the rows cut evenly.
// w_dtype -1: no weight.  False for a design that cannot run.
bool bwd_geometry(long long rows, int n, int dtype, int w_dtype, int design,
                  long long* parts, long long* rows_per_block) {
  if (rows <= 0 || n < 1) {
    *parts = 0;
    *rows_per_block = 1;
    return rows == 0;
  }
  const BwdKernel k = pick_bwd(dtype, w_dtype, n, design);
  if (k == nullptr) return false;
  long long r = kRowsPerBlock;
  if (design != kBlock) {
    const int threads = threads_of(design);
    long long p = static_cast<long long>(sm_count()) *
                  blocks_per_sm(reinterpret_cast<const void*>(k), threads);
    const long long most =
        design == kWarp ? (rows + kRowWarps - 1) / kRowWarps : rows;
    if (p > most) p = most;
    r = (rows + p - 1) / p;
  }
  *rows_per_block = r;
  *parts = (rows + r - 1) / r;
  return true;
}

}  // namespace

// The backward's geometry under `design` (0 the block design, 1 the warp
// design, 2 the wide design), for (rows, n) of dtype with weights of
// w_dtype (-1: none): out[0] its blocks (apex_ln_bwd's part buffer holds
// out[0] x 2 x n floats), out[1] the rows each owns (block b: rows
// [b R, b R + R), the last one the rest).  -1 for a design the call
// cannot run, else 0.
extern "C" int apex_ln_bwd_geometry(long long rows, int n, int dtype,
                                    int w_dtype, int design, long long* out) {
  return bwd_geometry(rows, n, dtype, w_dtype, design, &out[0], &out[1])
             ? 0
             : -1;
}

// Forward.  x, y: (rows, n) of dtype; w, b: (n,) of w_dtype, or both null
// for the non-affine variant.  dtype codes: 0 = float32, 1 = bfloat16.
// design: 0 the block design (n <= 8192), 1 the warp design (n <= 1024 a
// whole number of 16 bytes of dtype; x and y 16-byte aligned), 2 the wide
// design (any n).  Returns a CUDA error code.
extern "C" int apex_ln_fwd(const void* x, const void* w, const void* b,
                           void* y, long long rows, int n, float eps,
                           int dtype, int w_dtype, int design,
                           void* stream) {
  if (rows <= 0) return 0;
  if (w == nullptr) w_dtype = -1;
  const FwdKernel k = pick_fwd(dtype, w_dtype, n, design);
  if (k == nullptr || (design == kWarp && !aligned16({x, y})))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = threads_of(design);
  // persistent blocks: what the SMs hold at once, at most one a row
  // (a kRowWarps rows for the warp design)
  const long long most =
      design == kWarp ? (rows + kRowWarps - 1) / kRowWarps : rows;
  long long grid = static_cast<long long>(sm_count()) *
                   blocks_per_sm(reinterpret_cast<const void*>(k), threads);
  if (grid > most) grid = most;
  k<<<dim3(static_cast<unsigned>(grid)), threads, 0,
      static_cast<cudaStream_t>(stream)>>>(x, w, b, y, rows, n, eps);
  return static_cast<int>(cudaGetLastError());
}

// Backward.  x, dy, dx: (rows, n) of dtype; w: (n,) of w_dtype, or null
// for the non-affine variant (then w_dtype, part, dw and db are unused
// and part, dw and db may be null).  part: fp32 scratch of
// apex_ln_bwd_geometry's out[0] * 2 * n; dw, db: (n,) of w_dtype.
// design: 0 the block design (n <= 8192), 1 the warp design (n <= 1024 a
// whole number of 16 bytes of dtype; x, dy, dx 16-byte aligned), 2 the
// wide design (any n).  Returns a CUDA error code.
extern "C" int apex_ln_bwd(const void* x, const void* w, const void* dy,
                           void* dx, float* part, void* dw, void* db,
                           long long rows, int n, float eps, int dtype,
                           int w_dtype, int design, void* stream) {
  if (rows <= 0) return 0;
  long long parts, rpb;
  if (w == nullptr) w_dtype = -1;
  if (!bwd_geometry(rows, n, dtype, w_dtype, design, &parts, &rpb) ||
      (design == kWarp && !aligned16({x, dy, dx})))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdKernel k = pick_bwd(dtype, w_dtype, n, design);
  k<<<dim3(static_cast<unsigned>(parts)), threads_of(design), 0, s>>>(
      x, w, dy, dx, part, rows, n, rpb, eps);
  if (w != nullptr) {
    const unsigned grid = static_cast<unsigned>((2 * n + 31) / 32);
    if (w_dtype == 0) {
      ln_dwdb_kernel<float><<<grid, kThreads, 0, s>>>(
          part, static_cast<int>(parts), n, static_cast<float*>(dw),
          static_cast<float*>(db));
    } else {
      ln_dwdb_kernel<bf16><<<grid, kThreads, 0, s>>>(
          part, static_cast<int>(parts), n, static_cast<bf16*>(dw),
          static_cast<bf16*>(db));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
