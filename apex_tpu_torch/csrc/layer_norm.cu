// LayerNorm over the last axis: forward, and the backward with the
// dgamma/dbeta column sums.
//
// Replaces:
// - apex_tpu/ops/layer_norm.py::_ln_fwd_kernel (launched by _ln_fwd_pallas)
//   with apex_ln_fwd.  Same arithmetic: fp32 sums of x and x*x, variance
//   as E[x^2] - mean^2 (not Welford), rsqrt(var + eps), affine in fp32
//   (weight and bias fp32 or bf16, upcast), output rounded to the input
//   dtype (fp32 or bf16, round to nearest even).
// - apex_tpu/ops/layer_norm.py::_ln_bwd_dx_dwdb_kernel (launched by
//   _ln_bwd_dx_dwdb_pallas) with apex_ln_bwd, and its non-affine twin
//   _ln_bwd_dx_kernel (_ln_bwd_dx_pallas) with the same entry point and a
//   null weight.  Same arithmetic as _ln_dx_math: mean and rstd recomputed
//   from x, dxhat = dy * w, m1 = mean(dxhat), m2 = mean(dxhat * xhat),
//   dx = rstd * (dxhat - m1 - xhat * m2); dgamma = sum_rows dy * xhat and
//   dbeta = sum_rows dy, in fp32, cast once to the weight's dtype.
//
// Bound on the H100: bytes.  The forward reads x once (plus a second read
// that hits L1/L2) and writes y; the backward reads x and dy and writes
// dx, a few flops per byte.  At the training shape (16384, 768) fp32 the
// backward moves 151 MB: 45 us at 3.35 TB/s.
//
// Design.  Forward: a block of 256 threads owns a row; threads stride the
// row so neighbouring threads read neighbouring elements; the two sums
// reduce by warp shuffles and one shared-memory step.
//
// Backward, the warp design (ln_bwd_warp_kernel), for rows of n <= 1024
// that are a whole number of 16-byte vectors, with 16-byte aligned x, dy
// and dx (every ported model: 768 and 1024): one warp owns a row, each
// lane holding its share of x and dy in registers as 16-byte vectors (6
// float4 a lane at n = 768 fp32, 3 uint4 for bf16; lane l's vector v
// covers columns (32 v + l) * VW ..., so a warp's load is 512 contiguous
// bytes).  Instantiated for the vector counts of n = 768 and n = 1024
// alone (narrower rows take the 768 one, their vectors past n masked).
// Both pairs of row sums reduce by xor shuffles alone: no block barrier
// per row.  A warp issues its next row's loads before it reduces the
// current one, so each warp keeps two rows of reads in flight.  Blocks
// of four warps are persistent, as many as fit on the SMs at once; block
// b owns rows [b R, b R + R) (R from apex_ln_bwd_geometry), warp w of it
// the rows w, w + 4, ... of those.  Each lane carries the dgamma/dbeta
// partials of its columns in registers across its rows; at the end the
// block adds its warps' partials in warp order in shared memory and
// writes one (2, n) partial.  w (or ones, without affine) is read from
// shared memory each row rather than held in registers.
// Backward, every other row up to n = 8192, the block design
// (ln_bwd_kernel): a block of 256 threads owns kRowsPerBlock consecutive
// rows and keeps its C = ceil(n / 256) columns per thread of x and dy in
// registers while it works on a row; the row sums reduce by warp
// shuffles and a fixed-order shared-memory step (two block barriers
// each).  The wrapper (ops/layer_norm.py::_ln_bwd_design) picks the
// design and passes its code; this file runs what a code names and
// refuses a call that the code's kernel cannot take.
// dgamma/dbeta, both designs: the sums must not depend on timing,
// because the reference gives the same bits on every run.  A second
// kernel (ln_dwdb_kernel) adds the (blocks, 2, n) partials: a block of 8
// warps owns 32 of the 2n partial columns, warp w adds its contiguous
// eighth of the partial rows in order, then the eight warp sums are added
// in warp order and cast once; ceil(2n / 32) blocks (48 at n = 768).  No
// float atomics anywhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 16;

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

// Sum a and b over the block; every thread gets both totals, added in
// warp order (the same order on every run).
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*red)[kWarps]) {
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
  for (int i = 0; i < kWarps; ++i) {
    a += red[0][i];
    b += red[1][i];
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
              const W* __restrict__ b, T* __restrict__ y, int n,
              float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * n;
  T* yr = y + row * n;
  __shared__ float red[2][kWarps];
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = load_f32(xr + i);
    s += v;
    ss += v * v;
  }
  block_sum2(s, ss, red);
  const float mean = s / static_cast<float>(n);
  const float var = ss / static_cast<float>(n) - mean * mean;
  const float rstd = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float v = (load_f32(xr + i) - mean) * rstd;
    if (w != nullptr) v = v * load_f32(w + i) + load_f32(b + i);
    store_f32(yr + i, v);
  }
}

// C columns per thread: column j of a thread is threadIdx.x + j * 256.
template <typename T, typename W, int C>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
              const T* __restrict__ dy, T* __restrict__ dx,
              float* __restrict__ part, long long rows, int n, float eps) {
  __shared__ float red[2][kWarps];
  const long long r0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const long long r1 = r0 + kRowsPerBlock < rows ? r0 + kRowsPerBlock : rows;
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

// ---- the warp design of the backward (n <= kWarpMaxN) -----------------

constexpr int kWarpMaxN = 1024;
constexpr int kRowWarps = 4;  // warps (rows in flight) of a block
constexpr int kRowThreads = 32 * kRowWarps;

// Design codes of the backward, chosen by ops/layer_norm.py::_ln_bwd_design.
constexpr int kBwdBlock = 0;  // ln_bwd_kernel, n <= 8192
constexpr int kBwdWarp = 1;   // ln_bwd_warp_kernel, 16-byte vectors

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

// One row of x and dy as a lane holds it: NV vectors of VW elements,
// vector v at columns (32 v + lane) * VW ...; vectors past n read as 0.
template <typename T, int VW, int NV>
struct Row {
  Raw<T> x[NV], g[NV];
  __device__ __forceinline__ void load(const T* xr, const T* gr, int n,
                                       int lane) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int col = (32 * v + lane) * VW;
      if (col < n) {
        x[v].load(xr + col);
        g[v].load(gr + col);
      } else {
        x[v].zero();
        g[v].zero();
      }
    }
  }
};

// dx of the rows of block b (rows [b R, b R + R), warp w taking rows w,
// w + kRowWarps, ...), with the block's dgamma/dbeta partial written to
// part[b] (affine only).  x, dy, dx: (rows, n) of T; w: (n,) of W or
// null.  n a whole number of 16-byte vectors (VW elements), 16-byte
// aligned bases; NV * VW * 32 >= n.  bf16 rows of up to 768 (half the
// registers for x and dy) fit three blocks on an SM without spilling;
// the rest take what their registers allow (two at n = 768 fp32).
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

int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return v;
}

typedef void (*WarpKernel)(const void*, const void*, const void*, void*,
                           float*, long long, int, long long, float);

// The warp kernel of (T, W) for rows of n: the vector count of n = 768
// up to 768, that of n = 1024 above (ops/layer_norm.py::ln_bwd_kernel
// names the same).
template <typename T, typename W>
WarpKernel warp_kernel(int n) {
  if constexpr (sizeof(T) == 4) {  // fp32: 128 columns a vector step
    return n <= 768 ? ln_bwd_warp_kernel<T, W, 6>
                    : ln_bwd_warp_kernel<T, W, 8>;
  } else {  // bf16: 256
    return n <= 768 ? ln_bwd_warp_kernel<T, W, 3>
                    : ln_bwd_warp_kernel<T, W, 4>;
  }
}

template <typename T, typename W>
void launch_fwd(const void* x, const void* w, const void* b, void* y,
                long long rows, int n, float eps, cudaStream_t s) {
  ln_fwd_kernel<T, W><<<dim3(static_cast<unsigned>(rows)), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const W*>(b), static_cast<T*>(y), n, eps);
}

template <typename T, typename W, int C>
void launch_bwd_c(const void* x, const void* w, const void* dy, void* dx,
                  float* part, long long rows, int n, float eps,
                  cudaStream_t s) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_bwd_kernel<T, W, C><<<dim3(static_cast<unsigned>(blocks)), kThreads, 0,
                           s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, n, eps);
}

template <typename T, typename W>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx,
               float* part, long long rows, int n, float eps,
               cudaStream_t s) {
  const int c = (n + kThreads - 1) / kThreads;
  if (c <= 1) {
    launch_bwd_c<T, W, 1>(x, w, dy, dx, part, rows, n, eps, s);
  } else if (c <= 2) {
    launch_bwd_c<T, W, 2>(x, w, dy, dx, part, rows, n, eps, s);
  } else if (c <= 4) {
    launch_bwd_c<T, W, 4>(x, w, dy, dx, part, rows, n, eps, s);
  } else if (c <= 8) {
    launch_bwd_c<T, W, 8>(x, w, dy, dx, part, rows, n, eps, s);
  } else if (c <= 16) {
    launch_bwd_c<T, W, 16>(x, w, dy, dx, part, rows, n, eps, s);
  } else if (c <= 32) {
    launch_bwd_c<T, W, 32>(x, w, dy, dx, part, rows, n, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename W>
void launch_dwdb(const float* part, long long blocks, int n, void* dw,
                 void* db, cudaStream_t s) {
  ln_dwdb_kernel<W><<<dim3(static_cast<unsigned>((2 * n + 31) / 32)),
                      kThreads, 0, s>>>(part, static_cast<int>(blocks), n,
                                        static_cast<W*>(dw),
                                        static_cast<W*>(db));
}

// The warp kernel of a call (dtype codes as apex_ln_bwd's; w_dtype -1,
// no weight, runs the fp32-weight instantiation, which then reads none),
// or null where none is built: n past kWarpMaxN or not a whole number of
// 16-byte vectors.
WarpKernel pick_warp(int dtype, int w_dtype, int n) {
  if (n < 1 || n > kWarpMaxN || n % (dtype == 0 ? 4 : 8) != 0)
    return nullptr;
  typedef __nv_bfloat16 bf16;
  if (dtype == 0)
    return w_dtype == 1 ? warp_kernel<float, bf16>(n)
                        : warp_kernel<float, float>(n);
  if (dtype == 1)
    return w_dtype == 1 ? warp_kernel<bf16, bf16>(n)
                        : warp_kernel<bf16, float>(n);
  return nullptr;
}

// Blocks of a warp kernel resident on one SM, as the occupancy query
// says (asked once per kernel; host threads may call at once).
int warp_blocks_per_sm(WarpKernel k) {
  constexpr int kSlots = 8;  // the warp kernels built
  static std::mutex mu;
  static WarpKernel keys[kSlots];
  static int vals[kSlots];
  static int used = 0;
  std::lock_guard<std::mutex> hold(mu);
  for (int i = 0; i < used; ++i) {
    if (keys[i] == k) return vals[i];
  }
  int nb = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, k, kRowThreads,
                                                    0) != cudaSuccess ||
      nb < 1)
    nb = 1;
  if (used < kSlots) {
    keys[used] = k;
    vals[used++] = nb;
  }
  return nb;
}

// The backward's blocks (its partials) and the rows each owns (the last
// block the rest): the block design 16 rows a block; the warp design one
// persistent block for each slot the SMs hold, at most one a kRowWarps
// rows, the rows cut evenly.  w_dtype -1: no weight.  False for a design
// that cannot run.
bool bwd_geometry(long long rows, int n, int dtype, int w_dtype, int design,
                  long long* parts, long long* rows_per_block) {
  if (rows <= 0 || n < 1) {
    *parts = 0;
    *rows_per_block = 1;
    return rows == 0;
  }
  long long r;
  if (design == kBwdBlock) {
    if (n > 32 * kThreads) return false;
    r = kRowsPerBlock;
  } else if (design == kBwdWarp) {
    const WarpKernel k = pick_warp(dtype, w_dtype, n);
    if (k == nullptr) return false;
    long long p = static_cast<long long>(sm_count()) * warp_blocks_per_sm(k);
    const long long most = (rows + kRowWarps - 1) / kRowWarps;
    if (p > most) p = most;
    r = (rows + p - 1) / p;
  } else {
    return false;
  }
  *rows_per_block = r;
  *parts = (rows + r - 1) / r;
  return true;
}

}  // namespace

// The backward's geometry under `design` (0 the block design, 1 the warp
// design), for (rows, n) of dtype with weights of w_dtype (-1: none):
// out[0] its blocks (apex_ln_bwd's part buffer holds out[0] x 2 x n
// floats), out[1] the rows each owns (block b: rows [b R, b R + R), the
// last one the rest).  -1 for a design the call cannot run, else 0.
extern "C" int apex_ln_bwd_geometry(long long rows, int n, int dtype,
                                    int w_dtype, int design, long long* out) {
  return bwd_geometry(rows, n, dtype, w_dtype, design, &out[0], &out[1])
             ? 0
             : -1;
}

// dtype: 0 = float32, 1 = bfloat16, for x and y (dtype) and for w and b
// (w_dtype).  w and b both null is the non-affine variant.  Returns
// cudaGetLastError().
extern "C" int apex_ln_fwd(const void* x, const void* w, const void* b,
                           void* y, long long rows, int n, float eps,
                           int dtype, int w_dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && w_dtype == 0) {
    launch_fwd<float, float>(x, w, b, y, rows, n, eps, s);
  } else if (dtype == 0 && w_dtype == 1) {
    launch_fwd<float, __nv_bfloat16>(x, w, b, y, rows, n, eps, s);
  } else if (dtype == 1 && w_dtype == 0) {
    launch_fwd<__nv_bfloat16, float>(x, w, b, y, rows, n, eps, s);
  } else if (dtype == 1 && w_dtype == 1) {
    launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, rows, n, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward.  x, dy, dx: (rows, n) of dtype; w: (n,) of w_dtype, or null
// for the non-affine variant (then w_dtype, part, dw and db are unused
// and part, dw and db may be null).  part: fp32 scratch of
// apex_ln_bwd_geometry's out[0] * 2 * n; dw, db: (n,) of w_dtype.
// design: 0 the block design (n <= 8192), 1 the warp design (n <= 1024
// a whole number of 16 bytes of dtype; x, dy, dx 16-byte aligned).
// Returns a CUDA error code.
extern "C" int apex_ln_bwd(const void* x, const void* w, const void* dy,
                           void* dx, float* part, void* dw, void* db,
                           long long rows, int n, float eps, int dtype,
                           int w_dtype, int design, void* stream) {
  if (rows <= 0) return 0;
  long long parts, rpb;
  if (w == nullptr) w_dtype = -1;
  if ((dtype != 0 && dtype != 1) || w_dtype < -1 || w_dtype > 1 ||
      !bwd_geometry(rows, n, dtype, w_dtype, design, &parts, &rpb))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design != kBwdBlock) {
    for (const void* p : {x, dy, static_cast<const void*>(dx)}) {
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const WarpKernel k = pick_warp(dtype, w_dtype, n);
    k<<<dim3(static_cast<unsigned>(parts)), kRowThreads, 0, s>>>(
        x, w, dy, dx, part, rows, n, rpb, eps);
  } else {
    // (without a weight W is not read: the fp32 instantiation runs)
    typedef __nv_bfloat16 bf16;
    const bool wb = w_dtype == 1;
    const int err =
        dtype == 0
            ? (wb ? launch_bwd<float, bf16>(x, w, dy, dx, part, rows, n, eps,
                                            s)
                  : launch_bwd<float, float>(x, w, dy, dx, part, rows, n,
                                             eps, s))
            : (wb ? launch_bwd<bf16, bf16>(x, w, dy, dx, part, rows, n, eps,
                                           s)
                  : launch_bwd<bf16, float>(x, w, dy, dx, part, rows, n, eps,
                                            s));
    if (err != 0) return err;
  }
  if (w != nullptr) {
    if (w_dtype == 0) {
      launch_dwdb<float>(part, parts, n, dw, db, s);
    } else {
      launch_dwdb<__nv_bfloat16>(part, parts, n, dw, db, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
