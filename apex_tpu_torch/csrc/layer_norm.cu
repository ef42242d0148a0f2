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
// Backward: a block of 256 threads owns kRowsPerBlock consecutive rows and
// keeps its C = ceil(n / 256) columns per thread of x and dy in registers
// while it works on a row, so x and dy are read from device memory once.
// The two pairs of row sums reduce by warp shuffles and a fixed-order
// shared-memory step.  The dgamma/dbeta sums must not depend on timing,
// because the reference gives the same bits on every run: each block keeps
// its own column partials in registers and writes them to a
// (blocks, 2, n) fp32 buffer, and a second small kernel adds the partials
// of each column in block order (warp w takes blocks w, w+8, ..., then the
// eight warp sums are added in warp order).  No float atomics anywhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// dgamma/dbeta from the (blocks, 2, n) partials: a block of 8 warps owns
// 32 columns; warp w adds blocks w, w + 8, ... in order, then warp 0 adds
// the eight warp sums in warp order and casts once.
template <typename W>
__global__ void __launch_bounds__(kThreads)
ln_dwdb_kernel(const float* __restrict__ part, int blocks, int n,
               W* __restrict__ dw, W* __restrict__ db) {
  __shared__ float sa[kWarps][32], sb[kWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + lane;
  float a = 0.f, b = 0.f;
  if (col < n) {
    for (int i = warp; i < blocks; i += kWarps) {
      const float* pr = part + static_cast<long long>(i) * 2 * n;
      a += pr[col];
      b += pr[n + col];
    }
  }
  sa[warp][lane] = a;
  sb[warp][lane] = b;
  __syncthreads();
  if (warp == 0 && col < n) {
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      ta += sa[i][lane];
      tb += sb[i][lane];
    }
    store_f32(dw + col, ta);
    store_f32(db + col, tb);
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
  ln_dwdb_kernel<W><<<dim3(static_cast<unsigned>((n + 31) / 32)), kThreads,
                      0, s>>>(part, static_cast<int>(blocks), n,
                              static_cast<W*>(dw), static_cast<W*>(db));
}

}  // namespace

// Rows each backward block owns: the partials buffer of apex_ln_bwd holds
// ceil(rows / apex_ln_bwd_rows_per_block()) x 2 x n floats.
extern "C" int apex_ln_bwd_rows_per_block() { return kRowsPerBlock; }

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
// for the non-affine variant (then part, dw and db are unused and may be
// null).  part: fp32 scratch of ceil(rows / rows_per_block) * 2 * n;
// dw, db: (n,) of w_dtype.  n <= 8192.  Returns cudaGetLastError().
extern "C" int apex_ln_bwd(const void* x, const void* w, const void* dy,
                           void* dx, float* part, void* dw, void* db,
                           long long rows, int n, float eps, int dtype,
                           int w_dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0 && w_dtype == 0) {
    err = launch_bwd<float, float>(x, w, dy, dx, part, rows, n, eps, s);
  } else if (dtype == 0 && w_dtype == 1) {
    err = launch_bwd<float, __nv_bfloat16>(x, w, dy, dx, part, rows, n, eps,
                                           s);
  } else if (dtype == 1 && w_dtype == 0) {
    err = launch_bwd<__nv_bfloat16, float>(x, w, dy, dx, part, rows, n, eps,
                                           s);
  } else if (dtype == 1 && w_dtype == 1) {
    err = launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, w, dy, dx, part, rows,
                                                   n, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  if (w != nullptr) {
    const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (w_dtype == 0) {
      launch_dwdb<float>(part, blocks, n, dw, db, s);
    } else {
      launch_dwdb<__nv_bfloat16>(part, blocks, n, dw, db, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
