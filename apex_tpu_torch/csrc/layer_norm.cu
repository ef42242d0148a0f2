// LayerNorm forward over the last axis, one thread block per row.
//
// Replaces: apex_tpu/ops/layer_norm.py::_ln_fwd_kernel (launched by
// _ln_fwd_pallas).  Same arithmetic: fp32 sums of x and x*x, variance as
// E[x^2] - mean^2 (not Welford), rsqrt(var + eps), affine in fp32, output
// rounded to the input dtype (fp32 or bf16, round to nearest even).
//
// Bound on the H100: bytes.  Each row is read once for the sums and once
// more for the normalisation (the second read hits L1/L2), and written
// once; a few flops per byte.  At serving shapes (rows = slots x tokens,
// n = 768) a call moves tens to hundreds of KB, so it is launch-bound.
//
// Design: a block of 256 threads owns a row.  Threads stride the row so
// neighbouring threads read neighbouring elements; the two sums reduce by
// warp shuffles and one shared-memory step.  No shared-memory copy of the
// row and no register cache, so any n up to the wrapper's limit runs with
// the same kernel.  Making it faster (vector loads, several rows per
// block at small n) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, T* __restrict__ y, int n,
              float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * n;
  T* yr = y + row * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = load_f32(xr + i);
    s += v;
    ss += v * v;
  }
  __shared__ float red[2][kWarps];
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? red[0][lane] : 0.f;
    ss = lane < kWarps ? red[1][lane] : 0.f;
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      red[0][0] = s;
      red[1][0] = ss;
    }
  }
  __syncthreads();
  const float mean = red[0][0] / static_cast<float>(n);
  const float var = red[1][0] / static_cast<float>(n) - mean * mean;
  const float rstd = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float v = (load_f32(xr + i) - mean) * rstd;
    if (w != nullptr) v = v * w[i] + b[i];
    store_f32(yr + i, v);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y).  w and b are float32, or
// both null for the non-affine variant.  Returns cudaGetLastError().
extern "C" int apex_ln_fwd(const void* x, const void* w, const void* b,
                           void* y, long long rows, int n, float eps,
                           int dtype, void* stream) {
  if (rows <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0) {
    ln_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), wf, bf, static_cast<float*>(y), n,
        eps);
  } else if (dtype == 1) {
    ln_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wf, bf,
        static_cast<__nv_bfloat16*>(y), n, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
