// LAMB stage 1 for one leaf: the moment update and the per-tensor sums
// sum(p^2) and sum(u^2) in one pass over (g, p, m, v).
//
// Replaces apex_tpu/ops/fused_optim.py::_lamb_stage1_kernel (launched by
// lamb_stage1) with apex_lamb_stage1.
//
// Semantics, as the reference's, in fp32 whatever g's dtype:
//   g' = g * g_scale  (+ wd * p in L2 mode, adam_w == 0)
//   m' = b1 * m + (1 - b1) * g'        v' = b2 * v + (1 - b2) * g' * g'
//   (skip > 0, an AMP overflow step: m' = m, v' = v)
//   u  = (m' / bc1) / (sqrt(v' / bc2) + eps)  (+ wd * p in AdamW mode)
// with the scalars [g_scale, bc1, bc2, skip] read from a device float[4],
// so a step reads nothing on the host.  m' and v' are written over m and
// v (in place).  Each operation rounds once, as the plain PyTorch
// version's separate operations do (the _rn intrinsics keep nvcc from
// contracting them into FMAs), so m' and v' match it bit for bit.  Any
// size: the ragged tail is masked by the loop bounds and so left out of
// the sums; the TPU kernel's size % 1024 and >= 65536 gates were sublane
// and launch-cost rules, not semantics.
//
// Bound on the H100: bytes.  Per element g is read (2 bytes for bf16), p,
// m and v are read and m and v written (20 bytes): 22 bytes, so a
// BERT-large step's 335.2 M elements need 2.20 ms at 3.35 TB/s; the
// arithmetic (one division chain and a square root per element) is far
// below the fp32 rate.
//
// Design.  One block of 256 threads per 8192-element chunk; where every
// pointer is 16-byte aligned and the size a multiple of 4, each thread
// moves four elements per access (float4, and 8 bytes of bf16 g).  The
// sums are deterministic: each block reduces its threads' partial sums in
// a fixed order (warp shuffles, then the warps in index order) and writes
// one (p^2, u^2) pair; a second one-block kernel adds the pairs in a fixed
// order.  No float atomics, so a rerun gives the same bits.  One launch
// pair per leaf; a multi-tensor launch over all leaves is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = kThreads * 4 * 8;  // elements per block

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
  int adam_w;
};

__device__ __forceinline__ void lamb_elem(float g, float p, float& m,
                                          float& v, float gs, float bc1,
                                          float bc2, bool skip,
                                          const Hyper& h, float& psum,
                                          float& usum) {
  g = __fmul_rn(g, gs);
  if (!h.adam_w && h.wd != 0.f) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  if (!skip) {
    m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g));
    v = __fadd_rn(__fmul_rn(h.b2, v),
                  __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
  }
  float u = __fdiv_rn(__fdiv_rn(m, bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps));
  if (h.adam_w && h.wd != 0.f) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  psum = fmaf(p, p, psum);
  usum = fmaf(u, u, usum);
}

__device__ __forceinline__ void load4(const float* g, int64_t i,
                                      float (&out)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(g + i);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* g, int64_t i,
                                      float (&out)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(g + i);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}
__device__ __forceinline__ float load1(const float* g, int64_t i) {
  return g[i];
}
__device__ __forceinline__ float load1(const __nv_bfloat16* g, int64_t i) {
  return __bfloat162float(g[i]);
}

// The block's two sums, reduced in a fixed order; thread 0 gets them.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float red[2][kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0.f;
    b = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
  }
}

template <typename G, bool kVec>
__global__ void __launch_bounds__(kThreads)
lamb_stage1_kernel(const G* __restrict__ g, const float* __restrict__ p,
                   float* __restrict__ m, float* __restrict__ v,
                   const float* __restrict__ scal,
                   float* __restrict__ partials, int64_t n, Hyper h) {
  const float gs = scal[0], bc1 = scal[1], bc2 = scal[2];
  const bool skip = scal[3] > 0.f;
  const int64_t start = (int64_t)blockIdx.x * kChunk;
  const int64_t end = start + kChunk < n ? start + kChunk : n;
  float psum = 0.f, usum = 0.f;
  if (kVec) {
    // n % 4 == 0, so a group that starts below `end` ends there too
    for (int64_t i = start + 4 * threadIdx.x; i < end; i += 4 * kThreads) {
      float gv[4];
      load4(g, i, gv);
      const float4 pv = *reinterpret_cast<const float4*>(p + i);
      float4 mv = *reinterpret_cast<const float4*>(m + i);
      float4 vv = *reinterpret_cast<const float4*>(v + i);
      lamb_elem(gv[0], pv.x, mv.x, vv.x, gs, bc1, bc2, skip, h, psum, usum);
      lamb_elem(gv[1], pv.y, mv.y, vv.y, gs, bc1, bc2, skip, h, psum, usum);
      lamb_elem(gv[2], pv.z, mv.z, vv.z, gs, bc1, bc2, skip, h, psum, usum);
      lamb_elem(gv[3], pv.w, mv.w, vv.w, gs, bc1, bc2, skip, h, psum, usum);
      *reinterpret_cast<float4*>(m + i) = mv;
      *reinterpret_cast<float4*>(v + i) = vv;
    }
  } else {
    for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
      float mi = m[i], vi = v[i];
      lamb_elem(load1(g, i), p[i], mi, vi, gs, bc1, bc2, skip, h, psum,
                usum);
      m[i] = mi;
      v[i] = vi;
    }
  }
  block_sum2(psum, usum);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = psum;
    partials[2 * blockIdx.x + 1] = usum;
  }
}

// sums[0..1] = the blocks' (p^2, u^2) pairs added in a fixed order.
__global__ void __launch_bounds__(kThreads)
lamb_sums_kernel(const float* __restrict__ partials, int64_t blocks,
                 float* __restrict__ sums) {
  float a = 0.f, b = 0.f;
  for (int64_t i = threadIdx.x; i < blocks; i += kThreads) {
    a += partials[2 * i];
    b += partials[2 * i + 1];
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    sums[0] = a;
    sums[1] = b;
  }
}

template <typename G>
int launch(const void* g, const float* p, float* m, float* v,
           const float* scal, float* partials, float* sums, int64_t n,
           const Hyper& h, bool vec, cudaStream_t s) {
  const int64_t blocks = (n + kChunk - 1) / kChunk;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec)
    lamb_stage1_kernel<G, true><<<grid, kThreads, 0, s>>>(
        static_cast<const G*>(g), p, m, v, scal, partials, n, h);
  else
    lamb_stage1_kernel<G, false><<<grid, kThreads, 0, s>>>(
        static_cast<const G*>(g), p, m, v, scal, partials, n, h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lamb_sums_kernel<<<1, kThreads, 0, s>>>(partials, blocks, sums);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* x) {
  return (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
}

}  // namespace

// Blocks of the first pass for n elements: the partials buffer holds
// 2 * apex_lamb_blocks(n) floats.
extern "C" long long apex_lamb_blocks(long long n) {
  return (n + kChunk - 1) / kChunk;
}

// g: n elements, g_dtype 0 = float32, 1 = bfloat16; p, m, v: n float32
// (m and v updated in place); scal: device float[4] = [g_scale, bc1, bc2,
// skip]; partials: float[2 * apex_lamb_blocks(n)] scratch; sums: float[2]
// out = [sum p^2, sum u^2].  one_minus_b1/b2 are 1 - b1 and 1 - b2 as the
// caller rounds them.  Returns cudaGetLastError().
extern "C" int apex_lamb_stage1(const void* g, const float* p, float* m,
                                float* v, const float* scal, float* partials,
                                float* sums, long long n, int g_dtype,
                                float b1, float one_minus_b1, float b2,
                                float one_minus_b2, float eps, float wd,
                                int adam_w, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, eps, wd, adam_w};
  const bool vec = n % 4 == 0 && aligned16(p) && aligned16(m) &&
                   aligned16(v) &&
                   (reinterpret_cast<uintptr_t>(g) & (g_dtype ? 7u : 15u)) ==
                       0;
  if (g_dtype == 0)
    return launch<float>(g, p, m, v, scal, partials, sums, n, h, vec, s);
  if (g_dtype == 1)
    return launch<__nv_bfloat16>(g, p, m, v, scal, partials, sums, n, h, vec,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
