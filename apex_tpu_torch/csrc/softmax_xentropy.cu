// Fused softmax cross-entropy with label smoothing, forward and backward.
//
// Replaces:
// - apex_tpu/ops/softmax_xentropy.py::_xent_fwd_kernel (launched by
//   _xent_fwd_impl) with apex_xent_fwd: per row an online logsumexp over
//   the vocab, the label logit and, for smoothing, the logit sum; loss =
//   (1 - eps) * (lse - l[label]) + eps * (lse - sum(l) / V) in fp32, and
//   lse as a second output;
// - apex_tpu/ops/softmax_xentropy.py::_xent_bwd_kernel (launched by
//   _xent_bwd_rule) with apex_xent_bwd: dlogits = (exp(l - lse) - target)
//   * g with target = (1 - eps) * onehot(label) + eps / V, written in the
//   logits' dtype.
// All arithmetic in fp32 (bf16 or fp32 logits upcast on load).  A label
// outside [0, V) contributes a label logit of 0, as the reference
// kernel's one-hot compare does.
//
// Bound on the H100: bytes.  At the training shape (16384 rows, V 50304,
// bf16) the forward reads 1.65 GB of logits once: 0.49 ms at 3.35 TB/s;
// the backward reads them and writes dlogits, 3.3 GB: 0.98 ms.  The exp
// per element (~0.8 G of them) is under the byte time on the SFUs.
//
// Design: one block of 256 threads per row; threads stride the row in
// 16-byte vectors (8 bf16 or 4 fp32) when the rows are 16-byte aligned,
// one element at a time otherwise, so any V and any row stride work and
// a ragged vocab tail needs no padding (the reference masks its last vocab
// tile in-kernel for the same reason).  Forward: each thread keeps a
// running (max, sum of exp) and rescales once per vector, then the
// block combines the 256 pairs (max first, then the rescaled sums) by
// warp shuffles and a fixed-order shared-memory step.  Backward: one pass,
// no state across the row but lse and the label.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

template <typename T>
struct Vec;  // 16 bytes of T
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float (&x)[kN]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static void store(float* p, const float (&x)[kN]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&x)[kN]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&x)[kN]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Fold one element into a running (max, sum of exp(x - max)).
__device__ __forceinline__ void online_add(float x, float& m, float& s) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ logits, long long ld,
                const int64_t* __restrict__ labels, float* __restrict__ loss,
                float* __restrict__ lse_out, int v, float smoothing,
                int vec) {
  using V = Vec<T>;
  const int64_t row = blockIdx.x;
  const T* lr = logits + row * ld;
  float m = kNegInf, s = 0.f, tot = 0.f;
  int tail = 0;
  if (vec) {
    const int nvec = v / V::kN;
    for (int c = threadIdx.x; c < nvec; c += kThreads) {
      float x[V::kN];
      V::load(lr + static_cast<int64_t>(c) * V::kN, x);
      float cm = x[0];
#pragma unroll
      for (int i = 1; i < V::kN; ++i) cm = fmaxf(cm, x[i]);
      if (cm > m) {
        s *= expf(m - cm);
        m = cm;
      }
#pragma unroll
      for (int i = 0; i < V::kN; ++i) {
        s += expf(x[i] - m);
        tot += x[i];
      }
    }
    tail = nvec * V::kN;
  }
  for (int i = tail + threadIdx.x; i < v; i += kThreads) {
    const float x = to_f32(lr[i]);
    online_add(x, m, s);
    tot += x;
  }
  // block combine: the max, then the sums rescaled to it, in warp order
  __shared__ float red[3][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float wm = m;
  for (int o = 16; o > 0; o >>= 1)
    wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, o));
  if (lane == 0) red[0][warp] = wm;
  __syncthreads();
  float gm = red[0][0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) gm = fmaxf(gm, red[0][i]);
  float ws = s * expf(m - gm), wt = tot;
  for (int o = 16; o > 0; o >>= 1) {
    ws += __shfl_xor_sync(0xffffffffu, ws, o);
    wt += __shfl_xor_sync(0xffffffffu, wt, o);
  }
  if (lane == 0) {
    red[1][warp] = ws;
    red[2][warp] = wt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float gs = 0.f, gt = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      gs += red[1][i];
      gt += red[2][i];
    }
    const float lse = gm + logf(gs);
    const int64_t lab = labels[row];
    const float ll = (lab >= 0 && lab < v) ? to_f32(lr[lab]) : 0.f;
    float out = lse - ll;
    if (smoothing != 0.f) {
      const float smooth = lse - gt / static_cast<float>(v);
      out = (1.f - smoothing) * out + smoothing * smooth;
    }
    loss[row] = out;
    lse_out[row] = lse;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ logits, long long ld,
                const int64_t* __restrict__ labels,
                const float* __restrict__ g, const float* __restrict__ lse,
                T* __restrict__ dlogits, int v, float smoothing, int vec) {
  using V = Vec<T>;
  const int64_t row = blockIdx.x;
  const T* lr = logits + row * ld;
  T* dr = dlogits + row * static_cast<int64_t>(v);
  const float gr = g[row];
  const float lr_lse = lse[row];
  const int64_t lab = labels[row];
  const float hit = 1.f - smoothing;
  const float base = smoothing != 0.f ? smoothing / static_cast<float>(v)
                                      : 0.f;
  int tail = 0;
  if (vec) {
    const int nvec = v / V::kN;
    for (int c = threadIdx.x; c < nvec; c += kThreads) {
      float x[V::kN];
      V::load(lr + static_cast<int64_t>(c) * V::kN, x);
#pragma unroll
      for (int i = 0; i < V::kN; ++i) {
        const int64_t col = static_cast<int64_t>(c) * V::kN + i;
        const float target = (col == lab ? hit : 0.f) + base;
        x[i] = (expf(x[i] - lr_lse) - target) * gr;
      }
      V::store(dr + static_cast<int64_t>(c) * V::kN, x);
    }
    tail = nvec * V::kN;
  }
  for (int i = tail + threadIdx.x; i < v; i += kThreads) {
    const float target = (i == lab ? hit : 0.f) + base;
    store_f32(dr + i, (expf(to_f32(lr[i]) - lr_lse) - target) * gr);
  }
}

}  // namespace

// logits: (rows, v) with row stride ld elements, dtype 0 = float32,
// 1 = bfloat16; labels: int64 (rows,); loss, lse: fp32 (rows,).  vec = 1
// when logits and ld allow 16-byte loads (the wrapper decides).  Returns
// cudaGetLastError().
extern "C" int apex_xent_fwd(const void* logits, long long ld,
                             const int64_t* labels, float* loss, float* lse,
                             long long rows, int v, float smoothing,
                             int dtype, int vec, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows));
  if (dtype == 0) {
    xent_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(logits), ld, labels, loss, lse, v,
        smoothing, vec);
  } else if (dtype == 1) {
    xent_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), ld, labels, loss, lse, v,
        smoothing, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dlogits: contiguous (rows, v) of the logits' dtype; g, lse: fp32
// (rows,).  vec = 1 when the logits, ld, dlogits and v allow 16-byte
// accesses.  Returns cudaGetLastError().
extern "C" int apex_xent_bwd(const void* logits, long long ld,
                             const int64_t* labels, const float* g,
                             const float* lse, void* dlogits,
                             long long rows, int v, float smoothing,
                             int dtype, int vec, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows));
  if (dtype == 0) {
    xent_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(logits), ld, labels, g, lse,
        static_cast<float*>(dlogits), v, smoothing, vec);
  } else if (dtype == 1) {
    xent_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), ld, labels, g, lse,
        static_cast<__nv_bfloat16*>(dlogits), v, smoothing, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
