// Row normalisations for Hopper (sm_90a), float32 arithmetic, output in
// x's dtype:
//   layernorm: y = (x - mu) * rsqrt(var + eps) * gamma + beta, with
//              mu = sum(x) / D and the centred var = sum((x - mu)^2) / D
//   rmsnorm:   y = x * rsqrt(sum(x^2) / D + eps) * gamma
// x [R, D] in float32 or bfloat16; gamma / beta [D] in float32 or x's dtype.
//
// Replaces: src/repro/kernels/layernorm.py `layernorm` and `rmsnorm` (the
// Pallas `_ln_kernel` / `_rms_kernel`): one row block whole in VMEM, the
// four passes of the paper's LN unit fused into one read and one write,
// the row padded to 128 lanes in HBM and the pad masked.
//
// Bound on the H100: bytes.  A row is read once and written once, a few
// operations per element (0.5 MB at 128 x 1024 bf16: 0.16 us at 3.35 TB/s).
//
// Design: one CTA of 256 threads per row.  The row is read once from device
// memory into shared memory as float32 (threads on consecutive elements),
// and both passes of the centred variance run over that copy, as the Pallas
// kernel holds the row in VMEM: sum -> mu, then sum of (x - mu)^2 -> var,
// each reduced across the CTA by warp shuffles and one shared-memory step.
// Nothing is padded; a row longer than shared memory holds is refused.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "dtype.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 227 * 1024;      // a block's shared memory limit

// Sum over the CTA; every thread gets the total.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                        // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  return t;
}

// a float32 or bfloat16 parameter element
__device__ __forceinline__ float param(const void* p, int f32, int i) {
  return f32 ? static_cast<const float*>(p)[i]
             : to_f(static_cast<const __nv_bfloat16*>(p)[i]);
}

template <typename T, bool RMS>
__global__ void __launch_bounds__(kThreads)
    norm_rows(const T* __restrict__ x, const void* gamma, const void* beta,
              T* __restrict__ y, int D, int p_f32, float eps) {
  extern __shared__ float row[];
  __shared__ float red[kThreads / 32];
  const size_t base = (size_t)blockIdx.x * D;
  const float d = static_cast<float>(D);

  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_f(x[base + i]);
    row[i] = v;
    s += RMS ? v * v : v;
  }
  const float tot = block_sum(s, red);
  float mu = 0.f, r;
  if constexpr (RMS) {
    r = rsqrtf(tot / d + eps);
  } else {
    mu = tot / d;
    float c2 = 0.f;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float c = row[i] - mu;
      c2 += c * c;
    }
    r = rsqrtf(block_sum(c2, red) / d + eps);
  }
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float g = param(gamma, p_f32, i);
    float out;
    if constexpr (RMS) {
      out = row[i] * r * g;
    } else {
      out = (row[i] - mu) * r * g + param(beta, p_f32, i);
    }
    y[base + i] = from_f<T>(out);
  }
}

template <typename T, bool RMS>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   void* y, int R, int D, int p_f32, float eps,
                   cudaStream_t stream) {
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        norm_rows<T, RMS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  norm_rows<T, RMS><<<R, kThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), D, p_f32,
      eps);
  return cudaGetLastError();
}

template <bool RMS>
int dispatch(const void* x, const void* gamma, const void* beta, void* y,
             int R, int D, int dtype, int p_f32, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float, RMS>(x, gamma, beta, y, R, D, 1, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, RMS>(x, gamma, beta, y, R, D, p_f32, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it); p_f32: 1 if gamma
// (and beta) are float32, 0 if they are in x's dtype.
extern "C" int layernorm(const void* x, const void* gamma, const void* beta,
                         void* y, int R, int D, int dtype, int p_f32,
                         float eps, void* stream) {
  return dispatch<false>(x, gamma, beta, y, R, D, dtype, p_f32, eps, stream);
}

extern "C" int rmsnorm(const void* x, const void* gamma, void* y, int R,
                       int D, int dtype, int p_f32, float eps, void* stream) {
  return dispatch<true>(x, gamma, nullptr, y, R, D, dtype, p_f32, eps, stream);
}
