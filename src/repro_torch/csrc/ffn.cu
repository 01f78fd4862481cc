// The first FFN projection with its epilogue fused, for Hopper (sm_90a):
//   ffn1:       out = act(x @ w1 + b1)
//   ffn1_gated: out = act(x @ wg) * (x @ w1)
// x [M, D], w1 / wg [D, F] (float32 or bfloat16, one dtype), b1 [F] in
// float32 or x's dtype, float32 accumulation, out [M, F] in x's dtype.
//
// Replaces: src/repro/kernels/ffn.py `ffn1` and `ffn1_gated` (the Pallas
// `_ffn_kernel` / `_gated_kernel`): a sequential K grid axis into one (or,
// gated, two) VMEM f32 accumulators, bias and activation applied to the
// accumulator before the single write-back, ragged edges zero-padded in HBM.
//
// Bound on the H100: at the mixed step's 128 rows and a 1024 x 2816 weight
// (qwen1.5-0.5b) the weight bytes dominate: 5.8 MB (11.5 MB gated) is
// 1.7 us (3.4 us) at 3.35 TB/s against 0.75 us (1.5 us) of bf16 tensor
// work.  At BERT-base's 512 x 768 x 3072 the two are about even.
//
// Design: the main loop of mma_tile.cuh (bf16: cp.async ring, ldmatrix,
// mma.sync, K split into ranges by k_splits; f32: FMA), with one weight
// operand (ffn1) or two that share each staged x tile (gated: two
// accumulators per output element, as the Pallas kernel keeps two VMEM
// scratches).  The epilogue adds the bias and applies the activation to
// the full f32 sum (after the ranges' partial sums are added, in order,
// where K is split), then rounds once to x's dtype, so the [M, F]
// pre-activation never reaches device memory.  Activations: relu, gelu in
// the tanh form (jax.nn.gelu(approximate=True)), silu = x * sigmoid(x).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

// activation codes of the C interface: 0 relu, 1 gelu (tanh), 2 silu
__device__ __forceinline__ float activate(float x, int act) {
  if (act == 0) return fmaxf(x, 0.f);
  if (act == 1) {
    const float u = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
    return x * (0.5f * (1.f + tanhf(u)));
  }
  return x / (1.f + expf(-x));
}

template <typename T>
struct BiasAct {
  T* out;
  const void* bias;
  int n, bias_f32, act;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const float* v) const {
    const float b = bias_f32 ? static_cast<const float*>(bias)[c]
                             : to_f(static_cast<const T*>(bias)[c]);
    out[(size_t)r * n + c] = from_f<T>(activate(v[0] + b, act));
  }
};

// v[0] = x @ w1, v[1] = x @ wg
template <typename T>
struct Gated {
  T* out;
  int n, act;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const float* v) const {
    out[(size_t)r * n + c] = from_f<T>(activate(v[1], act) * v[0]);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w1 and out share it); bias_f32: 1 if
// b1 is float32, 0 if it is in x's dtype.  splits, ws and plan as for
// tiled_matmul (ws: splits * M * N floats, gated 2 * splits * M * N).
extern "C" int ffn1(const void* x, const void* w1, const void* b1, void* out,
                    int M, int K, int N, int dtype, int bias_f32, int act,
                    void* ws, int splits, int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < 0 || act > 2) return cudaErrorInvalidValue;
  if (dtype == 0 && splits == 1)
    return matmul_f32<1>(
        static_cast<const float*>(x),
        Weights<1, float>{{static_cast<const float*>(w1)}, {N}}, M, K,
        BiasAct<float>{static_cast<float*>(out), b1, N, bias_f32, act}, s,
        plan);
  if (dtype == 1)
    return matmul_bf16<1>(
        static_cast<const __nv_bfloat16*>(x),
        Weights<1, __nv_bfloat16>{{static_cast<const __nv_bfloat16*>(w1)},
                                  {N}},
        M, K, splits, static_cast<float*>(ws),
        BiasAct<__nv_bfloat16>{static_cast<__nv_bfloat16*>(out), b1, N,
                               bias_f32, act},
        s, plan);
  return cudaErrorInvalidValue;
}

extern "C" int ffn1_gated(const void* x, const void* w1, const void* wg,
                          void* out, int M, int K, int N, int dtype, int act,
                          void* ws, int splits, int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act < 0 || act > 2) return cudaErrorInvalidValue;
  if (dtype == 0 && splits == 1)
    return matmul_f32<2>(
        static_cast<const float*>(x),
        Weights<2, float>{{static_cast<const float*>(w1),
                           static_cast<const float*>(wg)},
                          {N, N}},
        M, K, Gated<float>{static_cast<float*>(out), N, act}, s, plan);
  if (dtype == 1)
    return matmul_bf16<2>(
        static_cast<const __nv_bfloat16*>(x),
        Weights<2, __nv_bfloat16>{{static_cast<const __nv_bfloat16*>(w1),
                                   static_cast<const __nv_bfloat16*>(wg)},
                                  {N, N}},
        M, K, splits, static_cast<float*>(ws),
        Gated<__nv_bfloat16>{static_cast<__nv_bfloat16*>(out), N, act}, s,
        plan);
  return cudaErrorInvalidValue;
}
