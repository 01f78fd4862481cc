// Fused Q/K/V projections for Hopper (sm_90a):
//   q = x @ wq, k = x @ wk, v = x @ wv
// x [M, D], wq [D, Nq], wk / wv [D, Nkv] with Nkv <= Nq (GQA), float32 or
// bfloat16 (one dtype), float32 accumulation, outputs in x's dtype.
//
// Replaces: src/repro/kernels/qkv_proj.py `qkv_proj` (the Pallas
// `_qkv_kernel`, the paper's Alg. 9): each grid step loads one x block
// into VMEM and contracts it against the Q, K and V weight blocks, three
// f32 accumulators resident; blocks past the K/V width (`j < nkv_blocks`)
// skip the K and V work.
//
// Bound on the H100: weight bytes.  At qwen1.5-0.5b's 128 x 1024 -> 3 x 1024
// the three weights are 6.3 MB (1.9 us at 3.35 TB/s) against 0.8 us of bf16
// tensor work; at qwen2-72b's 128 x 8192 -> 8192 + 2 x 1024 they are
// 168 MB (50 us) against 21 us.
//
// Design: the main loop of mma_tile.cuh with three weight operands.  One
// CTA owns a BM x BN tile of Q over one K range; where its columns start
// inside Nkv it owns the K and V tiles of the same columns too, and each K
// step stages the x slice once and feeds the three accumulators.  CTAs
// past Nkv touch neither wk/wv nor k/v.  The K ranges come from M and K
// alone (k_splits), each summed in the same 16-wide slice order (bf16) or
// element order (f32) as tiled_matmul, and the ranges are added in the
// same order, so q, k and v equal three tiled_matmul launches bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

template <typename T>
struct StoreQKV {
  T* q;
  T* k;
  T* v;
  int nq, nkv;
  __device__ __forceinline__ void operator()(int r, int c,
                                             const float* a) const {
    q[(size_t)r * nq + c] = from_f<T>(a[0]);
    if (c < nkv) {
      k[(size_t)r * nkv + c] = from_f<T>(a[1]);
      v[(size_t)r * nkv + c] = from_f<T>(a[2]);
    }
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every operand and output shares it).
// splits, ws and plan as for tiled_matmul (ws: splits * M * (Nq + 2 Nkv)
// floats).
extern "C" int qkv_proj(const void* x, const void* wq, const void* wk,
                        const void* wv, void* q, void* k, void* v, int M,
                        int K, int Nq, int Nkv, int dtype, void* ws,
                        int splits, int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Nkv > Nq) return cudaErrorInvalidValue;
  if (dtype == 0 && splits == 1)
    return matmul_f32<3>(
        static_cast<const float*>(x),
        Weights<3, float>{{static_cast<const float*>(wq),
                           static_cast<const float*>(wk),
                           static_cast<const float*>(wv)},
                          {Nq, Nkv, Nkv}},
        M, K,
        StoreQKV<float>{static_cast<float*>(q), static_cast<float*>(k),
                        static_cast<float*>(v), Nq, Nkv},
        s, plan);
  if (dtype == 1)
    return matmul_bf16<3>(
        static_cast<const __nv_bfloat16*>(x),
        Weights<3, __nv_bfloat16>{{static_cast<const __nv_bfloat16*>(wq),
                                   static_cast<const __nv_bfloat16*>(wk),
                                   static_cast<const __nv_bfloat16*>(wv)},
                                  {Nq, Nkv, Nkv}},
        M, K, splits, static_cast<float*>(ws),
        StoreQKV<__nv_bfloat16>{static_cast<__nv_bfloat16*>(q),
                                static_cast<__nv_bfloat16*>(k),
                                static_cast<__nv_bfloat16*>(v), Nq, Nkv},
        s, plan);
  return cudaErrorInvalidValue;
}
