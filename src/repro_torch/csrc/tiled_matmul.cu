// Tiled matmul C[M,N] = A[M,K] @ B[K,N] for Hopper (sm_90a), float32 or
// bfloat16 operands, float32 accumulation, output in A's dtype.
//
// Replaces: src/repro/kernels/tiled_matmul.py `tiled_matmul` (the Pallas
// `_matmul_kernel`): a sequential K grid axis accumulating into a VMEM f32
// scratch, with ragged edges zero-padded in HBM before the call.
//
// Bound on the H100: on the serving path M is the step's query rows
// (max_batch for a decode step, max_batch * chunk for a mixed step, at most
// 128) while K x N is a weight of 1024 x 1024 (wq/wk/wv/wo), 1024 x 2816
// (w1/wg) or 2816 x 1024 (w2).  Reading the weight once dominates the bytes:
// a 1024 x 2816 bf16 weight is 5.8 MB, ~1.7 us at 3.35 TB/s, against
// 2*128*1024*2816 = 0.74 GFLOP, 0.75 us at the 989 TFLOP/s bf16 tensor rate.
// So the kernel is bound by weight bytes at every main-path shape.
//
// Design: the main loop of mma_tile.cuh with one weight operand and an
// epilogue that rounds the f32 sum once to A's dtype.  bf16 runs on tensor
// cores: a 4-stage cp.async ring in dynamic shared memory, ldmatrix
// fragments, mma.sync m16n8k16; BM covers M (16 or 128 rows) so the weight
// crosses HBM once, and K is split into ranges (k_splits in
// kernels/tiled_matmul.py, from M and K alone) whose f32 partial sums a
// reduce pass adds in order, so the serving shapes fill the card:
// 128 x 1024 x 2816 runs 44 tiles x 4 ranges.  f32 runs on FMA (K summed
// in order 0..K-1, one stage through registers).  Ragged edges are masked
// at the loads and at the store; nothing is padded in device memory, and
// neither result depends on the tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

template <typename T>
struct StoreC {
  T* c;
  int n;
  __device__ __forceinline__ void operator()(int r, int col,
                                             const float* v) const {
    c[(size_t)r * n + col] = from_f<T>(v[0]);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (A, B and C share it).  splits: K
// ranges (1 for float32); with splits > 1, ws holds splits * M * N floats.
// plan (may be null) receives output tiles, K ranges and dynamic shared
// memory bytes of the launch.
extern "C" int tiled_matmul(const void* a, const void* b, void* c, int M,
                            int K, int N, int dtype, void* ws, int splits,
                            int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && splits == 1)
    return matmul_f32<1>(static_cast<const float*>(a),
                         Weights<1, float>{{static_cast<const float*>(b)}, {N}},
                         M, K, StoreC<float>{static_cast<float*>(c), N}, s,
                         plan);
  if (dtype == 1)
    return matmul_bf16<1>(
        static_cast<const __nv_bfloat16*>(a),
        Weights<1, __nv_bfloat16>{{static_cast<const __nv_bfloat16*>(b)}, {N}},
        M, K, splits, static_cast<float*>(ws),
        StoreC<__nv_bfloat16>{static_cast<__nv_bfloat16*>(c), N}, s, plan);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
