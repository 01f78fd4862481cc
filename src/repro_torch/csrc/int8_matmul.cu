// Quantized matmul for Hopper (sm_90a): int8 activations x int8 weights,
// exact int32 accumulation, rescaled at the write-back:
//   C[m, n] = float(sum_k x[m, k] * w[k, n]) * (sx * sw[n])
// cast once to the output dtype (float32 or bfloat16).  sx is the per-tensor
// activation scale (a device scalar: the wrapper computes it on the card, so
// reading it costs no host sync), sw the per-column weight scales.
//
// Replaces: src/repro/kernels/int8_matmul.py `int8_matmul` (the Pallas
// `_int8_kernel`): a (M, N, K) grid whose sequential K axis accumulates
// into a VMEM int32 scratch and whose last K step rescales with
// acc * (sx * sw) -- the epilogue order kept here.  The TPU pads every edge
// to its tile in HBM before the call; here nothing is padded.
//
// Bound on the H100: on the serving path M is the step's query rows (8 for
// a decode step, 128 for a mixed step) and the weight is 1024 x 1024,
// 1024 x 2816 or 2816 x 1024 int8.  Reading the weight once dominates:
// 1024 x 2816 bytes = 2.9 MB, ~0.86 us at 3.35 TB/s, against 2*128*1024*2816
// = 0.74 Gop, 0.37 us at the 1979 Top/s int8 tensor rate.  So the kernel is
// bound by weight bytes at every main-path shape, at half the bytes of the
// bf16 tiled_matmul.
//
// Design: the structure of csrc/tiled_matmul.cu.  One CTA of 4 warps owns a
// BM x BN output tile and loops over K itself; each K step stages a BK-deep
// slice of X and W in shared memory while the next slice is fetched into
// registers.  Tensor cores take the product through mma.sync m16n8k32 (s8 x
// s8 -> s32).  Its B operand is "col": each 32-bit register holds 4
// consecutive k of one column, but W is stored [K, N] row-major and ldmatrix
// .trans exists only for 16-bit elements, so each W slice is transposed into
// shared memory ([n][k]) as it is stored.  Rows are padded by 16 bytes so the
// fragment loads of a warp (8 rows x 4 words) fall in 32 distinct banks.
// Global loads are 16 bytes (16 int8) where a row's start is 16-byte aligned
// and the vector lies inside the matrix; ragged edges load byte by byte with
// zero fill, and the store is masked.  Integer sums are exact, so the
// result does not depend on the tiling or the order of the K steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dtype.cuh"

namespace {

constexpr int kThreads = 128;

// D = A(16x32 s8, row) * B(32x8 s8, col) + D, int32 accumulate.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes of row `base` from column `col` on (zero past `ncols`): one
// vector load when `vec` (16-byte aligned rows) and the vector is inside.
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ base,
                                        int col, int ncols, bool vec) {
  if (vec && col + 16 <= ncols) return *reinterpret_cast<const uint4*>(base + col);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (col + e < ncols)
      w[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(base[col + e]))
                   << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename TO, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_mma(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                    const float* __restrict__ sx, const float* __restrict__ sw,
                    TO* __restrict__ C, int M, int K, int N, bool vec_x,
                    bool vec_w) {
  constexpr int WN = BN / 4;            // columns per warp
  constexpr int NT = WN / 8;            // n8 tiles per warp
  constexpr int MT = BM / 16;           // m16 tiles
  constexpr int PA = BK + 16;           // padded smem rows (bytes)
  constexpr int PB = BK + 16;
  constexpr int X_PER = (BM * BK) / (kThreads * 16);
  constexpr int W_PER = (BK * BN) / (kThreads * 16);
  static_assert(BK % 32 == 0 && WN % 8 == 0 && BM % 16 == 0, "mma tiles");
  static_assert(X_PER * kThreads * 16 == BM * BK &&
                    W_PER * kThreads * 16 == BK * BN,
                "tile split");
  static_assert((PA / 4) % 32 == 4 && (PB / 4) % 32 == 4, "bank spread");

  __shared__ __align__(16) int8_t Xs[BM * PA];   // [m][k]
  __shared__ __align__(16) int8_t Ws[BN * PB];   // [n][k] (transposed)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  uint4 x_reg[X_PER], w_reg[W_PER];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < X_PER; ++i) {
      const int idx = (tid + i * kThreads) * 16;  // consecutive threads: along K
      const int gm = m0 + idx / BK, gk = k0 + idx % BK;
      x_reg[i] = (gm < M && gk < K)
                     ? load16(X + (size_t)gm * K, gk, K, vec_x)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < W_PER; ++i) {
      const int idx = (tid + i * kThreads) * 16;  // consecutive threads: along N
      const int gk = k0 + idx / BN, gn = n0 + idx % BN;
      w_reg[i] = (gk < K && gn < N)
                     ? load16(W + (size_t)gk * N, gn, N, vec_w)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < X_PER; ++i) {
      const int idx = (tid + i * kThreads) * 16;
      *reinterpret_cast<uint4*>(&Xs[(idx / BK) * PA + idx % BK]) = x_reg[i];
    }
#pragma unroll
    for (int i = 0; i < W_PER; ++i) {
      const int idx = (tid + i * kThreads) * 16;
      const int k = idx / BN, n = idx % BN;
      const int8_t* b = reinterpret_cast<const int8_t*>(&w_reg[i]);
#pragma unroll
      for (int e = 0; e < 16; ++e) Ws[(n + e) * PB + k] = b[e];
    }
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);       // next slice in flight meanwhile
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int kb = ks * 32 + t * 4;
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + g;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&Xs[r * PA + kb]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&Xs[(r + 8) * PA + kb]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&Xs[r * PA + kb + 16]);
        af[mt][3] =
            *reinterpret_cast<const uint32_t*>(&Xs[(r + 8) * PA + kb + 16]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = warp * WN + nt * 8 + g;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(&Ws[n * PB + kb]);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(&Ws[n * PB + kb + 16]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();
  }

  const float sxv = *sx;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = m0 + mt * 16 + g;
      const int c = n0 + warp * WN + nt * 8 + t * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gr = r + (e >> 1) * 8, gc = c + (e & 1);
        if (gr < M && gc < N)
          C[(size_t)gr * N + gc] =
              from_f<TO>(static_cast<float>(acc[mt][nt][e]) * (sxv * sw[gc]));
      }
    }
  }
}

template <typename TO, int BM, int BN, int BK>
cudaError_t launch(const void* x, const void* w, const float* sx,
                   const float* sw, void* c, int M, int K, int N, bool vec_x,
                   bool vec_w, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_mma<TO, BM, BN, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), sx, sw,
      static_cast<TO*>(c), M, K, N, vec_x, vec_w);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t dispatch(const void* x, const void* w, const float* sx,
                     const float* sw, void* c, int M, int K, int N,
                     cudaStream_t stream) {
  const bool vec_x = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (M <= 16)
    return launch<TO, 16, 32, 128>(x, w, sx, sw, c, M, K, N, vec_x, vec_w,
                                   stream);
  return launch<TO, 64, 32, 128>(x, w, sx, sw, c, M, K, N, vec_x, vec_w,
                                 stream);
}

}  // namespace

// x [M, K] int8, w [K, N] int8 (row-major), sx a device float, sw [N] float,
// c [M, N] in out_dtype: 0 = float32, 1 = bfloat16.
extern "C" int int8_matmul(const void* x, const void* w, const float* sx,
                           const float* sw, void* c, int M, int K, int N,
                           int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (out_dtype == 0) return dispatch<float>(x, w, sx, sw, c, M, K, N, s);
  if (out_dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, sx, sw, c, M, K, N, s);
  return cudaErrorInvalidValue;
}
