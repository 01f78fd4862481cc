// The main loop shared by the port's float matmul kernels (tiled_matmul,
// ffn1, ffn1_gated, qkv_proj): NB products A[M,K] @ W[b][K, n[b]] that
// share one staged A tile, float32 accumulation, and an epilogue that sees
// the NB accumulators of each output element at once.
//
// One CTA owns one BM x BN output tile and loops over K itself (the TPU's
// sequential K grid axis becomes a loop inside the block; blocks run in
// parallel and carry nothing between them).  Each K step stages a BK-deep
// slice of A and of every live W[b] in shared memory; the next slice is
// fetched into registers while the current one is multiplied.  A CTA whose
// first column lies at or past n[b] neither loads W[b] nor multiplies it
// (qkv_proj's narrower GQA K/V: the Pallas kernel's `j < nkv_blocks`
// guard).  Ragged edges are masked at the loads (zero fill); the epilogue
// is called for rows < M and columns < n[0] (n[0] is the widest) and masks
// narrower outputs itself.  Nothing is padded in device memory.
//  * bf16: tensor cores through mma.sync m16n8k16 (bf16 in, f32
//    accumulate).  Each warp owns BN/4 columns of the tile; the K terms are
//    added in 16-wide slices in order 0, 16, 32, ..., so the result does
//    not depend on BM/BN/BK (BK is a multiple of 16), nor on NB: a product
//    computed beside others equals the same product computed alone, bit
//    for bit.
//  * f32: plain FMA in f32 (tensor cores would round the inputs to TF32);
//    every thread adds the K terms of its outputs in order 0..K-1, so the
//    result does not depend on the tiles or on NB either.
// Small M (decode) takes narrow tiles so more CTAs stream the weights.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "dtype.cuh"
#include "mma_sync.cuh"

namespace {

// NB weight operands, row-major [K, n[b]], that share the A operand.
template <int NB, typename T>
struct Weights {
  const T* w[NB];
  int n[NB];
};

template <int NB, int BM, int BN, int BK, int TM, int TN, class Epi>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    fma_tile(const float* __restrict__ A, const Weights<NB, float> W, int M,
             int K, const Epi epi) {
  constexpr int TCOLS = BN / TN;            // threads across the tile's columns
  constexpr int TROWS = BM / TM;            // threads across the tile's rows
  constexpr int NT = TCOLS * TROWS;
  constexpr int A_PER = (BM * BK) / NT;     // A elements each thread stages
  constexpr int B_PER = (BK * BN) / NT;
  static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0, "tile split");

  __shared__ float As[BK][BM];              // k-major: a k step reads a row
  __shared__ float Bs[NB][BK][BN];

  const int tid = threadIdx.x;
  const int tcol = tid % TCOLS;
  const int trow = tid / TCOLS;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  bool live[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) live[b] = n0 < W.n[b];

  float acc[NB][TM][TN];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[b][i][j] = 0.f;

  float a_reg[A_PER], b_reg[NB][B_PER];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * NT;
      const int r = idx / BK, c = idx % BK;  // consecutive threads: along K
      const int gm = m0 + r, gk = k0 + c;
      a_reg[i] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (!live[b]) continue;
      const int N = W.n[b];
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int idx = tid + i * NT;
        const int r = idx / BN, c = idx % BN;  // consecutive threads: along N
        const int gk = k0 + r, gn = n0 + c;
        b_reg[b][i] = (gk < K && gn < N) ? W.w[b][(size_t)gk * N + gn] : 0.f;
      }
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * NT;
      As[idx % BK][idx / BK] = a_reg[i];
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (!live[b]) continue;
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int idx = tid + i * NT;
        Bs[b][idx / BN][idx % BN] = b_reg[b][i];
      }
    }
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);       // next slice in flight meanwhile
    const int kmax = min(BK, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][trow + i * TROWS];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (!live[b]) continue;
        float w[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) w[j] = Bs[b][kk][tcol + j * TCOLS];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[b][i][j] = fmaf(a[i], w[j], acc[b][i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + trow + i * TROWS;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tcol + j * TCOLS;
      if (gn >= W.n[0]) continue;
      float v[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) v[b] = acc[b][i][j];
      epi(gm, gn, v);
    }
  }
}


// VEC: operands are staged with 16-byte loads of 8 bf16 (needs K and every
// n[b] to be multiples of 8 and 16-byte aligned pointers); otherwise one
// element per load, which also takes ragged K and N.
template <int NB, int BM, int BN, int BK, bool VEC, class Epi>
__global__ void __launch_bounds__(128)
    mma_tile(const __nv_bfloat16* __restrict__ A,
             const Weights<NB, __nv_bfloat16> W, int M, int K,
             const Epi epi) {
  constexpr int NTHR = 128;
  constexpr int WN = BN / 4;            // columns per warp
  constexpr int NT = WN / 8;            // n8 tiles per warp
  constexpr int MT = BM / 16;           // m16 tiles
  constexpr int PA = BK + 8;            // padded smem rows (bf16 elements)
  constexpr int PB = BN + 8;
  constexpr int E = VEC ? 8 : 1;        // elements per load
  constexpr int A_PER = (BM * BK) / (NTHR * E);
  constexpr int B_PER = (BK * BN) / (NTHR * E);
  using L = typename std::conditional<VEC, uint4, __nv_bfloat16>::type;
  static_assert(BK % 16 == 0 && WN % 8 == 0 && BM % 16 == 0, "mma tiles");
  static_assert(A_PER * NTHR * E == BM * BK && B_PER * NTHR * E == BK * BN,
                "tile split");

  __shared__ __align__(16) __nv_bfloat16 As[BM * PA];       // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[NB][BK * PB];   // [k][n]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  bool live[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) live[b] = n0 < W.n[b];
  L zero;
  if constexpr (VEC) zero = make_uint4(0, 0, 0, 0);
  else zero = __float2bfloat16(0.f);

  float acc[NB][MT][NT][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][i][j][e] = 0.f;

  L a_reg[A_PER], b_reg[NB][B_PER];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = (tid + i * NTHR) * E;  // consecutive threads: along K
      const int gm = m0 + idx / BK, gk = k0 + idx % BK;
      a_reg[i] = (gm < M && gk < K)
                     ? *reinterpret_cast<const L*>(A + (size_t)gm * K + gk)
                     : zero;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (!live[b]) continue;
      const int N = W.n[b];
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int idx = (tid + i * NTHR) * E;  // consecutive threads: along N
        const int gk = k0 + idx / BN, gn = n0 + idx % BN;
        b_reg[b][i] =
            (gk < K && gn < N)
                ? *reinterpret_cast<const L*>(W.w[b] + (size_t)gk * N + gn)
                : zero;
      }
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = (tid + i * NTHR) * E;
      *reinterpret_cast<L*>(&As[(idx / BK) * PA + idx % BK]) = a_reg[i];
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (!live[b]) continue;
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int idx = (tid + i * NTHR) * E;
        *reinterpret_cast<L*>(&Bs[b][(idx / BN) * PB + idx % BN]) =
            b_reg[b][i];
      }
    }
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);       // next slice in flight meanwhile
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int kb = ks * 16 + (lane & 3) * 2;
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + (lane >> 2);
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r * PA + kb]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[(r + 8) * PA + kb]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r * PA + kb + 8]);
        af[mt][3] =
            *reinterpret_cast<const uint32_t*>(&As[(r + 8) * PA + kb + 8]);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (!live[b]) continue;
        const __nv_bfloat16* Bb = Bs[b];
        uint32_t bf[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = warp * WN + nt * 8 + (lane >> 2);
          bf[nt][0] = pack2(Bb[kb * PB + n], Bb[(kb + 1) * PB + n]);
          bf[nt][1] = pack2(Bb[(kb + 8) * PB + n], Bb[(kb + 9) * PB + n]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[b][mt][nt], af[mt], bf[nt]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = m0 + mt * 16 + (lane >> 2);
      const int c = n0 + warp * WN + nt * 8 + (lane & 3) * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gr = r + (e >> 1) * 8, gc = c + (e & 1);
        if (gr >= M || gc >= W.n[0]) continue;
        float v[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b) v[b] = acc[b][mt][nt][e];
        epi(gr, gc, v);
      }
    }
  }
}

template <int NB, int BM, int BN, int BK, int TM, int TN, class Epi>
cudaError_t launch_fma(const float* a, const Weights<NB, float>& w, int M,
                       int K, const Epi& epi, cudaStream_t stream) {
  dim3 grid((w.n[0] + BN - 1) / BN, (M + BM - 1) / BM);
  dim3 block((BM / TM) * (BN / TN));
  fma_tile<NB, BM, BN, BK, TM, TN, Epi><<<grid, block, 0, stream>>>(
      a, w, M, K, epi);
  return cudaGetLastError();
}

template <int NB, int BM, int BN, int BK, bool VEC, class Epi>
cudaError_t launch_mma(const __nv_bfloat16* a,
                       const Weights<NB, __nv_bfloat16>& w, int M, int K,
                       const Epi& epi, cudaStream_t stream) {
  dim3 grid((w.n[0] + BN - 1) / BN, (M + BM - 1) / BM);
  mma_tile<NB, BM, BN, BK, VEC, Epi><<<grid, 128, 0, stream>>>(a, w, M, K,
                                                                epi);
  return cudaGetLastError();
}

template <int NB>
bool valid_shapes(int M, int K, const int* n) {
  if (M <= 0 || K <= 0) return false;
  for (int b = 0; b < NB; ++b)
    if (n[b] <= 0 || n[b] > n[0]) return false;
  return true;
}

// f32 operands and accumulators, FMA; the tiles depend on M only.
template <int NB, class Epi>
cudaError_t matmul_f32(const float* a, const Weights<NB, float>& w, int M,
                       int K, const Epi& epi, cudaStream_t stream) {
  if (!valid_shapes<NB>(M, K, w.n)) return cudaErrorInvalidValue;
  if (M <= 16)
    return launch_fma<NB, 16, 32, 64, 1, 2>(a, w, M, K, epi, stream);
  return launch_fma<NB, 64, 64, 32, 4, 4>(a, w, M, K, epi, stream);
}

// bf16 operands, f32 accumulators, mma.sync; the tiles depend on M only,
// the load width on K, the n[b] and the pointers' alignment.
template <int NB, class Epi>
cudaError_t matmul_bf16(const __nv_bfloat16* a,
                        const Weights<NB, __nv_bfloat16>& w, int M, int K,
                        const Epi& epi, cudaStream_t stream) {
  if (!valid_shapes<NB>(M, K, w.n)) return cudaErrorInvalidValue;
  bool vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  for (int b = 0; b < NB; ++b)
    vec = vec && w.n[b] % 8 == 0 &&
          reinterpret_cast<uintptr_t>(w.w[b]) % 16 == 0;
  if (M <= 16)
    return vec ? launch_mma<NB, 16, 32, 128, true>(a, w, M, K, epi, stream)
               : launch_mma<NB, 16, 32, 128, false>(a, w, M, K, epi, stream);
  return vec ? launch_mma<NB, 64, 32, 64, true>(a, w, M, K, epi, stream)
             : launch_mma<NB, 64, 32, 64, false>(a, w, M, K, epi, stream);
}

}  // namespace
