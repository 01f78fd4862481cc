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
// Design: one CTA owns one BM x BN output tile and loops over K itself (the
// TPU's sequential grid axis becomes a loop inside the block; blocks run in
// parallel and carry nothing between them).  Each K step stages a BK-deep
// slice of A and B in shared memory; the next slice is fetched into
// registers while the current one is multiplied, so global loads are in
// flight during the math (16-byte loads of 8 bf16 where K and N are
// multiples of 8, one element per load otherwise).  Ragged edges are masked at the loads (zero fill)
// and at the store; nothing is padded in device memory.  Small M (decode)
// takes narrow tiles so more CTAs stream the weight.
//  * bf16: tensor cores through mma.sync m16n8k16 (bf16 in, f32
//    accumulate).  Each warp owns BN/4 columns of the tile; the K terms are
//    added in 16-wide slices in order 0, 16, 32, ..., so the result does not
//    depend on BM/BN/BK (BK is a multiple of 16).
//  * f32: plain FMA in f32 (tensor cores would round the inputs to TF32);
//    every thread adds the K terms of its outputs in order 0..K-1, so the
//    result does not depend on BM/BN/BK either.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "dtype.cuh"

namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    tiled_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                        T* __restrict__ C, int M, int K, int N) {
  constexpr int TCOLS = BN / TN;            // threads across the tile's columns
  constexpr int TROWS = BM / TM;            // threads across the tile's rows
  constexpr int NT = TCOLS * TROWS;
  constexpr int A_PER = (BM * BK) / NT;     // A elements each thread stages
  constexpr int B_PER = (BK * BN) / NT;
  static_assert((BM * BK) % NT == 0 && (BK * BN) % NT == 0, "tile split");

  __shared__ float As[BK][BM];              // k-major: a k step reads a row
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tcol = tid % TCOLS;
  const int trow = tid / TCOLS;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float a_reg[A_PER], b_reg[B_PER];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * NT;
      const int r = idx / BK, c = idx % BK;  // consecutive threads: along K
      const int gm = m0 + r, gk = k0 + c;
      a_reg[i] = (gm < M && gk < K) ? to_f(A[(size_t)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * NT;
      const int r = idx / BN, c = idx % BN;  // consecutive threads: along N
      const int gk = k0 + r, gn = n0 + c;
      b_reg[i] = (gk < K && gn < N) ? to_f(B[(size_t)gk * N + gn]) : 0.f;
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
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * NT;
      Bs[idx / BN][idx % BN] = b_reg[i];
    }
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);       // next slice in flight meanwhile
    const int kmax = min(BK, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][trow + i * TROWS];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tcol + j * TCOLS];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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
      if (gn < N) C[(size_t)gm * N + gn] = from_f<T>(acc[i][j]);
    }
  }
}


// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Pack two bf16 values (lower address in the low half) into one register.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// VEC: operands are staged with 16-byte loads of 8 bf16 (needs K and N to
// be multiples of 8 and 16-byte aligned pointers); otherwise one element
// per load, which also takes ragged K and N.
template <int BM, int BN, int BK, bool VEC>
__global__ void __launch_bounds__(128)
    tiled_matmul_mma(const __nv_bfloat16* __restrict__ A,
                     const __nv_bfloat16* __restrict__ B,
                     __nv_bfloat16* __restrict__ C, int M, int K, int N) {
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

  __shared__ __align__(16) __nv_bfloat16 As[BM * PA];   // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[BK * PB];   // [k][n]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  L zero;
  if constexpr (VEC) zero = make_uint4(0, 0, 0, 0);
  else zero = __float2bfloat16(0.f);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  L a_reg[A_PER], b_reg[B_PER];
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
    for (int i = 0; i < B_PER; ++i) {
      const int idx = (tid + i * NTHR) * E;  // consecutive threads: along N
      const int gk = k0 + idx / BN, gn = n0 + idx % BN;
      b_reg[i] = (gk < K && gn < N)
                     ? *reinterpret_cast<const L*>(B + (size_t)gk * N + gn)
                     : zero;
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
    for (int i = 0; i < B_PER; ++i) {
      const int idx = (tid + i * NTHR) * E;
      *reinterpret_cast<L*>(&Bs[(idx / BN) * PB + idx % BN]) = b_reg[i];
    }
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);       // next slice in flight meanwhile
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int kb = ks * 16 + (lane & 3) * 2;
      uint32_t af[MT][4], bf[NT][2];
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
      for (int nt = 0; nt < NT; ++nt) {
        const int n = warp * WN + nt * 8 + (lane >> 2);
        bf[nt][0] = pack2(Bs[kb * PB + n], Bs[(kb + 1) * PB + n]);
        bf[nt][1] = pack2(Bs[(kb + 8) * PB + n], Bs[(kb + 9) * PB + n]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
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
        if (gr < M && gc < N)
          C[(size_t)gr * N + gc] = __float2bfloat16(acc[mt][nt][e]);
      }
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
cudaError_t launch(const void* a, const void* b, void* c, int M, int K, int N,
                   cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dim3 block((BM / TM) * (BN / TN));
  tiled_matmul_kernel<T, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, K, N);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, bool VEC>
cudaError_t launch_mma(const void* a, const void* b, void* c, int M, int K,
                       int N, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  tiled_matmul_mma<BM, BN, BK, VEC><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(c), M, K, N);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* a, const void* b, void* c, int M, int K,
                         int N, cudaStream_t stream) {
  if (M <= 16) return launch<float, 16, 32, 64, 1, 2>(a, b, c, M, K, N, stream);
  return launch<float, 64, 64, 32, 4, 4>(a, b, c, M, K, N, stream);
}

template <bool VEC>
cudaError_t dispatch_bf16(const void* a, const void* b, void* c, int M, int K,
                          int N, cudaStream_t stream) {
  if (M <= 16) return launch_mma<16, 32, 128, VEC>(a, b, c, M, K, N, stream);
  return launch_mma<64, 32, 64, VEC>(a, b, c, M, K, N, stream);
}

bool vector_ok(const void* a, const void* b, int K, int N) {
  return K % 8 == 0 && N % 8 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (A, B and C share it).
extern "C" int tiled_matmul(const void* a, const void* b, void* c, int M,
                            int K, int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_f32(a, b, c, M, K, N, s);
  if (dtype == 1)
    return vector_ok(a, b, K, N) ? dispatch_bf16<true>(a, b, c, M, K, N, s)
                                 : dispatch_bf16<false>(a, b, c, M, K, N, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
