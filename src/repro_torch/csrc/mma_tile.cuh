// The main loop shared by the port's float matmul kernels (tiled_matmul,
// ffn1, ffn1_gated, qkv_proj): NB products A[M,K] @ W[b][K, n[b]] that
// share one staged A tile, float32 accumulation, and an epilogue that sees
// the NB accumulators of each output element at once.
//
// A CTA owns one BM x BN output tile over one range of K (the TPU's
// sequential K grid axis becomes a loop inside the block; blocks run in
// parallel and carry nothing between them).  A CTA whose first column lies
// at or past n[b] neither loads W[b] nor multiplies it (qkv_proj's narrower
// GQA K/V: the Pallas kernel's `j < nkv_blocks` guard).  The epilogue is
// called for rows < M and columns < n[0] (n[0] is the widest) and masks
// narrower outputs itself.  Nothing is padded in device memory.
//  * bf16 (mma_tile): tensor cores through mma.sync m16n8k16 (bf16 in, f32
//    accumulate).  The bound at the serving shapes is the weight bytes
//    (M <= 128 rows against a 2-6 MB weight), so the loop keeps bytes in
//    flight and the card full:
//    - a ring of 3-4 stages in dynamic shared memory, filled by 16-byte
//      cp.async (ragged edges zero-filled in the copy, src-size 0) through
//      copy pointers each thread sets once, so that 2-3 K steps of A and of
//      every live W[b] are in flight while one is multiplied; a step is 64
//      deep (128 rows) or 128 (decode), 4-8 slices of 16 per barrier;
//    - fragments by ldmatrix (A, [M, K] row-major) and ldmatrix.trans (W,
//      [K, N] row-major), from rows padded by 16 bytes (no bank conflicts);
//    - BM covers M (16 for a decode step, 128 for a mixed step), so every
//      weight byte crosses HBM once; BN is 64, or 32 where 64 leaves less
//      than about one wave of CTAs (matmul_bf16);
//    - a deterministic K split: `splits` ranges of whole 16-wide slices,
//      a number the caller takes from M and K alone (k_splits in
//      kernels/tiled_matmul.py), grid z.  Each range sums its slices in
//      order 0, 16, 32, ... (a step's slices past the range are zero-filled
//      and add exact zeros) and writes its f32 partial sums to a workspace
//      the wrapper allocates; mma_reduce, launched as a programmatic
//      dependent so its launch overlaps the loop's tail, adds the ranges in
//      order 0..S-1 and calls the epilogue on the full sum (bias,
//      activation and gate never see a partial).  No atomics.  The result
//      depends on M, K and the inputs only, not on BM/BN/BK nor on NB: a
//      product computed beside others equals the same product computed
//      alone, bit for bit.
//    Where K or some n[b] is not a multiple of 8, or a pointer is not
//    16-byte aligned (never on the serving path), the ring is filled by
//    element loads through registers instead.
//  * f32 (fma_tile): plain FMA in f32 (tensor cores would round the inputs
//    to TF32); every thread adds the K terms of its outputs in order
//    0..K-1, so the result does not depend on the tiles or on NB either.
//    One stage in shared memory, the next fetched into registers while it
//    is multiplied; small M (decode) takes narrow tiles so more CTAs stream
//    the weights.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "dtype.cuh"
#include "launch.cuh"
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

// The bf16 tile shapes.  BM 16 (M <= 16): BN / 16 warps side by side, each
// 16 rows x 16 columns, K in steps of 128.  BM 128: 8 warps, 4 down x 2
// across, each 32 rows x BN / 2 columns, K in steps of 64.  Each step of
// the ring is one barrier, so it holds 4-8 slices of 16; the ring has 4
// stages where they fit in one CTA's shared memory, else 3 (qkv_proj's
// three weights at BM 16, BN 64).
constexpr int kMaxSmem = 227 * 1024;   // dynamic shared memory of a CTA

template <int NB, int BM, int BN>
struct MmaShape {
  static constexpr int kWarpsM = BM == 16 ? 1 : 4;
  static constexpr int kWarpsN = BM == 16 ? BN / 16 : 2;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int BK = BM == 16 ? 128 : 64;
  static constexpr int PA = BK + 8;        // padded row of A (bf16 elements)
  static constexpr int PB = BN + 8;        // padded row of a W slice
  static constexpr int kAElems = BM * PA;  // A's part of one stage
  static constexpr int kStageElems = kAElems + NB * BK * PB;
  static constexpr int kStageBytes = kStageElems * 2;
  static constexpr int kStages = 4 * kStageBytes <= kMaxSmem ? 4 : 3;
  static constexpr int kSmemBytes = kStages * kStageBytes;
};

// Offset of W[b]'s partial sums inside one range's part of the workspace
// ([M, n[b]] row-major, b in order); b = NB gives the part's size.
__host__ __device__ inline size_t part_offset(const int* n, int b, int M) {
  size_t off = 0;
  for (int i = 0; i < b; ++i) off += n[i];
  return off * M;
}

// VEC: operands are staged with 16-byte cp.async of 8 bf16 (needs K and
// every n[b] to be multiples of 8 and 16-byte aligned pointers); otherwise
// one element per load, through registers, which also takes ragged K and N.
template <int NB, int BM, int BN, bool VEC, class Epi>
__global__ void __launch_bounds__(MmaShape<NB, BM, BN>::kThreads)
    mma_tile(const __nv_bfloat16* __restrict__ A,
             const Weights<NB, __nv_bfloat16> W, int M, int K, int splits,
             float* __restrict__ ws, const Epi epi) {
  using S = MmaShape<NB, BM, BN>;
  constexpr int NTHR = S::kThreads, BK = S::BK, PA = S::PA, PB = S::PB;
  constexpr int NS = S::kStages;
  constexpr int WM = BM / S::kWarpsM, WN = BN / S::kWarpsN;
  constexpr int MT = WM / 16, NT = WN / 8;    // m16 and n8 tiles per warp
  // 16-byte chunks of a stage: a thread copies AIT of A, each RA rows
  // apart in one column, and BIT of each W[b], RB rows apart
  constexpr int ACH = BM * BK / 8, BCH = BK * BN / 8;
  constexpr int AIT = ACH / NTHR, BIT = BCH / NTHR;
  constexpr int RA = NTHR / (BK / 8), RB = NTHR / (BN / 8);
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "mma tiles");
  static_assert(ACH % NTHR == 0 && BCH % NTHR == 0 && NTHR % (BK / 8) == 0 &&
                    NTHR % (BN / 8) == 0,
                "chunks per thread");

  // let mma_reduce, launched after this grid, be scheduled early: it waits
  // for this grid's completion itself
  pdl_launch_dependents();

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // this CTA's K range [lo, hi): whole 16-wide slices, the ranges of
  // k_ranges in kernels/tiled_matmul.py (32-bit: matmul_bf16 checks that
  // splits * slices fits)
  const int slices = (K + 15) / 16, z = blockIdx.z;
  const int lo = z * slices / splits * 16;
  const int hi = min(K, (z + 1) * slices / splits * 16);
  bool live[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) live[b] = b == 0 || n0 < W.n[b];

  float acc[NB][MT][NT][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][i][j][e] = 0.f;

  // this thread's chunks: first row and column in a stage, the sources at
  // K = lo (advanced by j * BK columns of A or rows of W for K step j)
  const int ar = tid / (BK / 8), ac = tid % (BK / 8) * 8;
  const int br = tid / (BN / 8), bc = tid % (BN / 8) * 8;
  const __nv_bfloat16* a_src = A + (size_t)min(m0 + ar, M - 1) * K + lo + ac;
  const __nv_bfloat16* w_src[NB];
  bool w_col[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    w_col[b] = n0 + bc < W.n[b];
    w_src[b] = W.w[b] + (size_t)min(lo + br, K - 1) * W.n[b] +
               (w_col[b] ? n0 + bc : 0);
  }

  // K step j of the range [lo, hi), BK deep, of A and of every live W[b]
  // into stage `buf`; rows past M, columns past n[b] and K past hi are
  // zero-filled
  auto stage = [&](int buf, int j) {
    __nv_bfloat16* As = ring + buf * S::kStageElems;
    const int k0 = lo + j * BK;
    if constexpr (VEC) {
      const bool kin = k0 + ac < hi;
#pragma unroll
      for (int i = 0; i < AIT; ++i) {
        const bool in = kin && m0 + ar + i * RA < M;
        cp_async16(As + (ar + i * RA) * PA + ac,
                   in ? a_src + (size_t)i * RA * K + j * BK : A, in ? 16 : 0);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (!live[b]) continue;
        __nv_bfloat16* Bs = As + S::kAElems + b * BK * PB;
        const size_t N = W.n[b];
#pragma unroll
        for (int i = 0; i < BIT; ++i) {
          const bool in = w_col[b] && k0 + br + i * RB < hi;
          cp_async16(Bs + (br + i * RB) * PB + bc,
                     in ? w_src[b] + ((size_t)j * BK + i * RB) * N : W.w[b],
                     in ? 16 : 0);
        }
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int i = tid; i < BM * BK; i += NTHR) {
        const int r = i / BK, c = i % BK;
        const int gm = m0 + r, gk = k0 + c;
        As[r * PA + c] = gm < M && gk < hi ? A[(size_t)gm * K + gk] : zero;
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (!live[b]) continue;
        __nv_bfloat16* Bs = As + S::kAElems + b * BK * PB;
        const int N = W.n[b];
        for (int i = tid; i < BK * BN; i += NTHR) {
          const int r = i / BN, c = i % BN;
          const int gk = k0 + r, gn = n0 + c;
          Bs[r * PB + c] =
              gk < hi && gn < N ? W.w[b][(size_t)gk * N + gn] : zero;
        }
      }
    }
  };

  // One loop issues K step j and multiplies step c = j - (NS - 1): its
  // first NS - 1 turns fill the ring, and the copies have one call site.
  // Every slice of a step is multiplied, also those past hi: they are
  // zero-filled, so they add exact zeros, and the slices of the range are
  // summed in order whatever BK is.
  const int n_k = (hi - lo + BK - 1) / BK;
  for (int j = 0; j < n_k + NS - 1; ++j) {
    const int c = j - (NS - 1);
    if (c >= 0) {
      cp_async_wait<NS - 2>();   // step c has landed (this thread's copies)
      __syncthreads();           // ... everyone's; step c - 1 is consumed
    }
    if (j < n_k) stage(j % NS, j);
    cp_async_commit();
    if (c < 0) continue;
    const __nv_bfloat16* As = ring + c % NS * S::kStageElems;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], As + (wm * WM + mt * 16 + (lane & 15)) * PA +
                                ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (!live[b]) continue;
        const __nv_bfloat16* Bs = As + S::kAElems + b * BK * PB;
        uint32_t bf[NT][2];
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, Bs + (ks * 16 + (lane & 15)) * PB + wn * WN +
                                   np * 16 + (lane >> 4) * 8);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[b][mt][nt], af[mt], bf[nt]);
      }
    }
  }

  // one range: the epilogue on the sums; a split: the partial sums of this
  // range to its part of the workspace, for mma_reduce
  const size_t part = part_offset(W.n, NB, M) * blockIdx.z;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = n0 + wn * WN + nt * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {     // rows r and r + 8
        const int gr = m0 + wm * WM + mt * 16 + (lane >> 2) + h * 8;
        if (gr >= M) continue;
        if (splits == 1) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (c + e >= W.n[0]) continue;
            float v[NB];
#pragma unroll
            for (int b = 0; b < NB; ++b) v[b] = acc[b][mt][nt][h * 2 + e];
            epi(gr, c + e, v);
          }
          continue;
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int N = W.n[b];
          if (c >= N) continue;
          float* p = ws + part + part_offset(W.n, b, M) + (size_t)gr * N + c;
          if constexpr (VEC) {    // N even: both columns in range, aligned
            *reinterpret_cast<float2*>(p) =
                make_float2(acc[b][mt][nt][h * 2], acc[b][mt][nt][h * 2 + 1]);
          } else {
            p[0] = acc[b][mt][nt][h * 2];
            if (c + 1 < N) p[1] = acc[b][mt][nt][h * 2 + 1];
          }
        }
      }
    }
  }
}

// The ranges' partial sums added in order 0..splits-1, then the epilogue:
// one thread per CPT output columns (c < n[0], every n[b] a multiple of
// CPT); v[b] = 0 where c >= n[b].  Launched as a programmatic dependent of
// mma_tile: it waits here until that grid has finished and its writes are
// visible.
template <int NB, int CPT, class Epi>
__global__ void __launch_bounds__(256)
    mma_reduce(const float* __restrict__ ws,
               const Weights<NB, __nv_bfloat16> W, int M, int splits,
               const Epi epi) {
  pdl_wait();
  // (32-bit: the host checks that M * n[0] fits)
  const int groups = W.n[0] / CPT;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * groups) return;
  const int r = idx / groups, c = idx % groups * CPT;
  const size_t stride = part_offset(W.n, NB, M);
  float v[NB][CPT];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int e = 0; e < CPT; ++e) v[b][e] = 0.f;
    if (c >= W.n[b]) continue;
    const float* p =
        ws + part_offset(W.n, b, M) + (size_t)r * W.n[b] + c;
    if constexpr (CPT == 4) {
      float4 sum = *reinterpret_cast<const float4*>(p);
      for (int s = 1; s < splits; ++s) {
        const float4 t = *reinterpret_cast<const float4*>(p + s * stride);
        sum.x += t.x;
        sum.y += t.y;
        sum.z += t.z;
        sum.w += t.w;
      }
      v[b][0] = sum.x;
      v[b][1] = sum.y;
      v[b][2] = sum.z;
      v[b][3] = sum.w;
    } else {
      float sum = p[0];
      for (int s = 1; s < splits; ++s) sum += p[s * stride];
      v[b][0] = sum;
    }
  }
#pragma unroll
  for (int e = 0; e < CPT; ++e) {
    float u[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) u[b] = v[b][e];
    epi(r, c + e, u);
  }
}

template <int NB, int BM, int BN, int BK, int TM, int TN, class Epi>
cudaError_t launch_fma(const float* a, const Weights<NB, float>& w, int M,
                       int K, const Epi& epi, cudaStream_t stream,
                       int* plan) {
  dim3 grid((w.n[0] + BN - 1) / BN, (M + BM - 1) / BM);
  if (plan != nullptr) {
    plan[0] = grid.x * grid.y;
    plan[1] = 1;
    plan[2] = 0;
  }
  dim3 block((BM / TM) * (BN / TN));
  fma_tile<NB, BM, BN, BK, TM, TN, Epi><<<grid, block, 0, stream>>>(
      a, w, M, K, epi);
  return cudaGetLastError();
}

template <int NB>
bool valid_shapes(int M, int K, const int* n) {
  if (M <= 0 || K <= 0) return false;
  for (int b = 0; b < NB; ++b)
    if (n[b] <= 0 || n[b] > n[0]) return false;
  return true;
}

// f32 operands and accumulators, FMA, one K range; the tiles depend on M
// only.  plan as for matmul_bf16 (static shared memory: 0 dynamic bytes).
template <int NB, class Epi>
cudaError_t matmul_f32(const float* a, const Weights<NB, float>& w, int M,
                       int K, const Epi& epi, cudaStream_t stream,
                       int* plan = nullptr) {
  if (!valid_shapes<NB>(M, K, w.n)) return cudaErrorInvalidValue;
  if (M <= 16)
    return launch_fma<NB, 16, 32, 64, 1, 2>(a, w, M, K, epi, stream, plan);
  return launch_fma<NB, 64, 64, 32, 4, 4>(a, w, M, K, epi, stream, plan);
}

template <int NB, int BM, int BN, bool VEC, class Epi>
cudaError_t launch_mma(const __nv_bfloat16* a,
                       const Weights<NB, __nv_bfloat16>& w, int M, int K,
                       int splits, float* ws, const Epi& epi,
                       cudaStream_t stream, int* plan) {
  using S = MmaShape<NB, BM, BN>;
  const dim3 grid((w.n[0] + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (plan != nullptr) {
    plan[0] = grid.x * grid.y;
    plan[1] = splits;
    plan[2] = S::kSmemBytes;
  }
  auto kern = mma_tile<NB, BM, BN, VEC, Epi>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t e = allow_dynamic_smem(reinterpret_cast<const void*>(kern),
                                     S::kSmemBytes, smem_set);
  if (e != cudaSuccess) return e;
  kern<<<grid, S::kThreads, S::kSmemBytes, stream>>>(a, w, M, K, splits, ws,
                                                     epi);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  // the reduce as a programmatic dependent launch: its CTAs are scheduled
  // while mma_tile's last CTAs run, and wait for the grid to finish
  constexpr int CPT = VEC ? 4 : 1;
  const size_t n = (size_t)M * (w.n[0] / CPT);
  return launch_dependent(mma_reduce<NB, CPT, Epi>,
                          dim3((unsigned)((n + 255) / 256)), dim3(256), stream,
                          static_cast<const float*>(ws), w, M, splits, epi);
}

// Where a 64-column tile gives fewer CTAs than this, the tile is 32 wide:
// about one wave of the H100's 132 SMs.
constexpr long long kWaveCtas = 128;

// bf16 operands, f32 accumulators, mma.sync.  The caller gives the number
// of K ranges (from M and K alone) and, for splits > 1, a workspace of
// splits * M * sum(n[b]) floats.  The tiles depend on M and n[0] (and the
// load width on K, the n[b] and the pointers' alignment), never the sums.
// plan, where given, receives the launch: output tiles, K ranges, dynamic
// shared memory bytes.
template <int NB, class Epi>
cudaError_t matmul_bf16(const __nv_bfloat16* a,
                        const Weights<NB, __nv_bfloat16>& w, int M, int K,
                        int splits, float* ws, const Epi& epi,
                        cudaStream_t stream, int* plan = nullptr) {
  const long long slices = (K + 15) / 16;
  if (!valid_shapes<NB>(M, K, w.n) || splits < 1 || splits > slices ||
      splits > 65535 || (splits > 1 && ws == nullptr) ||
      slices * (splits + 1) > INT32_MAX || (long long)M * w.n[0] > INT32_MAX)
    return cudaErrorInvalidValue;
  bool vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  for (int b = 0; b < NB; ++b)
    vec = vec && w.n[b] % 8 == 0 &&
          reinterpret_cast<uintptr_t>(w.w[b]) % 16 == 0;
  const bool small = M <= 16;
  const long long ctas64 = (long long)((w.n[0] + 63) / 64) *
                           ((M + (small ? 15 : 127)) / (small ? 16 : 128)) *
                           splits;
  const bool wide = vec && ctas64 >= kWaveCtas;
#define REPRO_MMA(BM, BN, V) \
  launch_mma<NB, BM, BN, V>(a, w, M, K, splits, ws, epi, stream, plan)
  if (small)
    return !vec ? REPRO_MMA(16, 32, false)
                : wide ? REPRO_MMA(16, 64, true) : REPRO_MMA(16, 32, true);
  return !vec ? REPRO_MMA(128, 32, false)
              : wide ? REPRO_MMA(128, 64, true) : REPRO_MMA(128, 32, true);
#undef REPRO_MMA
}

}  // namespace
