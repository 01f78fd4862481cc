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
// bf16 tiled_matmul.  What it does about that:
//  * a ring of 4 stages in dynamic shared memory, each 256 deep in K, filled
//    by 16-byte cp.async copies of X [BM][256] and of W [256][BN] in W's own
//    [K, N] layout (ragged edges zero-filled in the copy, src-size 0), from
//    copy pointers each thread sets once: 3 stages are in flight while one
//    is multiplied;
//  * many small CTAs: a CTA fills its ring at a bounded rate (a deeper ring
//    did not raise it on the H100), so the time of a call follows the
//    bytes one CTA copies.  BM is 16 rows for M <= 16 (a decode
//    step) and 32 otherwise (a mixed step's 128 rows take 4 row tiles: a
//    weight tile is read once from HBM and again from L2, while X, which
//    every column tile copies, shrinks 4x per CTA); BN is 64 where that
//    still gives about a wave of CTAs, else 32 (int8_plan in
//    kernels/int8_matmul.py);
//  * an exact K split for products with few column tiles: `splits` ranges
//    of whole 32-deep slices (grid z), each range's int32 partial sums to a
//    workspace the wrapper allocates, and int8_reduce, a programmatic
//    dependent launch, adds them and applies the epilogue.  The serving
//    shapes measure fastest at one range.  Integer sums are exact in any
//    order, so neither the split, the tiles nor the warps' shares change a
//    bit of the result.
// Tensor cores take the product through mma.sync m16n8k32 (s8 x s8 -> s32).
// Its A fragments come from X by ldmatrix (rows padded by 16 bytes).  Its B
// operand is "col": one register holds 4 consecutive k of one column, while
// W is [K, N] row-major and ldmatrix's .trans exists only for 16-bit
// elements.  So a lane reads 4 words (4 k-rows x 4 columns) and transposes
// them in registers with 8 byte permutes (prmt): register j is the B
// fragment of a virtual n8 tile whose column g is the physical column
// 4g + j, so 4 tiles cover the warp's 32 columns, and each fragment serves
// every m16 tile of the CTA.  The accumulator of tile j, column 2t + e, is
// then the physical column 8t + 4e + j: a thread holds 8 consecutive
// columns, stored as one 16-byte (bf16) or two (f32) vectors.  W's stage
// rows are not padded (16-byte copies need aligned rows); the 16-byte
// chunks are XOR-swizzled by the row instead (w_off), so that the 4 rows x
// 8 words of a warp's read fall in 32 banks.  Where K or N is not a
// multiple of 16 or a pointer not 16-byte aligned (never on the serving
// path), the ring is filled by element loads instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "dtype.cuh"
#include "launch.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kBK = 256;        // K of one ring stage
constexpr int kSlice = 32;      // K of one mma.sync m16n8k32
constexpr int kStages = 4;

// D = A(16x32 s8, row) * B(32x8 s8, col) + D, int32 accumulate.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp owns all BM rows and 32 columns of the CTA's tile (BN / 32 warps
// side by side) and every kWarpsK-th 32-deep slice of each stage; at the
// end the warps of one column group add their sums in shared memory.
template <int BM, int BN>
struct I8Shape {
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kWarpsK = 4 / kWarpsN;
  static constexpr int MT = BM / 16;           // m16 tiles of a warp
  static constexpr int PA = kBK + 16;          // padded X row (bytes)
  static constexpr int kXBytes = BM * PA;      // X's part of one stage
  static constexpr int kStageBytes = kXBytes + kBK * BN;
  static constexpr int kSmemBytes = kStages * kStageBytes;
  // the partial sums of warps 1.. of each column group, after the loop
  static constexpr int kRedBytes = (kWarpsK - 1) * kWarpsN * MT * 16 * 32 * 4;
  static_assert(kWarpsN * kWarpsK == 4 && kRedBytes <= kSmemBytes, "warps");
};

struct Args {
  const int8_t* x;   // [M, K]
  const int8_t* w;   // [K, N] row-major
  const float* sx;   // one device scalar
  const float* sw;   // [N]
  void* c;           // [M, N] out dtype
  int* ws;           // [splits, M, N] int32 partial sums (splits > 1)
  int M, K, N, splits;
};

// Byte offset of the 16-byte chunk c of row k in a stage's [256][BN] W
// slice: the chunk index of the row-major layout XOR-ed with 2 * (k / 4 % 4)
// (a permutation inside each group of 4 rows).  A fragment read takes rows
// 4t + r (t = 0..3, r fixed) x 2 adjacent chunks: the XOR gives the 4 rows
// 4 different pairs of the 8 chunk slots of a 128-byte bank line.
template <int BN>
__device__ __forceinline__ int w_off(int k, int c) {
  return ((k * (BN / 16) + c) ^ (((k >> 2) & 3) << 1)) * 16;
}

// w[r]: bytes j = 0..3 are columns j of k-row r; out[j]: bytes r = 0..3 are
// k-rows r of column j.
__device__ __forceinline__ void transpose4x4(const uint32_t* w, uint32_t* out) {
  const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140);  // w0.0 w1.0 w0.1 w1.1
  const uint32_t x1 = __byte_perm(w[0], w[1], 0x7362);  // w0.2 w1.2 w0.3 w1.3
  const uint32_t x2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t x3 = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(x0, x2, 0x5410);
  out[1] = __byte_perm(x0, x2, 0x7632);
  out[2] = __byte_perm(x1, x3, 0x5410);
  out[3] = __byte_perm(x1, x3, 0x7632);
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  u.x = pack2(__float2bfloat16(v[0]), __float2bfloat16(v[1]));
  u.y = pack2(__float2bfloat16(v[2]), __float2bfloat16(v[3]));
  u.z = pack2(__float2bfloat16(v[4]), __float2bfloat16(v[5]));
  u.w = pack2(__float2bfloat16(v[6]), __float2bfloat16(v[7]));
  *reinterpret_cast<uint4*>(p) = u;
}

// VEC: 16-byte cp.async copies (K and N multiples of 16, X and W 16-byte
// aligned); otherwise element loads through registers, which take any K, N
// and alignment.
template <typename TO, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(kThreads) int8_mma(const Args a) {
  using S = I8Shape<BM, BN>;
  constexpr int MT = S::MT, PA = S::PA, KW = S::kWarpsK, NS = kStages;
  // 16-byte chunks of a stage: a thread copies XIT of X, each RX rows apart
  // in one column, and WIT of W, RW rows apart
  constexpr int XCPR = kBK / 16, WCPR = BN / 16;   // chunks per row
  constexpr int XIT = BM * XCPR / kThreads, WIT = kBK * WCPR / kThreads;
  constexpr int RX = kThreads / XCPR, RW = kThreads / WCPR;
  static_assert(XIT * kThreads == BM * XCPR && WIT * kThreads == kBK * WCPR,
                "chunks per thread");
  static_assert(kBK % (kSlice * KW) == 0, "slices per warp");

  // let int8_reduce, launched after this grid, be scheduled early
  pdl_launch_dependents();

  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % S::kWarpsN, wk = warp / S::kWarpsN;
  const int g = lane >> 2, t = lane & 3;
  const int M = a.M, K = a.K, N = a.N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // this CTA's K range [lo, hi): whole 32-deep slices, the ranges of
  // int8_k_ranges in kernels/int8_matmul.py (32-bit: the host checks that
  // splits * slices fits)
  const int slices = (K + kSlice - 1) / kSlice, z = blockIdx.z;
  const int lo = z * slices / a.splits * kSlice;
  const int hi = min(K, (z + 1) * slices / a.splits * kSlice);

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // this thread's chunks: first row and column in a stage, the sources at
  // K = lo (advanced by j * 256 columns of X or rows of W for K step j)
  const int xr = tid / XCPR, xc = tid % XCPR * 16;
  const int wr = tid / WCPR, wc = tid % WCPR;
  const int8_t* x_src = a.x + (size_t)min(m0 + xr, M - 1) * K + lo + xc;
  const bool w_col = n0 + wc * 16 < N;
  const int8_t* w_src =
      a.w + (size_t)min(lo + wr, K - 1) * N + (w_col ? n0 + wc * 16 : 0);

  // K step j of the range, 256 deep, of X and W into stage `buf`; rows past
  // M, columns past N and K past hi are zero-filled
  auto stage = [&](int buf, int j) {
    unsigned char* Xs = smem + buf * S::kStageBytes;
    unsigned char* Ws = Xs + S::kXBytes;
    const int k0 = lo + j * kBK;
    if constexpr (VEC) {
      const bool kin = k0 + xc < hi;
#pragma unroll
      for (int i = 0; i < XIT; ++i) {
        const bool in = kin && m0 + xr + i * RX < M;
        cp_async16(Xs + (xr + i * RX) * PA + xc,
                   in ? x_src + (size_t)i * RX * K + j * kBK : a.x,
                   in ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < WIT; ++i) {
        const bool in = w_col && k0 + wr + i * RW < hi;
        cp_async16(Ws + w_off<BN>(wr + i * RW, wc),
                   in ? w_src + ((size_t)j * kBK + i * RW) * N : a.w,
                   in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BM * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        const int gm = m0 + r, gk = k0 + c;
        Xs[r * PA + c] = gm < M && gk < hi ? a.x[(size_t)gm * K + gk] : 0;
      }
      for (int i = tid; i < kBK * BN; i += kThreads) {
        const int r = i / BN, c = i % BN;
        const int gk = k0 + r, gn = n0 + c;
        Ws[w_off<BN>(r, c >> 4) + (c & 15)] =
            gk < hi && gn < N ? a.w[(size_t)gk * N + gn] : 0;
      }
    }
  };

  // One loop issues K step j and multiplies step c = j - (NS - 1): its
  // first turns fill the ring, and the copies have one call site.
  const int n_k = (hi - lo + kBK - 1) / kBK;
  for (int j = 0; j < n_k + NS - 1; ++j) {
    const int c = j - (NS - 1);
    if (c >= 0) {
      cp_async_wait<NS - 2>();   // step c has landed (this thread's)
      __syncthreads();           // ... everyone's; step c - 1 is consumed
    }
    if (j < n_k) stage(j % NS, j);
    cp_async_commit();
    if (c < 0) continue;
    const unsigned char* Xs = smem + c % NS * S::kStageBytes;
    const unsigned char* Ws = Xs + S::kXBytes;
    const int kc = lo + c * kBK;
#pragma unroll
    for (int s = 0; s < kBK / kSlice / KW; ++s) {
      const int ks = s * KW + wk;
      // slices past the range are zero-filled: they would add nothing
      if (kc + ks * kSlice >= hi) break;
      // B: k-rows 4t..4t+3 (h = 0) and 16+4t.. (h = 1) of the warp's word g
      uint32_t bf[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w4[4], col[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w4[r] = *reinterpret_cast<const uint32_t*>(
              Ws + w_off<BN>(ks * kSlice + h * 16 + 4 * t + r,
                             wn * 2 + (g >> 2)) +
              (g & 3) * 4);
        transpose4x4(w4, col);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bf[jj][h] = col[jj];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ldmatrix_x4(af, Xs + (mt * 16 + (lane & 15)) * PA + ks * kSlice +
                            (lane >> 4) * 16);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) mma_s8(acc[mt][jj], af, bf[jj]);
      }
    }
  }

  if constexpr (KW > 1) {
    // the warps of a column group add their sums: warps 1.. through the
    // ring (free once every copy has landed and every step is consumed)
    cp_async_wait<0>();
    __syncthreads();
    constexpr int PER = MT * 16;     // values per lane
    int* red = reinterpret_cast<int*>(smem);
    if (wk > 0) {
      int* p = red + ((wk - 1) * S::kWarpsN + wn) * PER * 32 + lane;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[((i * 4 + j) * 4 + e) * 32] = acc[i][j][e];
    }
    __syncthreads();
    if (wk > 0) return;
#pragma unroll
    for (int q = 1; q < KW; ++q) {
      const int* p = red + ((q - 1) * S::kWarpsN + wn) * PER * 32 + lane;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] += p[((i * 4 + j) * 4 + e) * 32];
    }
  }

  // a thread's 8 consecutive columns col0 + 4e + j (tile j, column 2t + e)
  // of rows g and g + 8 of each m16 tile
  const int col0 = n0 + wn * 32 + 8 * t;
  if (a.splits == 1) {
    const float sxv = *a.sx;
    float scale[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      scale[q] = col0 + q < N ? sxv * a.sw[col0 + q] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mt * 16 + g + 8 * h;
        if (row >= M) continue;
        float v[8];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[4 * e + j] =
                static_cast<float>(acc[mt][j][2 * h + e]) * scale[4 * e + j];
        TO* out = static_cast<TO*>(a.c) + (size_t)row * N + col0;
        if constexpr (VEC) {      // N % 16 == 0: all 8 in range, aligned
          if (col0 < N) store8(out, v);
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (col0 + q < N) out[q] = from_f<TO>(v[q]);
        }
      }
    }
    return;
  }
  // a split: this range's partial sums to its part of the workspace
  int* ws = a.ws + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + mt * 16 + g + 8 * h;
      if (row >= M) continue;
      int v[8];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[4 * e + j] = acc[mt][j][2 * h + e];
      int* out = ws + (size_t)row * N + col0;
      if constexpr (VEC) {
        if (col0 < N) {
          reinterpret_cast<int4*>(out)[0] = make_int4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<int4*>(out)[1] = make_int4(v[4], v[5], v[6], v[7]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (col0 + q < N) out[q] = v[q];
      }
    }
  }
}

// The ranges' int32 partial sums added (exact in any order), then the
// epilogue: one thread per CPT output columns (N a multiple of CPT).
// Launched as a programmatic dependent of int8_mma.
template <typename TO, int CPT>
__global__ void __launch_bounds__(256) int8_reduce(const Args a) {
  pdl_wait();
  // (32-bit: the host checks that M * N fits)
  const int groups = a.N / CPT;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.M * groups) return;
  const int r = idx / groups, c = idx % groups * CPT;
  const size_t stride = (size_t)a.M * a.N;
  const int* p = a.ws + (size_t)r * a.N + c;
  int sum[CPT];
  if constexpr (CPT == 4) {
    int4 s4 = *reinterpret_cast<const int4*>(p);
#pragma unroll 4
    for (int s = 1; s < a.splits; ++s) {
      const int4 u = *reinterpret_cast<const int4*>(p + s * stride);
      s4.x += u.x;
      s4.y += u.y;
      s4.z += u.z;
      s4.w += u.w;
    }
    sum[0] = s4.x;
    sum[1] = s4.y;
    sum[2] = s4.z;
    sum[3] = s4.w;
  } else {
    sum[0] = p[0];
    for (int s = 1; s < a.splits; ++s) sum[0] += p[s * stride];
  }
  const float sxv = *a.sx;
  float v[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e)
    v[e] = static_cast<float>(sum[e]) * (sxv * a.sw[c + e]);
  TO* out = static_cast<TO*>(a.c) + (size_t)r * a.N + c;
  if constexpr (CPT == 4 && sizeof(TO) == 4) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (CPT == 4) {
    *reinterpret_cast<uint2*>(out) =
        make_uint2(pack2(from_f<TO>(v[0]), from_f<TO>(v[1])),
                   pack2(from_f<TO>(v[2]), from_f<TO>(v[3])));
  } else {
    out[0] = from_f<TO>(v[0]);
  }
}

template <typename TO, int BM, int BN, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t stream, int* plan) {
  using S = I8Shape<BM, BN>;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, a.splits);
  if (plan != nullptr) {
    plan[0] = grid.x * grid.y;
    plan[1] = a.splits;
    plan[2] = S::kSmemBytes;
    plan[3] = BM;
    plan[4] = BN;
  }
  auto kern = int8_mma<TO, BM, BN, VEC>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t e = allow_dynamic_smem(reinterpret_cast<const void*>(kern),
                                     S::kSmemBytes, smem_set);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, S::kSmemBytes, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  constexpr int CPT = VEC ? 4 : 1;
  const size_t n = (size_t)a.M * (a.N / CPT);
  return launch_dependent(int8_reduce<TO, CPT>,
                          dim3((unsigned)((n + 255) / 256)), dim3(256), stream,
                          a);
}

// BM and BN as the caller planned them (BN 32 where the copies take element
// loads).
template <typename TO>
cudaError_t dispatch(const Args& a, int bm, int bn, cudaStream_t s,
                     int* plan) {
  const bool vec = a.K % 16 == 0 && a.N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
#define REPRO_I8(BM)                                     \
  (!vec       ? launch<TO, BM, 32, false>(a, s, plan)    \
   : bn == 64 ? launch<TO, BM, 64, true>(a, s, plan)     \
              : launch<TO, BM, 32, true>(a, s, plan))
  return bm == 16 ? REPRO_I8(16) : REPRO_I8(32);
#undef REPRO_I8
}

}  // namespace

// x [M, K] int8, w [K, N] int8 (row-major), sx a device float, sw [N] float,
// c [M, N] in out_dtype: 0 = float32, 1 = bfloat16.  bm (16 or 32) and bn
// (32 or 64): the CTA's output tile; splits: K ranges of whole 32-deep
// slices, with splits > 1 ws holds splits * M * N int32.  plan (may be null)
// receives output tiles, K ranges, dynamic shared memory bytes, BM and BN of
// the launch.
extern "C" int int8_matmul(const void* x, const void* w, const float* sx,
                           const float* sw, void* c, void* ws, int M, int K,
                           int N, int out_dtype, int bm, int bn, int splits,
                           int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long slices = (K + (long long)kSlice - 1) / kSlice;
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || splits > slices ||
      splits > 65535 || (splits > 1 && ws == nullptr) ||
      (bm != 16 && bm != 32) || (bn != 32 && bn != 64) ||
      slices * (splits + 1) > INT32_MAX || (long long)M * N > INT32_MAX)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               sx, sw, c, static_cast<int*>(ws), M, K, N, splits};
  if (out_dtype == 0) return dispatch<float>(a, bm, bn, s, plan);
  if (out_dtype == 1) return dispatch<__nv_bfloat16>(a, bm, bn, s, plan);
  return cudaErrorInvalidValue;
}
