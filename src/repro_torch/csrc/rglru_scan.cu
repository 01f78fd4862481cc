// The RG-LRU recurrence h_t = a_t * h_{t-1} + g_t of a prefill, for Hopper
// (sm_90a), float32 throughout.
//
// Replaces no Pallas kernel: the reference runs the recurrence as one
// `lax.scan` (src/repro/models/rglru.py `rglru_prefill`, `rglru_forward`),
// a single device loop under XLA.  Its eager PyTorch counterpart is a
// Python loop of three operators a position, about 3 x S launches per
// RG-LRU layer, which a bucketed prefill's CUDA graph would hold as nodes
// (166 k at the 3072-token bucket over recurrentgemma-2b's 18 RG-LRU
// layers).  This kernel is that loop as one launch.
//
// Bound on the H100: the scan reads a and g once at each live position
// (before its row's length) and writes every h once, (2 x live + B x S) x W
// x 4 bytes (94 MB at [1, 3072, 2560] all live, 0.028 ms at 3.35 TB/s; 78.6
// MB, 0.0235 ms, with 2300 live); its 2 x live x W operations are nothing
// beside that.  The recurrence is sequential in t, so only B x W channels
// run in parallel, and a thread per channel that loads its own next
// positions keeps too few bytes in flight to stream at that rate: at B = 1
// the card holds 2560 such threads, ~164 KB of loads in flight where 3.35
// TB/s over a ~0.7 us round trip wants 2-3 MB.  That design took
// 0.2666 ms, one round trip for every 8 positions.
//
// Design: a CTA owns C channels of one row (C = 8 to 128, 4C threads; the
// wrapper's plan, `rglru_plan`, picks C and the tile's T from B and W so
// the forward's grid keeps a CTA an SM or more: C 16 at B = 1 and W 2560,
// 160 CTAs).  Every thread of the CTA stages tiles of T positions x C
// channels of a and g into a ring of kFwdStages (3) tiles in dynamic shared
// memory by 16-byte cp.async copies (4-byte ones where W is not a multiple
// of 4 or an operand is off a 16-byte boundary; channels past W
// zero-filled), two tiles ahead, one cp.async.wait_group and one barrier a
// tile.  The first C threads each walk one channel's chain through the tile
// in t order, the loop unrolled 8 positions deep so the shared-memory reads
// of the next positions issue ahead of the dependent steps (h is stored to
// device memory, which the reads cannot alias); consecutive channels are
// consecutive words, so the reads are free of bank conflicts.  Each step is
// __fmul_rn then __fadd_rn (no fused multiply-add), which is bit for bit
// the plain loop's `a * h + g` in two float32 operators: the order in t is
// the plain loop's, whatever the plan.  The chain threads store h once a
// position, C x 4 contiguous bytes (staging h through shared memory for
// 16-byte stores by every thread measured slower at every row: PERF.md).  A
// position at or past its row's length keeps h (the plain loop's a = 1, g =
// 0, which is exact), so a right-padded prompt leaves the state of its last
// real token; `hs` holds h at every position, the kept h on the padded
// ones, and past the first two tiles (issued before the length is read)
// rows past the length are not loaded at all.
//
// The backward (`rglru_scan_bwd`, training; the reference differentiates
// its lax.scan with jax.grad) runs the recurrence's adjoint in reverse
// time: given dhs (the gradient of every h) and dh (of the last h),
// gh_{S-1} = dhs_{S-1} + dh, gh_t = dhs_t + a_{t+1} * gh_{t+1}, and
// dg_t = gh_t, da_t = gh_t * h_{t-1} (h_{-1} = 0, h_{t-1} read from the
// forward's saved hs).  It reads a, hs and dhs and writes da and dg once:
// 5 x B x S x W x 4 bytes (157 MB at [1, 3072, 2560], 0.047 ms at
// 3.35 TB/s), bound by bytes like the forward.  The same CTA, a ring of
// kBwdStages (4) tiles, walked downward: a tile stages a_t and dhs_t for
// t in [t0, t0 + T) and hs one row earlier, [t0 - 1, t0 + T - 1) (the row
// before t = 0 zero-filled: h_{-1} = 0), and the chain runs gh = dhs_t +
// carry, dg_t = gh, da_t = gh * h_{t-1}, carry = a_t * gh, in the order of
// `rglru_scan_bwd_plain`, so bit for bit that loop.  Each channel's
// adjoint is its own: no atomics and no sums across threads.  Training
// passes no lengths (the wrapper refuses them with a gradient).
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <initializer_list>

#include "launch.cuh"

namespace {

constexpr int kSmemLimit = 232448;  // a CTA's shared memory on the H100
constexpr int kGroup = 8;           // positions the chain unrolls
// the rings' depths in tiles (kernels/rglru_scan.py `STAGES`): 3, 4 and 6
// forward tiles ran within 2% of each other; the backward at a training
// batch ran 6% faster with a fourth (launch/scan_probe.py --sweep, PERF.md)
constexpr int kFwdStages = 3;
constexpr int kBwdStages = 4;

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok, bool vec) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's newest copy groups are still in
// flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, hi) of a tile of C channels into dst (row r at dst + r * C):
// row r from base + off + r * W, rows below `lo` and channels at or past
// `vc` zero-filled, by every thread of the CTA in units of U floats (4:
// 16-byte copies, vc, W and the addresses multiples of 4 floats; 1: single
// floats).
template <int C, int U>
__device__ __forceinline__ void stage_units(float* dst, const float* base,
                                            long long off, int W, int lo,
                                            int hi, int vc) {
  constexpr int kPer = C / U;
  for (int i = threadIdx.x; i < hi * kPer; i += 4 * C) {
    const int r = i / kPer, col = (i % kPer) * U;
    const bool ok = r >= lo && col < vc;
    const float* from = ok ? base + off + (long long)r * W + col : base;
    cp_async(dst + r * C + col, from, ok, U == 4);
  }
}
template <int C>
__device__ __forceinline__ void stage(float* dst, const float* base,
                                      long long off, int W, int lo, int hi,
                                      int vc, bool vec) {
  if (vec)
    stage_units<C, 4>(dst, base, off, W, lo, hi, vc);
  else
    stage_units<C, 1>(dst, base, off, W, lo, hi, vc);
}

// Dynamic shared memory of a plan, in floats: the ring of 2 operands a
// tile forward, 3 backward (kernels/rglru_scan.py `smem_bytes` mirrors it).
constexpr int smem_floats(int C, int T, int backward) {
  return backward ? T * C * kBwdStages * 3 : T * C * kFwdStages * 2;
}

template <int C>
__global__ void __launch_bounds__(4 * C)
    rglru_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ g,
                      const int* __restrict__ lengths,
                      float* __restrict__ hs, float* __restrict__ h_last,
                      int S, int W, int T, int vec) {
  constexpr int stages = kFwdStages;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int tile = T * C;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * C;
  const int vc = min(C, W - c0);
  const long long row0 = (long long)b * S;
  const int nt = (S + T - 1) / T;

  // tile k's rows of a and g below `lim` into stage k % stages; a group is
  // committed for every k, empty or not, so the wait counts stay fixed
  auto issue = [&](int k, int lim) {
    const int t0 = k * T;
    const int hi = k < nt ? min(T, lim - t0) : 0;
    if (hi > 0) {
      float* st = ring + (k % stages) * 2 * tile;
      const long long off = (row0 + t0) * W + c0;
      stage<C>(st, a, off, W, 0, hi, vc, vec);
      stage<C>(st + tile, g, off, W, 0, hi, vc, vec);
    }
    cp_commit();
  };
  // the first tiles are issued before the row's length is read (so the
  // first copies do not wait for that load), the later ones stop at it
  for (int k = 0; k < stages - 1; ++k) issue(k, S);
  int len = S;
  if (lengths != nullptr) len = min(max(lengths[b], 0), S);

  float h = 0.f;
  for (int k = 0; k < nt; ++k) {
    cp_wait<stages - 2>();
    __syncthreads();  // tile k landed; tile k - 1's stage is free
    issue(k + stages - 1, len);
    if (tid >= vc) continue;
    const int t0 = k * T;
    const int nvalid = min(T, S - t0);
    const int nlive = max(0, min(nvalid, len - t0));
    const float* sa = ring + (k % stages) * 2 * tile + tid;
    const float* sg = sa + tile;
    float* dst = hs + (row0 + t0) * W + c0 + tid;
    int u = 0;
#pragma unroll(kGroup)
    for (; u < nlive; ++u) {
      h = __fadd_rn(__fmul_rn(sa[u * C], h), sg[u * C]);
      dst[(size_t)u * W] = h;
    }
    for (; u < nvalid; ++u) dst[(size_t)u * W] = h;
  }
  if (tid < vc) h_last[(size_t)b * W + c0 + tid] = h;
}

template <int C>
__global__ void __launch_bounds__(4 * C)
    rglru_scan_bwd_kernel(const float* __restrict__ a,
                          const float* __restrict__ hs,
                          const float* __restrict__ dhs,
                          const float* __restrict__ dh,
                          float* __restrict__ da, float* __restrict__ dg,
                          int S, int W, int T, int vec) {
  constexpr int stages = kBwdStages;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int tile = T * C;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * C;
  const int vc = min(C, W - c0);
  const int nt = (S + T - 1) / T;
  const long long row0 = (long long)b * S;

  // the i-th tile walked, k = nt - 1 - i: a and dhs at [t0, t0 + T), hs at
  // [t0 - 1, t0 + T - 1), the row before t = 0 zero-filled
  auto issue = [&](int i) {
    const int k = nt - 1 - i;
    if (k >= 0) {
      const int t0 = k * T;
      const int hi = min(T, S - t0);
      float* st = ring + (i % stages) * 3 * tile;
      const long long off = (row0 + t0) * W + c0;
      stage<C>(st, a, off, W, 0, hi, vc, vec);
      stage<C>(st + tile, dhs, off, W, 0, hi, vc, vec);
      stage<C>(st + 2 * tile, hs, off - W, W, t0 == 0 ? 1 : 0, hi, vc, vec);
    }
    cp_commit();
  };
  for (int i = 0; i < stages - 1; ++i) issue(i);

  float carry = tid < vc ? dh[(size_t)b * W + c0 + tid] : 0.f;
  for (int i = 0; i < nt; ++i) {
    cp_wait<stages - 2>();
    __syncthreads();
    issue(i + stages - 1);
    if (tid >= vc) continue;
    const int t0 = (nt - 1 - i) * T;
    const float* sa = ring + (i % stages) * 3 * tile + tid;
    const float* sd = sa + tile;
    const float* sh = sa + 2 * tile;
    const size_t at = (row0 + t0) * W + c0 + tid;
#pragma unroll(kGroup)
    for (int p = min(T, S - t0) - 1; p >= 0; --p) {
      const float gh = __fadd_rn(sd[p * C], carry);
      dg[at + (size_t)p * W] = gh;
      da[at + (size_t)p * W] = __fmul_rn(gh, sh[p * C]);
      carry = __fmul_rn(sa[p * C], gh);
    }
  }
}

// every pointer 16-byte aligned (the 16-byte copies)
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// A plan's dynamic shared memory in bytes, -1 for a plan the kernels do
// not take: C not a power of two from 8 to 128; T not a multiple of 8 in
// [8, 256]; more shared memory than a CTA has.
int plan_smem(int C, int T, int backward) {
  if (C < 8 || C > 128 || (C & (C - 1)) || T < 8 || T > 256 || T % 8)
    return -1;
  const int bytes = smem_floats(C, T, backward) * 4;
  return bytes <= kSmemLimit ? bytes : -1;
}

// Let `kern` take up to a CTA's whole shared memory (once per kernel and
// device), where the plan needs more than the default 48 KB.
template <typename K>
cudaError_t prepare(K* kern, int smem, std::atomic<uint64_t>& set_on) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return allow_dynamic_smem(reinterpret_cast<const void*>(kern), kSmemLimit,
                            set_on);
}

template <int C>
int launch_fwd(const float* a, const float* g, const int* lengths, float* hs,
               float* h_last, int B, int S, int W, int T, int smem,
               cudaStream_t stream) {
  static std::atomic<uint64_t> set_on{0};
  cudaError_t e = prepare(&rglru_scan_kernel<C>, smem, set_on);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec = W % 4 == 0 && aligned16({a, g});
  dim3 grid((W + C - 1) / C, B);
  rglru_scan_kernel<C><<<grid, 4 * C, smem, stream>>>(
      a, g, lengths, hs, h_last, S, W, T, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_bwd(const float* a, const float* hs, const float* dhs,
               const float* dh, float* da, float* dg, int B, int S, int W,
               int T, int smem, cudaStream_t stream) {
  static std::atomic<uint64_t> set_on{0};
  cudaError_t e = prepare(&rglru_scan_bwd_kernel<C>, smem, set_on);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec = W % 4 == 0 && aligned16({a, hs, dhs});
  dim3 grid((W + C - 1) / C, B);
  rglru_scan_bwd_kernel<C><<<grid, 4 * C, smem, stream>>>(
      a, hs, dhs, dh, da, dg, S, W, T, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The channels a CTA the kernels are built for (kernels/rglru_scan.py
// `CHANNELS`).
#define REPRO_RGLRU_CHANNELS(X) X(8) X(16) X(32) X(64) X(128)

// a, g, hs: [B, S, W] float32, contiguous; h_last: [B, W] float32;
// lengths: [B] int32 (null: every row S long).  The plan (kernels/
// rglru_scan.py `rglru_plan`): C channels a CTA of 4C threads, tiles of T
// positions; grid (ceil(W / C), B).
extern "C" int rglru_scan(const void* a, const void* g, const void* lengths,
                          void* hs, void* h_last, int B, int S, int W, int C,
                          int T, void* stream) {
  const int smem = plan_smem(C, T, 0);
  if (B < 1 || S < 1 || W < 1 || B > 65535 || smem < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* fa = static_cast<const float*>(a);
  const auto* fg = static_cast<const float*>(g);
  const auto* n = static_cast<const int*>(lengths);
  auto* fh = static_cast<float*>(hs);
  auto* fl = static_cast<float*>(h_last);
#define REPRO_RGLRU_FWD(C_)                                                \
  if (C == C_)                                                             \
    return launch_fwd<C_>(fa, fg, n, fh, fl, B, S, W, T, smem, st);
  REPRO_RGLRU_CHANNELS(REPRO_RGLRU_FWD)
#undef REPRO_RGLRU_FWD
  return cudaErrorInvalidValue;
}

// The backward.  a, hs, dhs, da, dg: [B, S, W] float32, contiguous; dh:
// [B, W] float32.  The plan as the forward's; grid (ceil(W / C), B).
extern "C" int rglru_scan_bwd(const void* a, const void* hs, const void* dhs,
                              const void* dh, void* da, void* dg, int B,
                              int S, int W, int C, int T, void* stream) {
  const int smem = plan_smem(C, T, 1);
  if (B < 1 || S < 1 || W < 1 || B > 65535 || smem < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* fa = static_cast<const float*>(a);
  const auto* fh = static_cast<const float*>(hs);
  const auto* fd = static_cast<const float*>(dhs);
  const auto* fdh = static_cast<const float*>(dh);
  auto* oa = static_cast<float*>(da);
  auto* og = static_cast<float*>(dg);
#define REPRO_RGLRU_BWD(C_)                                                 \
  if (C == C_)                                                              \
    return launch_bwd<C_>(fa, fh, fd, fdh, oa, og, B, S, W, T, smem, st);
  REPRO_RGLRU_CHANNELS(REPRO_RGLRU_BWD)
#undef REPRO_RGLRU_BWD
  return cudaErrorInvalidValue;
}
