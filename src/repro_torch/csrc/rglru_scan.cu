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
// Bound on the H100: the scan reads a and g and writes every h once,
// 3 x B x S x W x 4 bytes (94 MB at [1, 3072, 2560], 0.028 ms at
// 3.35 TB/s); its 2 x B x S x W operations are nothing beside that.  The
// recurrence is sequential in t, so only B x W channels run in parallel.
//
// Design: one thread per (b, channel), walking t = 0 .. S-1 in order.
// Neighbouring threads hold neighbouring channels, so each position's
// loads and the store of h are coalesced.  The loads of a and g do not
// depend on h: the thread issues the next 8 positions' loads before it
// runs the current 8 dependent multiply-adds, so the memory latency
// overlaps the chain.  Each step is __fmul_rn then __fadd_rn (no fused
// multiply-add), which is bit for bit the plain loop's `a * h + g` in two
// float32 operators.  A position at or past its row's length keeps h (the
// plain loop's a = 1, g = 0, which is exact), so a right-padded prompt
// leaves the state of its last real token; `hs` holds h at every
// position, the kept h on the padded ones.
//
// The backward (`rglru_scan_bwd`, training; the reference differentiates
// its lax.scan with jax.grad) runs the recurrence's adjoint in reverse
// time: given dhs (the gradient of every h) and dh (of the last h),
// gh_{S-1} = dhs_{S-1} + dh, gh_t = dhs_t + a_{t+1} * gh_{t+1}, and
// dg_t = gh_t, da_t = gh_t * h_{t-1} (h_{-1} = 0, h_{t-1} read from the
// forward's saved hs).  It reads a, hs and dhs and writes da and dg once:
// 5 x B x S x W x 4 bytes (157 MB at [1, 3072, 2560], 0.047 ms at
// 3.35 TB/s), bound by bytes like the forward.  Same design: a thread per
// (b, channel), t walked downward with the next 8 positions' loads issued
// ahead of the dependent chain, __fmul_rn / __fadd_rn in the order of
// `rglru_scan_bwd_plain`, so bit for bit that loop.  Training passes no
// lengths (the wrapper refuses them with a gradient).
#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 8;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ g,
                      const int* __restrict__ lengths,
                      float* __restrict__ hs, float* __restrict__ h_last,
                      int S, int W) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= W) return;
  int len = S;
  if (lengths != nullptr) len = min(max(lengths[b], 0), S);
  const size_t base = (size_t)b * S * W + c;
  const float* ap = a + base;
  const float* gp = g + base;
  float* hp = hs + base;
  float ra[kUnroll], rg[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    ra[u] = u < S ? ap[(size_t)u * W] : 0.f;
    rg[u] = u < S ? gp[(size_t)u * W] : 0.f;
  }
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float na[kUnroll], ng[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + kUnroll + u;
      na[u] = t < S ? ap[(size_t)t * W] : 0.f;
      ng[u] = t < S ? gp[(size_t)t * W] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < S) {
        if (t < len) h = __fadd_rn(__fmul_rn(ra[u], h), rg[u]);
        hp[(size_t)t * W] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ra[u] = na[u];
      rg[u] = ng[u];
    }
  }
  h_last[(size_t)b * W + c] = h;
}

__global__ void __launch_bounds__(kThreads)
    rglru_scan_bwd_kernel(const float* __restrict__ a,
                          const float* __restrict__ hs,
                          const float* __restrict__ dhs,
                          const float* __restrict__ dh,
                          float* __restrict__ da, float* __restrict__ dg,
                          int S, int W) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= W) return;
  const size_t base = (size_t)b * S * W + c;
  const float* ap = a + base;
  const float* hp = hs + base;
  const float* dp = dhs + base;
  // r counts positions from the end: r = 0 is t = S - 1
  float ra[kUnroll], rd[kUnroll], rh[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = S - 1 - u;
    ra[u] = t >= 0 ? ap[(size_t)t * W] : 0.f;
    rd[u] = t >= 0 ? dp[(size_t)t * W] : 0.f;
    rh[u] = t >= 1 ? hp[(size_t)(t - 1) * W] : 0.f;
  }
  float carry = dh[(size_t)b * W + c];
  for (int r0 = 0; r0 < S; r0 += kUnroll) {
    float na[kUnroll], nd[kUnroll], nh[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = S - 1 - (r0 + kUnroll + u);
      na[u] = t >= 0 ? ap[(size_t)t * W] : 0.f;
      nd[u] = t >= 0 ? dp[(size_t)t * W] : 0.f;
      nh[u] = t >= 1 ? hp[(size_t)(t - 1) * W] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = S - 1 - (r0 + u);
      if (t >= 0) {
        const float gh = __fadd_rn(rd[u], carry);
        dg[base + (size_t)t * W] = gh;
        da[base + (size_t)t * W] = __fmul_rn(gh, rh[u]);
        carry = __fmul_rn(ra[u], gh);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ra[u] = na[u];
      rd[u] = nd[u];
      rh[u] = nh[u];
    }
  }
}

}  // namespace

// a, g, hs: [B, S, W] float32, contiguous; h_last: [B, W] float32;
// lengths: [B] int32 (null: every row S long).  grid (ceil(W / 128), B).
extern "C" int rglru_scan(const void* a, const void* g, const void* lengths,
                          void* hs, void* h_last, int B, int S, int W,
                          void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(g),
      static_cast<const int*>(lengths), static_cast<float*>(hs),
      static_cast<float*>(h_last), S, W);
  return static_cast<int>(cudaGetLastError());
}

// The backward.  a, hs, dhs, da, dg: [B, S, W] float32, contiguous; dh:
// [B, W] float32.  grid (ceil(W / 128), B).
extern "C" int rglru_scan_bwd(const void* a, const void* hs, const void* dhs,
                              const void* dh, void* da, void* dg, int B,
                              int S, int W, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_bwd_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(hs),
      static_cast<const float*>(dhs), static_cast<const float*>(dh),
      static_cast<float*>(da), static_cast<float*>(dg), S, W);
  return static_cast<int>(cudaGetLastError());
}
