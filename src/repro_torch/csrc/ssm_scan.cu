// The selective scan of a Mamba-1 prefill (the ssm family, falcon-mamba),
// for Hopper (sm_90a), float32 arithmetic throughout:
//   a_bar = exp(dt_t * a),  bx = (dt_t * b_t) * x_t,  h = a_bar * h + bx,
//   y_t = sum_n h[n] * c_t[n]
// over t = 0 .. S-1 for every row, channel d < Di and state n < N.
//
// Replaces no Pallas kernel: the reference runs the recurrence as one
// `lax.scan` (src/repro/models/ssm.py `ssm_forward`, `ssm_prefill`) over
// a_bar and bx, which it first materializes at [B, S, Di, N] in float32:
// 1.6 GB each a layer for one 3072-token prompt at falcon-mamba's widths
// (Di 8192, N 16).  Its eager PyTorch counterpart (`ssm_scan_plain`) is a
// Python loop of ~15 operators a position, which a bucketed prefill's
// CUDA graph would hold as ~3 M nodes over 64 layers.  This kernel is
// that loop as one launch, and discretizes in registers: neither a_bar
// nor bx is ever written to memory.
//
// Bound on the H100: each (position, channel) reads dt (4 bytes) and x (2
// in bf16) and writes y (4): ~10 bytes x B x S x Di, 252 MB and 0.075 ms
// at 3.35 TB/s at [1, 3072, 8192, 16]; b and c (8 x N bytes a position)
// are shared by the row's channels.  The ~7 float32 operations a state
// and position take 0.042 ms at 67 TFLOP/s, so bytes bound it; expf's
// instruction sequence makes the issue rate the practical limit.
//
// Design: N / 4 threads own a channel, each 4 consecutive states of it in
// registers (h and a); a CTA of 128 threads covers 128 / (N / 4) channels
// (32 at N 16: 256 CTAs at B = 1 fill the 132 SMs).  The row's b and c,
// which every channel shares, and the CTA's dt and x are staged in shared
// memory a tile of 32 positions at a time by coalesced loads; the next
// tile's loads are issued into registers before the current tile's
// positions run, so their latency overlaps the dependent chain.  Every
// product and sum is an explicit __fmul_rn / __fadd_rn (no contraction
// into a fused multiply-add) and the exponential is expf (no fast math),
// so each position is bit for bit the plain loop's float32 operators.
// The readout sums a thread's 4 states in order, then the N / 4 threads'
// partials by a butterfly of shuffles (offsets 1, 2, 4, ...): pairs of
// neighbours first, the order of `readout` in kernels/ssm_scan.py.  A
// position at or past its row's length keeps h (its y reads the kept h),
// so a right-padded prompt leaves the state of its last real token.
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;    // positions staged at a time
constexpr int kGroup = 4;    // states a thread owns

template <typename XT, int T>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const float* __restrict__ dt, const XT* __restrict__ x,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ a,
                    const int* __restrict__ lengths, float* __restrict__ y,
                    float* __restrict__ h_last, int S, int Di) {
  constexpr int N = T * kGroup;           // states of a channel
  constexpr int C = kThreads / T;         // channels of a CTA
  constexpr int BC = kTile * N / kThreads;  // b (and c) values a thread loads
  constexpr int DX = kTile * C / kThreads;  // dt (and x) values it loads
  __shared__ __align__(16) float s_b[kTile * N];
  __shared__ __align__(16) float s_c[kTile * N];
  __shared__ float s_dt[kTile * C];
  __shared__ float s_x[kTile * C];

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * C;
  const int cc = tid / T;                 // this thread's channel in the CTA
  const int j = tid % T;                  // its group of states
  const int ch = c0 + cc;
  const bool live = ch < Di;
  int len = S;
  if (lengths != nullptr) len = min(max(lengths[row], 0), S);

  float ar[kGroup], h[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    ar[g] = live ? a[(size_t)ch * N + j * kGroup + g] : 0.f;
    h[g] = 0.f;
  }
  const float* b_row = bm + (size_t)row * S * N;
  const float* c_row = cm + (size_t)row * S * N;
  const size_t dx_row = (size_t)row * S * Di;

  float pb[BC], pc[BC], pd[DX], px[DX];
  auto load_tile = [&](int t0) {
    const int nbc = (S - t0 < kTile ? S - t0 : kTile) * N;
#pragma unroll
    for (int k = 0; k < BC; ++k) {
      const int e = tid + k * kThreads;
      pb[k] = e < nbc ? b_row[(size_t)t0 * N + e] : 0.f;
      pc[k] = e < nbc ? c_row[(size_t)t0 * N + e] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < DX; ++k) {
      const int e = tid + k * kThreads;
      const int t = t0 + e / C, d = c0 + e % C;
      const bool ok = t < S && d < Di;
      const size_t at = dx_row + (size_t)t * Di + d;
      pd[k] = ok ? dt[at] : 0.f;
      px[k] = ok ? to_f(x[at]) : 0.f;
    }
  };

  load_tile(0);
  for (int t0 = 0; t0 < S; t0 += kTile) {
    __syncthreads();                      // the last tile's reads are done
#pragma unroll
    for (int k = 0; k < BC; ++k) {
      s_b[tid + k * kThreads] = pb[k];
      s_c[tid + k * kThreads] = pc[k];
    }
#pragma unroll
    for (int k = 0; k < DX; ++k) {
      s_dt[tid + k * kThreads] = pd[k];
      s_x[tid + k * kThreads] = px[k];
    }
    __syncthreads();
    if (t0 + kTile < S) load_tile(t0 + kTile);
    const int pend = S - t0 < kTile ? S - t0 : kTile;
#pragma unroll 4
    for (int p = 0; p < pend; ++p) {
      const int t = t0 + p;
      const float d = s_dt[p * C + cc];
      const float4 bq =
          *reinterpret_cast<const float4*>(&s_b[p * N + j * kGroup]);
      const float4 cq =
          *reinterpret_cast<const float4*>(&s_c[p * N + j * kGroup]);
      const float bv[kGroup] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[kGroup] = {cq.x, cq.y, cq.z, cq.w};
      if (t < len) {
        const float xv = s_x[p * C + cc];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const float a_bar = expf(__fmul_rn(d, ar[g]));
          const float bx = __fmul_rn(__fmul_rn(d, bv[g]), xv);
          h[g] = __fadd_rn(__fmul_rn(a_bar, h[g]), bx);
        }
      }
      float part = __fmul_rn(h[0], cv[0]);
#pragma unroll
      for (int g = 1; g < kGroup; ++g)
        part = __fadd_rn(part, __fmul_rn(h[g], cv[g]));
#pragma unroll
      for (int off = 1; off < T; off <<= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
      if (j == 0 && live) y[dx_row + (size_t)t * Di + ch] = part;
    }
  }
  if (live) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      h_last[((size_t)row * Di + ch) * N + j * kGroup + g] = h[g];
  }
}

template <typename XT, int T>
int launch_scan(const void* dt, const void* x, const void* b, const void* c,
                const void* a, const void* lengths, void* y, void* h_last,
                int B, int S, int Di, cudaStream_t stream) {
  constexpr int C = kThreads / T;
  dim3 grid((Di + C - 1) / C, B);
  ssm_scan_kernel<XT, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const XT*>(x),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(a), static_cast<const int*>(lengths),
      static_cast<float*>(y), static_cast<float*>(h_last), S, Di);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int dispatch_n(const void* dt, const void* x, const void* b, const void* c,
               const void* a, const void* lengths, void* y, void* h_last,
               int B, int S, int Di, int N, cudaStream_t stream) {
  switch (N / kGroup) {
    case 1: return launch_scan<XT, 1>(dt, x, b, c, a, lengths, y, h_last,
                                      B, S, Di, stream);
    case 2: return launch_scan<XT, 2>(dt, x, b, c, a, lengths, y, h_last,
                                      B, S, Di, stream);
    case 4: return launch_scan<XT, 4>(dt, x, b, c, a, lengths, y, h_last,
                                      B, S, Di, stream);
    case 8: return launch_scan<XT, 8>(dt, x, b, c, a, lengths, y, h_last,
                                      B, S, Di, stream);
    case 16: return launch_scan<XT, 16>(dt, x, b, c, a, lengths, y, h_last,
                                        B, S, Di, stream);
    case 32: return launch_scan<XT, 32>(dt, x, b, c, a, lengths, y, h_last,
                                        B, S, Di, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dt: [B, S, Di] float32; x: [B, S, Di] float32 (x_dtype 0) or bfloat16
// (1); b, c: [B, S, N] float32; a: [Di, N] float32; lengths: [B] int32
// (null: every row S long); y: [B, S, Di] float32; h_last: [B, Di, N]
// float32; all contiguous.  N = 4 x a power of two up to 32.
// grid (ceil(Di / (128 / (N / 4))), B).
extern "C" int ssm_scan(const void* dt, const void* x, const void* b,
                        const void* c, const void* a, const void* lengths,
                        void* y, void* h_last, int x_dtype, int B, int S,
                        int Di, int N, void* stream) {
  if (B < 1 || S < 1 || Di < 1 || B > 65535 || N % kGroup)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return dispatch_n<float>(dt, x, b, c, a, lengths, y, h_last, B, S, Di,
                             N, st);
  if (x_dtype == 1)
    return dispatch_n<__nv_bfloat16>(dt, x, b, c, a, lengths, y, h_last, B,
                                     S, Di, N, st);
  return cudaErrorInvalidValue;
}
