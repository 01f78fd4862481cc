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
//
// The backward (`ssm_scan_bwd`, training; the reference differentiates its
// lax.scan with jax.grad).  Given dy [B, S, Di] and dh [B, Di, N] (the
// last h's gradient), in reverse time, per (row, channel d, state n):
//   gh_t  = dy_t c_t + a_bar_{t+1} gh_{t+1}   (+ dh at S - 1)
//   dx_t  = sum_n gh_t dt_t b_t               ddt_t = sum_n gh_t (a a_bar_t
//   db_t  = sum_d gh_t dt_t x_t                        h_{t-1} + b_t x_t)
//   dc_t  = sum_d h_t dy_t                     da = sum_{b,t} gh_t dt_t
//                                                     a_bar_t h_{t-1}
// h is never stored at [B, S, Di, N] (512 KB a token and layer at
// falcon-mamba's widths): the kernel first re-runs the forward and writes
// h at the start of every chunk of kChunk positions into scratch
// ([B, S / kChunk, Di, N] float32, the wrapper's), then walks the chunks
// in reverse, recomputing a chunk's h into shared memory from its
// checkpoint (never by dividing by a_bar, which is unstable near 0), and
// runs the chunk's positions downward.  a_bar is recomputed as the
// forward computes it (expf of the same __fmul_rn product).  dx and ddt
// sum a channel's N states in the readout's order (a thread's 4, then the
// butterfly).  db and dc sum over channels, which span CTAs, and da over
// rows: each CTA sums its channels (a butterfly over a warp's channels,
// then its 4 warps in order) into a partial per (row, position, CTA), and
// a second kernel sums the partials over the CTAs, and da's per-row
// partials over the rows, in a fixed order.  No atomics: the gradient is
// the same bit for bit from run to run, and bit for bit
// `ssm_scan_bwd_plain`, which sums in the same orders.
//
// Bound: dt, x, dy read and ddt, dx written a position and channel, b, c,
// db, dc a position, a, dh and da once: ~(4 + 2 + 4 + 4 + 2) bytes x B x
// S x Di in bf16, 0.16 ms at [4, 512, 8192, 16] at 3.35 TB/s; ~20 float32
// operations a (position, channel, state) for the two forward passes and
// the reverse one take 0.32 ms at 67 TFLOP/s, so operations bound it.
// The checkpoints (1 / kChunk of h) and the partials (4 bytes x B x S x
// Di at N 16) add traffic the bound does not count.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "dtype.cuh"
#include "launch.cuh"

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

constexpr int kChunk = 16;   // the backward's checkpoint stride
constexpr int kWarps = kThreads / 32;

// dynamic shared memory of the backward at T threads a channel: the
// chunk's h history (a float4 a thread and position), b and c (N a
// position), dt, x and dy (C a position), and the warps' channel sums of
// db and dc (2N a warp and position)
template <int T>
constexpr int bwd_smem_bytes() {
  return kChunk * kThreads * 16 +
         4 * (2 * kChunk * T * kGroup + 3 * kChunk * (kThreads / T) +
              kWarps * kChunk * 2 * T * kGroup);
}

template <typename XT, int T>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_bwd_kernel(const float* __restrict__ dt,
                        const XT* __restrict__ x,
                        const float* __restrict__ bm,
                        const float* __restrict__ cm,
                        const float* __restrict__ a,
                        const float* __restrict__ dy,
                        const float* __restrict__ dh,
                        float* __restrict__ ckpt, float* __restrict__ part_bc,
                        float* __restrict__ part_a, float* __restrict__ ddt,
                        XT* __restrict__ dx, int S, int Di) {
  constexpr int N = T * kGroup;
  constexpr int C = kThreads / T;
  constexpr int BC = (kChunk * N + kThreads - 1) / kThreads;
  constexpr int DX = (kChunk * C + kThreads - 1) / kThreads;
  extern __shared__ float4 smem4[];
  float4* s_hist = smem4;                         // [kChunk][kThreads]
  float* s_b = reinterpret_cast<float*>(s_hist + kChunk * kThreads);
  float* s_c = s_b + kChunk * N;
  float* s_dt = s_c + kChunk * N;
  float* s_x = s_dt + kChunk * C;
  float* s_dy = s_x + kChunk * C;
  float* s_red = s_dy + kChunk * C;               // [kWarps][kChunk][2N]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * C;
  const int cc = tid / T;
  const int j = tid % T;
  const int ch = c0 + cc;
  const bool live = ch < Di;
  const int nk = (S + kChunk - 1) / kChunk;

  float ar[kGroup], h[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    ar[g] = live ? a[(size_t)ch * N + j * kGroup + g] : 0.f;
    h[g] = 0.f;
  }
  const float* b_row = bm + (size_t)row * S * N;
  const float* c_row = cm + (size_t)row * S * N;
  const size_t dx_row = (size_t)row * S * Di;
  float4* ck = reinterpret_cast<float4*>(ckpt) +
               ((size_t)row * nk * Di + (live ? ch : 0)) * T + j;
  const size_t ck_stride = (size_t)Di * T;        // float4s a chunk

  float pb[BC], pc[BC], pd[DX], px[DX], py[DX];
  auto load_tile = [&](int t0, bool full) {
    const int nbc = (S - t0 < kChunk ? S - t0 : kChunk) * N;
#pragma unroll
    for (int k = 0; k < BC; ++k) {
      const int e = tid + k * kThreads;
      const bool ok = e < nbc;
      pb[k] = ok ? b_row[(size_t)t0 * N + e] : 0.f;
      pc[k] = ok && full ? c_row[(size_t)t0 * N + e] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < DX; ++k) {
      const int e = tid + k * kThreads;
      const int t = t0 + e / C, d = c0 + e % C;
      const bool ok = e < kChunk * C && t < S && d < Di;
      const size_t at = dx_row + (size_t)t * Di + d;
      pd[k] = ok ? dt[at] : 0.f;
      px[k] = ok ? to_f(x[at]) : 0.f;
      py[k] = ok && full ? dy[at] : 0.f;
    }
  };
  auto stage = [&]() {
    __syncthreads();                      // the last chunk's reads are done
#pragma unroll
    for (int k = 0; k < BC; ++k) {
      const int e = tid + k * kThreads;
      if (e < kChunk * N) {
        s_b[e] = pb[k];
        s_c[e] = pc[k];
      }
    }
#pragma unroll
    for (int k = 0; k < DX; ++k) {
      const int e = tid + k * kThreads;
      if (e < kChunk * C) {
        s_dt[e] = pd[k];
        s_x[e] = px[k];
        s_dy[e] = py[k];
      }
    }
    __syncthreads();
  };
  // the forward's update of h at chunk position p
  auto advance = [&](int p) {
    const float d = s_dt[p * C + cc];
    const float xv = s_x[p * C + cc];
    const float4 bq = *reinterpret_cast<const float4*>(&s_b[p * N + j * kGroup]);
    const float bv[kGroup] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float a_bar = expf(__fmul_rn(d, ar[g]));
      const float bx = __fmul_rn(__fmul_rn(d, bv[g]), xv);
      h[g] = __fadd_rn(__fmul_rn(a_bar, h[g]), bx);
    }
  };

  // pass 1: the forward, h at the start of every chunk into the scratch
  load_tile(0, false);
  for (int k = 0; k < nk; ++k) {
    const int t0 = k * kChunk;
    stage();
    if (k + 1 < nk) load_tile(t0 + kChunk, false);
    if (live) ck[k * ck_stride] = make_float4(h[0], h[1], h[2], h[3]);
    const int pend = S - t0 < kChunk ? S - t0 : kChunk;
    for (int p = 0; p < pend; ++p) advance(p);
  }

  // pass 2: the chunks in reverse, each recomputed from its checkpoint
  float carry[kGroup], da_acc[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    carry[g] = live ? dh[((size_t)row * Di + ch) * N + j * kGroup + g] : 0.f;
    da_acc[g] = 0.f;
  }
  load_tile((nk - 1) * kChunk, true);
  for (int k = nk - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int pend = S - t0 < kChunk ? S - t0 : kChunk;
    stage();
    if (k > 0) load_tile(t0 - kChunk, true);
    if (live) {
      const float4 q = ck[k * ck_stride];
      h[0] = q.x; h[1] = q.y; h[2] = q.z; h[3] = q.w;
    } else {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) h[g] = 0.f;
    }
    for (int p = 0; p < pend; ++p) {      // h before each position
      s_hist[p * kThreads + tid] = make_float4(h[0], h[1], h[2], h[3]);
      advance(p);
    }
    // h now holds h_t of the chunk's last position
    for (int p = pend - 1; p >= 0; --p) {
      const float4 hq = s_hist[p * kThreads + tid];
      const float hp[kGroup] = {hq.x, hq.y, hq.z, hq.w};
      const float d = s_dt[p * C + cc];
      const float xv = s_x[p * C + cc];
      const float dyv = s_dy[p * C + cc];
      const float4 bq =
          *reinterpret_cast<const float4*>(&s_b[p * N + j * kGroup]);
      const float4 cq =
          *reinterpret_cast<const float4*>(&s_c[p * N + j * kGroup]);
      const float bv[kGroup] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[kGroup] = {cq.x, cq.y, cq.z, cq.w};
      float vdb[kGroup], vdc[kGroup], sdx = 0.f, sddt = 0.f;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float a_bar = expf(__fmul_rn(d, ar[g]));
        const float gh = __fadd_rn(__fmul_rn(dyv, cv[g]), carry[g]);
        carry[g] = __fmul_rn(a_bar, gh);
        const float u = __fmul_rn(gh, d);
        const float tdx = __fmul_rn(u, bv[g]);
        const float tddt = __fmul_rn(
            gh, __fadd_rn(__fmul_rn(__fmul_rn(ar[g], a_bar), hp[g]),
                          __fmul_rn(bv[g], xv)));
        vdb[g] = __fmul_rn(u, xv);
        vdc[g] = __fmul_rn(h[g], dyv);
        da_acc[g] = __fadd_rn(da_acc[g], __fmul_rn(__fmul_rn(u, a_bar), hp[g]));
        sdx = g == 0 ? tdx : __fadd_rn(sdx, tdx);
        sddt = g == 0 ? tddt : __fadd_rn(sddt, tddt);
        h[g] = hp[g];
      }
      // a channel's states: the readout's butterfly
#pragma unroll
      for (int off = 1; off < T; off <<= 1) {
        sdx = __fadd_rn(sdx, __shfl_xor_sync(0xffffffffu, sdx, off));
        sddt = __fadd_rn(sddt, __shfl_xor_sync(0xffffffffu, sddt, off));
      }
      if (j == 0 && live) {
        const size_t at = dx_row + (size_t)(t0 + p) * Di + ch;
        dx[at] = from_f<XT>(sdx);
        ddt[at] = sddt;
      }
      // the warp's channels, neighbours first
#pragma unroll
      for (int off = T; off < 32; off <<= 1) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          vdb[g] = __fadd_rn(vdb[g], __shfl_xor_sync(0xffffffffu, vdb[g], off));
          vdc[g] = __fadd_rn(vdc[g], __shfl_xor_sync(0xffffffffu, vdc[g], off));
        }
      }
      if (lane < T) {
        float* r = s_red + (warp * kChunk + p) * 2 * N + j * kGroup;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          r[g] = vdb[g];
          r[N + g] = vdc[g];
        }
      }
    }
    __syncthreads();
    // the CTA's partial of the chunk: its warps in order
    for (int e = tid; e < pend * 2 * N; e += kThreads) {
      const int p = e / (2 * N), kk = e % (2 * N);
      float v = s_red[p * 2 * N + kk];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        v = __fadd_rn(v, s_red[(w * kChunk + p) * 2 * N + kk]);
      part_bc[(((size_t)row * S + t0 + p) * gridDim.x + blockIdx.x) * 2 * N +
              kk] = v;
    }
  }
  if (live) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      part_a[((size_t)row * Di + ch) * N + j * kGroup + g] = da_acc[g];
  }
}

// db, dc [B, S, N]: the CTAs' partials summed in order; da [Di, N]: the
// rows' partials summed in order
__global__ void __launch_bounds__(256)
    ssm_scan_bwd_reduce(const float* __restrict__ part_bc,
                        const float* __restrict__ part_a,
                        float* __restrict__ db, float* __restrict__ dc,
                        float* __restrict__ da, int B, int S, int N, int nx,
                        int Di) {
  const size_t n_bc = (size_t)B * S * 2 * N;
  const size_t n_a = (size_t)Di * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_bc + n_a; i += (size_t)gridDim.x * blockDim.x) {
    if (i < n_bc) {
      const size_t bt = i / (2 * N);
      const int kk = static_cast<int>(i % (2 * N));
      const float* src = part_bc + bt * nx * 2 * N + kk;
      float v = src[0];
      for (int q = 1; q < nx; ++q) v = __fadd_rn(v, src[(size_t)q * 2 * N]);
      if (kk < N)
        db[bt * N + kk] = v;
      else
        dc[bt * N + kk - N] = v;
    } else {
      const size_t e = i - n_bc;
      float v = part_a[e];
      for (int r = 1; r < B; ++r) v = __fadd_rn(v, part_a[(size_t)r * n_a + e]);
      da[e] = v;
    }
  }
}

template <typename XT, int T>
int launch_bwd(const void* dt, const void* x, const void* b, const void* c,
               const void* a, const void* dy, const void* dh, void* ckpt,
               void* part_bc, void* part_a, void* ddt, void* dx, void* db,
               void* dc, void* da, int B, int S, int Di,
               cudaStream_t stream) {
  constexpr int C = kThreads / T;
  constexpr int smem = bwd_smem_bytes<T>();
  static std::atomic<uint64_t> set_on{0};
  cudaError_t e = allow_dynamic_smem(
      reinterpret_cast<const void*>(&ssm_scan_bwd_kernel<XT, T>), smem,
      set_on);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Di + C - 1) / C, B);
  ssm_scan_bwd_kernel<XT, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(dt), static_cast<const XT*>(x),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(a), static_cast<const float*>(dy),
      static_cast<const float*>(dh), static_cast<float*>(ckpt),
      static_cast<float*>(part_bc), static_cast<float*>(part_a),
      static_cast<float*>(ddt), static_cast<XT*>(dx), S, Di);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int N = T * kGroup;
  const size_t items = (size_t)B * S * 2 * N + (size_t)Di * N;
  const int blocks =
      static_cast<int>(items / 256 + 1 < 132 * 16 ? items / 256 + 1 : 132 * 16);
  ssm_scan_bwd_reduce<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_a),
      static_cast<float*>(db), static_cast<float*>(dc),
      static_cast<float*>(da), B, S, N, static_cast<int>(grid.x), Di);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int dispatch_bwd(const void* dt, const void* x, const void* b, const void* c,
                 const void* a, const void* dy, const void* dh, void* ckpt,
                 void* part_bc, void* part_a, void* ddt, void* dx, void* db,
                 void* dc, void* da, int B, int S, int Di, int N,
                 cudaStream_t st) {
#define REPRO_SSM_BWD(T_)                                                   \
  case T_:                                                                 \
    return launch_bwd<XT, T_>(dt, x, b, c, a, dy, dh, ckpt, part_bc, part_a, \
                              ddt, dx, db, dc, da, B, S, Di, st);
  switch (N / kGroup) {
    REPRO_SSM_BWD(1)
    REPRO_SSM_BWD(2)
    REPRO_SSM_BWD(4)
    REPRO_SSM_BWD(8)
    REPRO_SSM_BWD(16)
    REPRO_SSM_BWD(32)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_SSM_BWD
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

// The backward.  dt, x, b, c, a as the forward takes them; dy: [B, S, Di]
// float32; dh: [B, Di, N] float32; ckpt: [B, ceil(S / 16), Di, N] float32
// scratch; part_bc: [B, S, ceil(Di / C), 2N] float32 scratch (C = 128 /
// (N / 4) channels a CTA); part_a: [B, Di, N] float32 scratch; ddt: [B, S,
// Di] float32; dx: [B, S, Di] in x's dtype; db, dc: [B, S, N] float32; da:
// [Di, N] float32; all contiguous.  Launches the scan's reverse, then the
// ordered reduce of the partials.
extern "C" int ssm_scan_bwd(const void* dt, const void* x, const void* b,
                            const void* c, const void* a, const void* dy,
                            const void* dh, void* ckpt, void* part_bc,
                            void* part_a, void* ddt, void* dx, void* db,
                            void* dc, void* da, int x_dtype, int B, int S,
                            int Di, int N, void* stream) {
  if (B < 1 || S < 1 || Di < 1 || B > 65535 || N % kGroup)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return dispatch_bwd<float>(dt, x, b, c, a, dy, dh, ckpt, part_bc, part_a,
                               ddt, dx, db, dc, da, B, S, Di, N, st);
  if (x_dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(dt, x, b, c, a, dy, dh, ckpt, part_bc,
                                       part_a, ddt, dx, db, dc, da, B, S, Di,
                                       N, st);
  return cudaErrorInvalidValue;
}
