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
// are shared by the row's channels.  What limits it in practice is the
// issue rate: expf is 8 instructions (one of them MUFU.EX2), and with the
// discretization, the update and the readout a live (position, state)
// takes ~16 float32 lane instructions (launch/timing.py `issue_floor_ms`:
// 0.15 ms at that shape, 2300 positions live) besides the shared-memory
// traffic that feeds them.
//
// Design: G consecutive states of a channel a thread (the wrapper's plan,
// `states_per_thread`: at falcon-mamba's N 16, 2 for a prefill's one row, 4
// where the grid keeps 256 CTAs), N / G threads a channel, 256 threads a CTA
// (at G 2: 32 channels a CTA, 256 CTAs at B = 1).  The row's b and c and the
// CTA's dt and x are staged a tile of 32 positions at a time by 16-byte
// cp.async copies into a two-stage ring in shared memory, row-major as in
// memory: the next tile's copies run while the current tile computes, and
// nothing is staged through registers (the compiler had sunk register-staged
// loads to their use, so each tile waited on device memory).  A tile wholly
// past the row's length stages c alone.  The tile's positions are unrolled; the
// loop is split at the row's length: a tile wholly before it runs without
// tests, one wholly past it only reads out, the one tile that holds it tests
// each position.  The readout is one pairwise tree over the N states,
// neighbours first (`readout` in kernels/ssm_scan.py): a thread sums its G
// states' products by the tree and writes the partial to shared memory; after
// the tile, the CTA sums each (channel, 4 positions)'s N / G partials by the
// rest of the tree and stores y coalesced, so any G gives the same bits.  Every
// product and sum is an explicit __fmul_rn / __fadd_rn (no contraction into a
// fused multiply-add) and the exponential is expf (no fast math), so each
// position is bit for bit the plain loop's float32 operators.  A position at or
// past its row's length keeps h (its y reads the kept h), so a right-padded
// prompt leaves the state of its last real token.  Given a checkpoint buffer
// (training's forward), the kernel also writes h at the start of every kChunk
// positions, [B, ceil(S / kChunk), Di, N] float32, for the backward.  Rows that
// are not 16-byte aligned (Di not a multiple of 8, or an operand off a 16-byte
// boundary) are staged by element copies instead.
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
// falcon-mamba's widths).  The checkpoints (h every kChunk positions) come from
// the forward kernel (for a call without them the wrapper launches it
// first).  The kernel walks the chunks in reverse, staged by the forward's
// cp.async ring (the chunk's checkpoint too): it recomputes a chunk's h from
// its checkpoint into registers (never by dividing by a_bar, which is unstable
// near 0), keeping each position's a_bar beside it, so expf runs once a
// (position, state), and runs the chunk's positions downward, 4 at a time.  A
// channel's N / G threads share a warp (N / G <= 32): dx and ddt sum its
// states by the readout's tree, in the thread and then by a reduce-scatter of
// shuffles over its lanes (lowest lane bit first), and the lanes holding the
// sums store them.  db and dc sum the CTA's channels by a pairwise tree
// (neighbours first): the warp's channels by a reduce-scatter of shuffles,
// then the CTA's 8 warps through shared memory.  db and dc span CTAs and da
// spans rows: each CTA writes its partial per (row, position), and a second
// kernel sums the partials over the CTAs, and da's per-row partials over the
// rows, in a fixed order.  No atomics: the gradient is the same bit for bit
// from run to run, and bit for bit `ssm_scan_bwd_plain`, which sums in the
// same orders (`_state_sum`, `_channel_sum`).
//
// Bound: dt, x, dy read and ddt, dx written a position and channel, b, c,
// db, dc a position, a, dh and da once: ~(4 + 2 + 4 + 4 + 2) bytes x B x
// S x Di in bf16, 0.08 ms at [4, 512, 8192, 16] at 3.35 TB/s; 27 float32
// operations a (position, channel, state) for the forward h and the
// adjoint take 0.11 ms at 67 TFLOP/s, so operations bound it.  The
// checkpoints (1 / kChunk of h) and the partials (2N floats a position and
// CTA) add traffic the bound does not count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // a CTA, forward and backward
constexpr int kTile = 32;      // positions the forward stages at a time
constexpr int kChunk = 16;     // the checkpoint stride: the backward's chunk
constexpr int kPad = 4;        // floats after each shared row (banks)
enum Mode { kLive, kMixed, kDead };  // a tile's positions against the length

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ void put(float4& v, int i, float f) {
  if (i == 0) v.x = f;
  else if (i == 1) v.y = f;
  else if (i == 2) v.z = f;
  else v.w = f;
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 add4(float4 u, float4 v) {
  return make_float4(__fadd_rn(u.x, v.x), __fadd_rn(u.y, v.y),
                     __fadd_rn(u.z, v.z), __fadd_rn(u.w, v.w));
}

// The pairwise tree, neighbours first, over v(base) .. v(base + n - 1)
// (n a power of two): the sum of its two halves' trees.
template <int n, typename F>
__device__ __forceinline__ float4 tree4(const F& v, int base = 0) {
  if constexpr (n == 1) {
    return v(base);
  } else {
    return add4(tree4<n / 2>(v, base), tree4<n / 2>(v, base + n / 2));
  }
}
template <int n>
__device__ __forceinline__ float tree1(const float* v, int base = 0) {
  if constexpr (n == 1) {
    return v[base];
  } else {
    return __fadd_rn(tree1<n / 2>(v, base), tree1<n / 2>(v, base + n / 2));
  }
}

// A pairwise tree, neighbours first, of each of a lane's V values over
// the lanes whose index bits OFF .. END / 2 differ (lowest bit first), by
// shuffles, scattering the sums: at the stage of bit `off` a lane whose
// bit is set keeps the upper half of its values and sends the lower half,
// the other keeps the lower half.  Once a lane has one value left, the
// later stages add it to its partner's (both keep the sum).  Each sum is
// the same bit for bit in every lane that holds it (a + b == b + a).
template <int V, int OFF, int END>
__device__ __forceinline__ void rscatter(float* v, int lane) {
  if constexpr (OFF < END) {
    if constexpr (V > 1) {
      constexpr int H = V / 2;
      const bool up = lane & OFF;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float send = up ? v[k] : v[k + H];
        const float keep = up ? v[k + H] : v[k];
        v[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, OFF));
      }
      rscatter<H, OFF * 2, END>(v, lane);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], OFF));
      rscatter<1, OFF * 2, END>(v, lane);
    }
  }
}
// the values a lane keeps after rscatter<V, OFF, END>
template <int V, int OFF, int END>
__host__ __device__ constexpr int scatter_kept() {
  int vc = V;
  for (int off = OFF; off < END; off <<= 1)
    if (vc > 1) vc >>= 1;
  return vc;
}
// the index among the V of a lane's first kept value; `owner`: the lane is
// the one of the lanes holding the same sums that stores them
template <int V, int OFF, int END>
__device__ __forceinline__ int scatter_base(int lane, bool& owner) {
  int base = 0, vc = V;
  owner = true;
#pragma unroll
  for (int off = OFF; off < END; off <<= 1) {
    if (vc > 1) {
      vc >>= 1;
      if (lane & off) base += vc;
    } else if (lane & off) {
      owner = false;
    }
  }
  return base;
}

// element i of a staged row of x (bfloat16 or float32, as staged)
__device__ __forceinline__ float x_at(const float* row, int bf16, int i) {
  return bf16 ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(row)[i])
              : row[i];
}
// G consecutive floats from shared memory, by one vector load
template <int G>
__device__ __forceinline__ void ldv(const float* p, float* v) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int k = 0; k < G; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
    }
  } else if constexpr (G == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = p[g];
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ROWS rows of ROW_BYTES bytes from global memory (row r at src + r *
// stride bytes) into shared memory (row r at dst + r * ROW_BYTES): rows
// past `nrows` and bytes of a row past `valid` are zero-filled.  ASYNC: by
// 16-byte cp.async copies (every row and address a multiple of 16 bytes);
// else element by element (ES bytes, 2 or 4), synchronously.  The CTA's
// threads share the copies.
template <int ROWS, int ROW_BYTES, bool ASYNC, int ES>
__device__ __forceinline__ void stage_rows(float* dst_f, const void* src_v,
                                           size_t stride, int nrows,
                                           int valid) {
  constexpr int UNIT = ASYNC ? 16 : ES;
  constexpr int PER = ROW_BYTES / UNIT;
  constexpr int TOTAL = ROWS * PER;
  char* dst = reinterpret_cast<char*>(dst_f);
  const char* src = static_cast<const char*>(src_v);
#pragma unroll
  for (int k = 0; k < (TOTAL + kThreads - 1) / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (TOTAL % kThreads != 0 && i >= TOTAL) break;
    const int r = i / PER, col = (i % PER) * UNIT;
    const bool ok = r < nrows && col < valid;
    const char* from = ok ? src + r * stride + col : src;
    char* to = dst + r * ROW_BYTES + col;
    if constexpr (ASYNC) {
      const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(to));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                   "l"(from), "r"(ok ? 16 : 0)
                   : "memory");
    } else if constexpr (ES == 4) {
      *reinterpret_cast<float*>(to) =
          ok ? *reinterpret_cast<const float*>(from) : 0.f;
    } else {
      *reinterpret_cast<uint16_t*>(to) =
          ok ? *reinterpret_cast<const uint16_t*>(from) : uint16_t{0};
    }
  }
}
// a float32 block, and one of x (bfloat16 or float32), by the async or
// the synchronous copy
template <int ROWS, int ROW_FLOATS>
__device__ __forceinline__ void stage_f32(bool async, float* dst,
                                          const float* src, size_t stride,
                                          int nrows, int valid) {
  if constexpr (ROW_FLOATS * 4 % 16 == 0) {
    if (async) {
      stage_rows<ROWS, ROW_FLOATS * 4, true, 4>(dst, src, stride, nrows,
                                                valid);
      return;
    }
  }
  stage_rows<ROWS, ROW_FLOATS * 4, false, 4>(dst, src, stride, nrows, valid);
}
template <int ROWS, int C>
__device__ __forceinline__ void stage_x(bool async, int bf16, float* dst,
                                        const void* x, size_t at, int Di,
                                        int nrows, int vc) {
  if (bf16) {
    const auto* src = static_cast<const __nv_bfloat16*>(x) + at;
    if constexpr (C * 2 % 16 == 0) {
      if (async) {
        stage_rows<ROWS, C * 2, true, 2>(dst, src, (size_t)Di * 2, nrows,
                                         vc * 2);
        return;
      }
    }
    stage_rows<ROWS, C * 2, false, 2>(dst, src, (size_t)Di * 2, nrows,
                                      vc * 2);
  } else {
    stage_f32<ROWS, C>(async, dst, static_cast<const float*>(x) + at,
                       (size_t)Di * 4, nrows, vc * 4);
  }
}

__device__ __forceinline__ void store_x(void* x, int bf16, size_t at,
                                        float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(x)[at] = __float2bfloat16(v);
  else
    static_cast<float*>(x)[at] = v;
}

// Raise `kern`'s dynamic shared memory limit and prefer the largest
// shared-memory carveout, once per device (`set_on`: a bit per device id).
inline cudaError_t prepare(const void* kern, int bytes,
                           std::atomic<uint64_t>& set_on) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit != 0 && (set_on.load(std::memory_order_relaxed) & bit)) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) set_on.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// The forward's shape at N states, G a thread.
template <int N, int G>
struct Fwd {
  static constexpr int T = N / G;            // threads of a channel
  static constexpr int C = kThreads / T;     // channels of a CTA
  static constexpr int R = kTile + kPad;     // a row of partials
  static constexpr int PART = T * R + kPad;  // a channel's readout partials
  // a stage of the ring: b and c [kTile][N], dt and x [kTile][C] (x as
  // stored, at most 4 bytes an element)
  static constexpr int STAGE = kTile * (2 * N + 2 * C);
  // two stages, then the partials [C][PART]
  static constexpr int kFloats = 2 * STAGE + C * PART;
};

// CTAs an SM the register budget is set for: two (128 registers a
// thread; a bound of 64 for more warps made the kernels spill and run
// slower, PERF.md), one at the widest N (the forward's 8 states a thread,
// the backward's 2 or 4), where 128 registers spilled
template <int N>
constexpr int fwd_ctas() { return N >= 128 ? 1 : 2; }
template <int N>
constexpr int bwd_ctas() { return N >= 64 ? 1 : 2; }

template <int N, int G>
__global__ void __launch_bounds__(kThreads, fwd_ctas<N>())
    ssm_scan_kernel(const float* __restrict__ dt, const void* __restrict__ x,
                    int x_bf16, const float* __restrict__ bm,
                    const float* __restrict__ cm,
                    const float* __restrict__ a,
                    const int* __restrict__ lengths, float* __restrict__ y,
                    float* __restrict__ h_last, float* __restrict__ ckpt,
                    int S, int Di, int aligned) {
  using P = Fwd<N, G>;
  constexpr int T = P::T, C = P::C, R = P::R;
  extern __shared__ float4 smem4[];
  float* s_ring = reinterpret_cast<float*>(smem4);
  float* s_part = s_ring + 2 * P::STAGE;

  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * C;
  const int cc = tid / T;                 // this thread's channel in the CTA
  const int j = tid % T;                  // its run of G states
  const int ch = c0 + cc;
  const bool live = ch < Di;
  int len = S;
  if (lengths != nullptr) len = min(max(lengths[row], 0), S);
  const int nk = (S + kChunk - 1) / kChunk;
  const bool async = aligned;

  float ar[G], h[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    ar[g] = live ? a[(size_t)ch * N + j * G + g] : 0.f;
    h[g] = 0.f;
  }
  const size_t dx_row = (size_t)row * S * Di;

  // tile k's c, and where the tile has live positions b, dt and x, into
  // stage k % 2 (row-major, as in memory)
  auto issue = [&](int k) {
    float* st = s_ring + (k & 1) * P::STAGE;
    const int t0 = k * kTile;
    const int nr = min(S - t0, kTile);
    const size_t r0 = (size_t)row * S + t0;
    const int vc = min(Di - c0, C);
    stage_f32<kTile, N>(async, st + kTile * N, cm + r0 * N, N * 4, nr, N * 4);
    if (t0 >= len) return;
    stage_f32<kTile, N>(async, st, bm + r0 * N, N * 4, nr, N * 4);
    stage_f32<kTile, C>(async, st + 2 * kTile * N, dt + r0 * Di + c0,
                        (size_t)Di * 4, nr, vc * 4);
    stage_x<kTile, C>(async, x_bf16, st + 2 * kTile * N + kTile * C, x,
                      r0 * Di + c0, Di, nr, vc);
  };

  float* sp = s_part + cc * P::PART + j * R;

  // the tile at t0 from stage `st` in mode M (positions p < nlive update h
  // in kMixed), its groups of 4 up to position `nvalid`
  auto run = [&](auto mode, int t0, int nlive, int nvalid, const float* st) {
    constexpr int M = decltype(mode)::value;
    const float* sb = st + j * G;
    const float* sc = st + kTile * N + j * G;
    const float* sd = st + 2 * kTile * N + cc;
    const float* sx = st + 2 * kTile * N + kTile * C;
    // the whole tile unrolled at falcon-mamba's N 16 (G 2 and 4, the
    // splits measured), 2 groups at a time elsewhere: whole tiles spilled
    // registers at G 1 and at several other (N, G)
#pragma unroll(N == 16 && G >= 2 ? kTile / 4 : 2)
    for (int q = 0; q < kTile / 4; ++q) {
      if (4 * q >= nvalid) break;
      float4 out;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = 4 * q + i;
        if (p % kChunk == 0 && ckpt != nullptr && t0 + p < S && live) {
          float* dst = ckpt + (((size_t)row * nk + (t0 + p) / kChunk) * Di +
                               ch) * N + j * G;
#pragma unroll
          for (int g = 0; g < G; ++g) dst[g] = h[g];
        }
        if (M == kLive || (M == kMixed && p < nlive)) {
          const float d = sd[p * C];
          const float xv = x_at(sx, x_bf16, p * C + cc);
          float bv[G];
          ldv<G>(sb + p * N, bv);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float a_bar = expf(__fmul_rn(d, ar[g]));
            const float bx = __fmul_rn(__fmul_rn(d, bv[g]), xv);
            h[g] = __fadd_rn(__fmul_rn(a_bar, h[g]), bx);
          }
        }
        float cv[G], prod[G];
        ldv<G>(sc + p * N, cv);
#pragma unroll
        for (int g = 0; g < G; ++g) prod[g] = __fmul_rn(h[g], cv[g]);
        put(out, i, tree1<G>(prod));
      }
      st4(sp + 4 * q, out);
    }
  };

  const int nt = (S + kTile - 1) / kTile;
  issue(0);
  cp_commit();
  for (int k = 0; k < nt; ++k) {
    const int t0 = k * kTile;
    cp_wait_all();
    __syncthreads();          // tile k staged; the last tile is read out
    if (k + 1 < nt) issue(k + 1);
    cp_commit();
    const float* st = s_ring + (k & 1) * P::STAGE;
    const int nlive = min(max(len - t0, 0), kTile);
    const int nvalid = min(S - t0, kTile);
    if (nlive == kTile)
      run(std::integral_constant<int, kLive>{}, t0, nlive, nvalid, st);
    else if (nlive == 0)
      run(std::integral_constant<int, kDead>{}, t0, nlive, nvalid, st);
    else
      run(std::integral_constant<int, kMixed>{}, t0, nlive, nvalid, st);
    __syncthreads();
    // the readout: each (channel, 4 positions)'s T partials by the tree
    for (int job = tid; job < C * ((nvalid + 3) / 4); job += kThreads) {
      const int jc = job % C, q = job / C;
      const float* src = s_part + jc * P::PART + 4 * q;
      const float4 v = tree4<T>([&](int k2) { return ld4(src + k2 * R); });
      if (c0 + jc < Di) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + 4 * q + i;
          if (t < S) y[dx_row + (size_t)t * Di + c0 + jc] = get(v, i);
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      h_last[((size_t)row * Di + ch) * N + j * G + g] = h[g];
  }
}

template <int N, int G>
int launch_scan(const void* dt, const void* x, int x_bf16, const void* b,
                const void* c, const void* a, const void* lengths, void* y,
                void* h_last, void* ckpt, int B, int S, int Di, int aligned,
                cudaStream_t stream) {
  using P = Fwd<N, G>;
  constexpr int smem = P::kFloats * 4;
  static std::atomic<uint64_t> set_on{0};
  cudaError_t e = prepare(
      reinterpret_cast<const void*>(&ssm_scan_kernel<N, G>), smem, set_on);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Di + P::C - 1) / P::C, B);
  ssm_scan_kernel<N, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(dt), x, x_bf16, static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(a),
      static_cast<const int*>(lengths), static_cast<float*>(y),
      static_cast<float*>(h_last), static_cast<float*>(ckpt), S, Di,
      aligned);
  return static_cast<int>(cudaGetLastError());
}

// The backward's shape at N states, G a thread (N / G <= 32: a channel's
// threads share a warp).
template <int N, int G>
struct Bwd {
  static constexpr int T = N / G;            // threads of a channel
  static constexpr int C = kThreads / T;     // channels of a CTA
  static constexpr int W = kThreads / 32;    // warps of a CTA
  // a stage of the ring: b and c [kChunk][N], dt, x and dy [kChunk][C],
  // the chunk's checkpoint [C][N]
  static constexpr int STAGE = kChunk * (2 * N + 3 * C) + C * N;
  // two stages, then the warps' partials of db and dc for 4 positions,
  // two sets [2][W][4 x 2 x N]
  static constexpr int kFloats = 2 * STAGE + 2 * W * 8 * N;
  // a_bar kept from the chunk's recompute (2 x kChunk x G registers with
  // h), or recomputed in the reverse walk where G is larger
  static constexpr bool KEEP = G <= 2;
  static_assert(T <= 32, "a channel's threads share a warp");
};

template <int N, int G>
__global__ void __launch_bounds__(kThreads, bwd_ctas<N>())
    ssm_scan_bwd_kernel(const float* __restrict__ dt,
                        const void* __restrict__ x, int x_bf16,
                        const float* __restrict__ bm,
                        const float* __restrict__ cm,
                        const float* __restrict__ a,
                        const float* __restrict__ dy,
                        const float* __restrict__ dh,
                        const float* __restrict__ ckpt,
                        float* __restrict__ part_bc,
                        float* __restrict__ part_a, float* __restrict__ ddt,
                        void* __restrict__ dx, int S, int Di, int aligned) {
  using P = Bwd<N, G>;
  constexpr int T = P::T, C = P::C, W = P::W;
  extern __shared__ float4 smem4[];
  float* s_ring = reinterpret_cast<float*>(smem4);
  float* s_gc = s_ring + 2 * P::STAGE;             // [2][W][8N]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y;
  const int c0 = blockIdx.x * C;
  const int cc = tid / T;
  const int j = tid % T;
  const int ch = c0 + cc;
  const bool live = ch < Di;
  const int nk = (S + kChunk - 1) / kChunk;
  const bool async = aligned;

  float ar[G];
#pragma unroll
  for (int g = 0; g < G; ++g)
    ar[g] = live ? a[(size_t)ch * N + j * G + g] : 0.f;
  const size_t dx_row = (size_t)row * S * Di;
  const size_t ck_row = (size_t)row * nk * Di;     // chunk k at + k * Di

  // chunk k's b, c, dt, x, dy and its checkpoint into stage k % 2,
  // row-major as in memory
  auto issue = [&](int k) {
    float* st = s_ring + (k & 1) * P::STAGE;
    const int t0 = k * kChunk;
    const int nr = min(S - t0, kChunk);
    const size_t r0 = (size_t)row * S + t0;
    const int vc = min(Di - c0, C);
    float* sd = st + 2 * kChunk * N;
    stage_f32<kChunk, N>(async, st, bm + r0 * N, N * 4, nr, N * 4);
    stage_f32<kChunk, C>(async, sd, dt + r0 * Di + c0, (size_t)Di * 4, nr,
                         vc * 4);
    stage_x<kChunk, C>(async, x_bf16, sd + kChunk * C, x, r0 * Di + c0, Di,
                       nr, vc);
    stage_f32<kChunk, N>(async, st + kChunk * N, cm + r0 * N, N * 4, nr,
                         N * 4);
    stage_f32<kChunk, C>(async, sd + 2 * kChunk * C, dy + r0 * Di + c0,
                         (size_t)Di * 4, nr, vc * 4);
    stage_f32<1, C * N>(async, sd + 3 * kChunk * C,
                        ckpt + (ck_row + (size_t)k * Di + c0) * N, 0, 1,
                        vc * N * 4);
  };
  // the stage's rows for this thread
  auto rows = [&](int k, const float*& sb, const float*& sc,
                  const float*& sd, const float*& sx, const float*& sy,
                  const float*& sk) {
    const float* st = s_ring + (k & 1) * P::STAGE;
    sb = st + j * G;
    sc = st + kChunk * N + j * G;
    sd = st + 2 * kChunk * N + cc;
    sx = st + 2 * kChunk * N + kChunk * C;
    sy = st + 2 * kChunk * N + 2 * kChunk * C + cc;
    sk = st + 2 * kChunk * N + 3 * kChunk * C + cc * N + j * G;
  };

  // the chunks in reverse, each recomputed from its checkpoint
  float carry[G], da_acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    carry[g] = live ? dh[((size_t)row * Di + ch) * N + j * G + g] : 0.f;
    da_acc[g] = 0.f;
  }
  issue(nk - 1);
  cp_commit();
  for (int k = nk - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int pend = S - t0 < kChunk ? S - t0 : kChunk;
    cp_wait_all();
    __syncthreads();              // chunk k staged; the last one is read
    if (k > 0) issue(k - 1);
    cp_commit();
    const float *sb, *sc, *sd, *sx, *sy, *sk;
    rows(k, sb, sc, sd, sx, sy, sk);
    float hs[kChunk + 1][G], ab[kChunk][G];       // h before p, a_bar at p
    ldv<G>(sk, hs[0]);
#pragma unroll
    for (int p = 0; p < kChunk; ++p) {
      if (p < pend) {
        const float d = sd[p * C], xv = x_at(sx, x_bf16, p * C + cc);
        float bv[G];
        ldv<G>(sb + p * N, bv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float a_bar = expf(__fmul_rn(d, ar[g]));
          if constexpr (P::KEEP) ab[p][g] = a_bar;
          const float bx = __fmul_rn(__fmul_rn(d, bv[g]), xv);
          hs[p + 1][g] = __fadd_rn(__fmul_rn(a_bar, hs[p][g]), bx);
        }
      }
    }
    // the chunk downward, a group of 4 positions at a time
#pragma unroll
    for (int q = kChunk / 4 - 1; q >= 0; --q) {
      const int pq = 4 * q;
      if (pq >= pend) continue;
      // va: {dx, ddt} x 4 positions, a thread's states summed; vb: {db,
      // dc} x G states x 4 positions
      float va[8], vb[8 * G];
#pragma unroll
      for (int i = 3; i >= 0; --i) {
        const int p = pq + i;
        float tdx[G], tddt[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          tdx[g] = tddt[g] = 0.f;
          vb[g * 4 + i] = vb[(G + g) * 4 + i] = 0.f;
        }
        if (p < pend) {
          const float d = sd[p * C], dyv = sy[p * C];
          const float xv = x_at(sx, x_bf16, p * C + cc);
          float bv[G], cv[G];
          ldv<G>(sb + p * N, bv);
          ldv<G>(sc + p * N, cv);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float a_bar;
            if constexpr (P::KEEP)
              a_bar = ab[p][g];
            else
              a_bar = expf(__fmul_rn(d, ar[g]));
            const float hp = hs[p][g];
            const float gh = __fadd_rn(__fmul_rn(dyv, cv[g]), carry[g]);
            carry[g] = __fmul_rn(a_bar, gh);
            const float u = __fmul_rn(gh, d);
            tdx[g] = __fmul_rn(u, bv[g]);
            tddt[g] = __fmul_rn(
                gh, __fadd_rn(__fmul_rn(__fmul_rn(ar[g], a_bar), hp),
                              __fmul_rn(bv[g], xv)));
            if (live) {
              vb[g * 4 + i] = __fmul_rn(u, xv);
              vb[(G + g) * 4 + i] = __fmul_rn(hs[p + 1][g], dyv);
            }
            da_acc[g] = __fadd_rn(da_acc[g],
                                  __fmul_rn(__fmul_rn(u, a_bar), hp));
          }
        }
        va[i] = tree1<G>(tdx);
        va[4 + i] = tree1<G>(tddt);
      }
      // dx, ddt: the channel's T lanes by the readout's tree, stored by
      // the lanes that hold the sums
      rscatter<8, 1, T>(va, lane);
      {
        bool owner;
        const int base = scatter_base<8, 1, T>(lane, owner);
        if (owner && live) {
#pragma unroll
          for (int kk = 0; kk < scatter_kept<8, 1, T>(); ++kk) {
            const int f = base + kk, p = pq + (f & 3);
            if (p < pend) {
              const size_t at = dx_row + (size_t)(t0 + p) * Di + ch;
              if (f < 4)
                store_x(dx, x_bf16, at, va[kk]);
              else
                ddt[at] = va[kk];
            }
          }
        }
      }
      // db, dc: the warp's channels by the tree (shuffles), then the CTA's
      // warps by the tree (shared memory): the CTA's partial
      rscatter<8 * G, T, 32>(vb, lane);
      float* gb = s_gc + ((q & 1) * W + warp) * 8 * N;
      {
        bool owner;
        const int base = scatter_base<8 * G, T, 32>(lane, owner);
        if (owner) {
#pragma unroll
          for (int kk = 0; kk < scatter_kept<8 * G, T, 32>(); ++kk) {
            const int f = base + kk, i = f & 3, g = (f >> 2) % G;
            const int w = (f >> 2) / G;
            gb[(i * 2 + w) * N + j * G + g] = vb[kk];
          }
        }
      }
      __syncthreads();
      for (int e = tid; e < 8 * N; e += kThreads) {
        const float* src = s_gc + (q & 1) * W * 8 * N + e;
        float wv[W];
#pragma unroll
        for (int w = 0; w < W; ++w) wv[w] = src[w * 8 * N];
        const int i = e / (2 * N), p = pq + i;
        if (p < pend)
          part_bc[(((size_t)row * S + t0 + p) * gridDim.x + blockIdx.x) * 2 *
                      N + e % (2 * N)] = tree1<W>(wv);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      part_a[((size_t)row * Di + ch) * N + j * G + g] = da_acc[g];
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
#pragma unroll 8
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

template <int N, int G>
int launch_bwd(const void* dt, const void* x, int x_bf16, const void* b,
               const void* c, const void* a, const void* dy, const void* dh,
               const void* ckpt, void* part_bc, void* part_a,
               void* ddt, void* dx, void* db, void* dc, void* da, int B,
               int S, int Di, int aligned, cudaStream_t stream) {
  using P = Bwd<N, G>;
  constexpr int smem = P::kFloats * 4;
  static std::atomic<uint64_t> set_on{0};
  cudaError_t e = prepare(
      reinterpret_cast<const void*>(&ssm_scan_bwd_kernel<N, G>), smem,
      set_on);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Di + P::C - 1) / P::C, B);
  ssm_scan_bwd_kernel<N, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(dt), x, x_bf16, static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(a),
      static_cast<const float*>(dy), static_cast<const float*>(dh),
      static_cast<const float*>(ckpt), static_cast<float*>(part_bc),
      static_cast<float*>(part_a), static_cast<float*>(ddt), dx, S, Di,
      aligned);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t items = (size_t)B * S * 2 * N + (size_t)Di * N;
  const int blocks =
      static_cast<int>(items / 256 + 1 < 132 * 16 ? items / 256 + 1 : 132 * 16);
  ssm_scan_bwd_reduce<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_a),
      static_cast<float*>(db), static_cast<float*>(dc),
      static_cast<float*>(da), B, S, N, static_cast<int>(grid.x), Di);
  return static_cast<int>(cudaGetLastError());
}

// every pointer 16-byte aligned (the kernels' cp.async staging)
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace

// The (N, G) pairs built (kernels/ssm_scan.py `BUILT`): the forward at
// N / G <= 16 threads a channel (more spilled registers), and
// falcon-mamba's N 16 at 2 and 4; the backward, whose channel must sit in
// one warp (N / G <= 32), at max(1, N / 32), falcon-mamba's N 16 at 2.
#define REPRO_SSM_FWD_PAIRS(X) X(4, 1) X(8, 2) X(16, 2) X(16, 4) X(32, 2) \
  X(64, 4) X(128, 8)
#define REPRO_SSM_BWD_PAIRS(X) X(4, 1) X(8, 1) X(16, 2) X(32, 1) X(64, 2) \
  X(128, 4)

// dt: [B, S, Di] float32; x: [B, S, Di] float32 (x_dtype 0) or bfloat16
// (1); b, c: [B, S, N] float32; a: [Di, N] float32; lengths: [B] int32
// (null: every row S long); y: [B, S, Di] float32; h_last: [B, Di, N]
// float32; ckpt: [B, ceil(S / 16), Di, N] float32, h at the start of every
// 16 positions (null: not written); all contiguous.  G states a thread, N
// / G threads a channel, 256 a CTA: grid (ceil(Di / (256 G / N)), B).
extern "C" int ssm_scan(const void* dt, const void* x, const void* b,
                        const void* c, const void* a, const void* lengths,
                        void* y, void* h_last, void* ckpt, int x_dtype,
                        int B, int S, int Di, int N, int G, void* stream) {
  if (B < 1 || S < 1 || Di < 1 || B > 65535 || (x_dtype != 0 && x_dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int aligned = Di % 8 == 0 && aligned16({dt, x, b, c});
#define REPRO_SSM_FWD(N_, G_)                                               \
  if (N == N_ && G == G_)                                                  \
    return launch_scan<N_, G_>(dt, x, x_dtype, b, c, a, lengths, y, h_last, \
                               ckpt, B, S, Di, aligned, st);
  REPRO_SSM_FWD_PAIRS(REPRO_SSM_FWD)
#undef REPRO_SSM_FWD
  return cudaErrorInvalidValue;
}

// The backward.  dt, x, b, c, a as the forward takes them; dy: [B, S, Di]
// float32; dh: [B, Di, N] float32; ckpt: [B, ceil(S / 16), Di, N] float32,
// the forward kernel's checkpoints; part_bc: [B, S, ceil(Di / C), 2N]
// float32 scratch (C = 256 G / N channels a CTA); part_a: [B, Di, N]
// float32 scratch; ddt: [B, S, Di] float32; dx: [B, S, Di] in x's dtype;
// db, dc: [B, S, N] float32; da: [Di, N] float32; all contiguous.
// Launches the scan's reverse, then the ordered reduce of the partials.
extern "C" int ssm_scan_bwd(const void* dt, const void* x, const void* b,
                            const void* c, const void* a, const void* dy,
                            const void* dh, const void* ckpt, void* part_bc,
                            void* part_a, void* ddt, void* dx, void* db,
                            void* dc, void* da, int x_dtype, int B, int S,
                            int Di, int N, int G, void* stream) {
  if (B < 1 || S < 1 || Di < 1 || B > 65535 || (x_dtype != 0 && x_dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int aligned = Di % 8 == 0 && aligned16({dt, x, b, c, dy, ckpt});
#define REPRO_SSM_BWD(N_, G_)                                                \
  if (N == N_ && G == G_)                                                  \
    return launch_bwd<N_, G_>(dt, x, x_dtype, b, c, a, dy, dh, ckpt,         \
                              part_bc, part_a, ddt, dx, db, dc, da, B, S,    \
                              Di, aligned, st);
  REPRO_SSM_BWD_PAIRS(REPRO_SSM_BWD)
#undef REPRO_SSM_BWD
  return cudaErrorInvalidValue;
}

// The dynamic shared memory of the kernel built for (N, G), in bytes: the
// forward's (backward 0) or the backward's (1); 0 where none is built.
extern "C" int ssm_scan_smem_bytes(int N, int G, int backward) {
#define REPRO_SSM_SMEM(N_, G_, S_) \
  if (N == N_ && G == G_) return S_<N_, G_>::kFloats * 4;
#define REPRO_SSM_FWD_SMEM(N_, G_) REPRO_SSM_SMEM(N_, G_, Fwd)
#define REPRO_SSM_BWD_SMEM(N_, G_) REPRO_SSM_SMEM(N_, G_, Bwd)
  if (backward) {
    REPRO_SSM_BWD_PAIRS(REPRO_SSM_BWD_SMEM)
  } else {
    REPRO_SSM_FWD_PAIRS(REPRO_SSM_FWD_SMEM)
  }
#undef REPRO_SSM_BWD_SMEM
#undef REPRO_SSM_FWD_SMEM
#undef REPRO_SSM_SMEM
  return 0;
}
