// Paged attention walk shared by csrc/paged_attention.cu (one query lane
// per sequence, the decode step) and csrc/chunked_prefill.cu (W query lanes
// per sequence, the mixed step).  Decode is the W = 1 case of the chunk walk.
//
// Inputs, in the pool layout as stored (no padding, no transposes):
//   q       [B, W, H, HD]       query lanes; lane l sits at position s0 + l
//   k/v     [NB, BS, KV, HD]    the shared block pool (block 0 = null block),
//                               16-byte aligned (rows are read as vectors)
//   tables  [B, NBLK] int32     physical block of each logical block
//   start   [B] int32           s0 = start[b] + len_offset (len_offset = -1
//                               turns the decode step's lengths into s0)
// Lane l of sequence b sees positions <= min(s0 + l, NBLK * BS - 1).
//
// Design (see the two .cu files for what each replaces and what bounds it):
// one CTA per (sequence, KV head) takes all W * n_rep query rows of that
// head group (n_rep = H / KV, GQA) and walks the sequence's own block table
// itself, TILE positions (whole blocks) at a time, so every K/V row the CTA
// needs is read from device memory once for all its query rows.  Per tile,
// all threads compute the scores, one warp per row then runs the online
// softmax update once per pool block in order, as the reference does, and
// all threads fold the probabilities into the accumulators.  The walk
// stops at the last position any lane of the CTA can see: table entries past
// a sequence's length point at the null block, which dead lanes write
// garbage into, and are never read.  Inside a tile each row uses only the
// positions it can see, so a masked position's V row never enters a sum.
// Softmax statistics (running max m, normalizer l) and the output
// accumulator are float; p is rounded to the pool's dtype before the PV
// product, as the reference kernels cast p to V's dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "dtype.cuh"

namespace {  // internal linkage: each .cu gets its own instantiations

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// the reference's masked-score constant (-0.7 * float max)
constexpr float kNegInf = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory floats for one CTA: K tile (padded rows), V tile, q rows,
// accumulators, (m, l) per row, the tile's scores / probabilities per row
// (padded rows), and one rescale factor per pool block of the tile and row.
inline size_t smem_bytes(int tile, int rows, int hd, int bs) {
  return sizeof(float) * ((size_t)tile * (hd + 1) + (size_t)tile * hd +
                          2 * (size_t)rows * hd + 2 * (size_t)rows +
                          (size_t)rows * (tile + 1) + (size_t)rows * (tile / bs));
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(kThreads)
    walk_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kpool,
                const TKV* __restrict__ vpool, const int* __restrict__ tables,
                const int* __restrict__ start, int len_offset,
                TQ* __restrict__ out, int W, int H, int KV, int BS, int NBLK,
                int TILE, float scale) {
  extern __shared__ float smem[];
  constexpr int KP = HD + 1;  // padded K row: lane-per-position reads differ in bank
  const int b = blockIdx.x, g = blockIdx.y;
  const int n_rep = H / KV;
  const int R = W * n_rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ks = smem;                 // [TILE][KP]
  float* vs = ks + TILE * KP;       // [TILE][HD]
  float* qs = vs + TILE * HD;       // [R][HD]
  float* acc = qs + R * HD;         // [R][HD]
  float* ms = acc + R * HD;         // [R]
  float* ls = ms + R;               // [R]
  const int SP = TILE + 1;          // padded score row: row-per-thread reads
  float* sc = ls + R;               // [R][SP] scores, then rounded p
  float* al = sc + R * SP;          // [TILE / BS][R] per-block rescale

  const int t_max = NBLK * BS;
  const int s0 = start[b] + len_offset;
  const int last = min(s0 + W - 1, t_max - 1);  // last position any row sees
  const int* table = tables + (size_t)b * NBLK;

  // row r = lane l * n_rep + rep  <->  query head g * n_rep + rep of lane l
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int l = r / n_rep, rep = r % n_rep;
    qs[i] = to_f(q[(((size_t)b * W + l) * H + g * n_rep + rep) * HD + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }

  // pool rows are read as 16-byte vectors; each thread issues its whole
  // share of a tile's loads before it converts and stores any of them
  constexpr int VEC = 16 / sizeof(TKV);  // elements per vector
  constexpr int VPR = HD / VEC;          // vectors per pool row
  constexpr int UNROLL = 4;
  for (int t0 = 0; t0 <= last; t0 += TILE) {
    const int n_tile = min(TILE, last + 1 - t0);
    const int nvec = n_tile * VPR;
    __syncthreads();  // the previous tile's readers are done
    for (int base = 0; base < nvec; base += kThreads * UNROLL) {
      uint4 kr[UNROLL], vr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < nvec) {
          const int pos = t0 + i / VPR;
          const size_t src =
              (((size_t)table[pos / BS] * BS + pos % BS) * KV + g) * HD +
              (i % VPR) * VEC;
          kr[u] = *reinterpret_cast<const uint4*>(kpool + src);
          vr[u] = *reinterpret_cast<const uint4*>(vpool + src);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < nvec) {
          const int p = i / VPR, d0 = (i % VPR) * VEC;
          const TKV* ke = reinterpret_cast<const TKV*>(&kr[u]);
          const TKV* ve = reinterpret_cast<const TKV*>(&vr[u]);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            ks[p * KP + d0 + e] = to_f(ke[e]);
            vs[p * HD + d0 + e] = to_f(ve[e]);
          }
        }
      }
    }
    __syncthreads();
    // (A) every visible (row, position) score, spread over all threads
    for (int i = tid; i < R * n_tile; i += kThreads) {
      const int r = i / n_tile, p = i % n_tile;
      if (t0 + p > min(s0 + r / n_rep, t_max - 1)) continue;  // never read
      const float* qr = qs + r * HD;
      const float* kr = ks + p * KP;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        a0 = fmaf(qr[d], kr[d], a0);
        a1 = fmaf(qr[d + 1], kr[d + 1], a1);
        a2 = fmaf(qr[d + 2], kr[d + 2], a2);
        a3 = fmaf(qr[d + 3], kr[d + 3], a3);
      }
      sc[r * SP + p] = ((a0 + a1) + (a2 + a3)) * scale;
    }
    __syncthreads();
    // (B) the online-softmax state, one update per pool block in order, as
    // the reference does (p is rounded against the running max after each
    // block): a warp per row, the block's positions across its lanes
    for (int r = warp; r < R; r += kWarps) {
      const int nvalid = min(n_tile, min(s0 + r / n_rep, t_max - 1) - t0 + 1);
      float* sr = sc + r * SP;
      for (int jb = 0; jb * BS < nvalid; ++jb) {
        const int p0 = jb * BS, p1 = min(p0 + BS, nvalid);
        float mloc = kNegInf;
        for (int p = p0 + lane; p < p1; p += 32) mloc = fmaxf(mloc, sr[p]);
        const float m_prev = ms[r];
        const float m_new = fmaxf(m_prev, warp_max(mloc));
        const float alpha = expf(m_prev - m_new);
        float lsum = 0.f;
        for (int p = p0 + lane; p < p1; p += 32) {
          const float e = expf(sr[p] - m_new);
          lsum += e;
          sr[p] = round_as<TKV>(e);
        }
        lsum = warp_sum(lsum);
        if (lane == 0) {
          ms[r] = m_new;
          ls[r] = ls[r] * alpha + lsum;
          al[jb * R + r] = alpha;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // (C) acc = acc * alpha_j + p_j . V_j, block by block, over all threads
    for (int i = tid; i < R * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int nvalid = min(n_tile, min(s0 + r / n_rep, t_max - 1) - t0 + 1);
      const float* sr = sc + r * SP;
      float a = acc[i];
      for (int jb = 0; jb * BS < nvalid; ++jb) {
        const int p0 = jb * BS, p1 = min(p0 + BS, nvalid);
        float b0 = 0.f, b1 = 0.f;
        int p = p0;
        for (; p + 1 < p1; p += 2) {
          b0 = fmaf(sr[p], vs[p * HD + d], b0);
          b1 = fmaf(sr[p + 1], vs[(p + 1) * HD + d], b1);
        }
        if (p < p1) b0 = fmaf(sr[p], vs[p * HD + d], b0);
        a = a * al[jb * R + r] + (b0 + b1);
      }
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int l = r / n_rep, rep = r % n_rep;
    out[(((size_t)b * W + l) * H + g * n_rep + rep) * HD + d] =
        from_f<TQ>(acc[i] / fmaxf(ls[r], 1e-30f));
  }
}

template <typename TQ, typename TKV, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const int* tables, const int* start, int len_offset,
                      void* out, int B, int W, int H, int KV, int BS, int NBLK,
                      float scale, cudaStream_t stream) {
  const int tile = BS * (BS >= 64 ? 1 : 64 / BS);
  const size_t smem = smem_bytes(tile, W * (H / KV), HD, BS);
  auto kern = walk_kernel<TQ, TKV, HD>;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(B, KV), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), tables, start, len_offset,
      static_cast<TQ*>(out), W, H, KV, BS, NBLK, tile, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_types(int HD, const void* q, const void* k, const void* v,
                         const int* tables, const int* start, int len_offset,
                         void* out, int B, int W, int H, int KV, int BS,
                         int NBLK, float scale, cudaStream_t s) {
  switch (HD) {
    case 16:
      return launch_hd<TQ, TKV, 16>(q, k, v, tables, start, len_offset, out, B,
                                    W, H, KV, BS, NBLK, scale, s);
    case 32:
      return launch_hd<TQ, TKV, 32>(q, k, v, tables, start, len_offset, out, B,
                                    W, H, KV, BS, NBLK, scale, s);
    case 64:
      return launch_hd<TQ, TKV, 64>(q, k, v, tables, start, len_offset, out, B,
                                    W, H, KV, BS, NBLK, scale, s);
    case 128:
      return launch_hd<TQ, TKV, 128>(q, k, v, tables, start, len_offset, out,
                                     B, W, H, KV, BS, NBLK, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype codes: 0 = float32, 1 = bfloat16.  Taken: (q, pool) in
// {(f32, f32), (f32, bf16), (bf16, bf16)}.
inline cudaError_t launch(int q_dtype, int kv_dtype, int HD, const void* q,
                          const void* k, const void* v, const int* tables,
                          const int* start, int len_offset, void* out, int B,
                          int W, int H, int KV, int BS, int NBLK, float scale,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || W <= 0 || KV <= 0 || H % KV || BS <= 0 || NBLK <= 0)
    return cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_types<float, float>(HD, q, k, v, tables, start, len_offset,
                                      out, B, W, H, KV, BS, NBLK, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_types<float, __nv_bfloat16>(HD, q, k, v, tables, start,
                                              len_offset, out, B, W, H, KV, BS,
                                              NBLK, scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_types<__nv_bfloat16, __nv_bfloat16>(
        HD, q, k, v, tables, start, len_offset, out, B, W, H, KV, BS, NBLK,
        scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace
