// Flash attention over contiguous sequences for Hopper (sm_90a):
//   o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h] / sqrt(hd)) v[b, j, h]
// q [B, Sq, H, hd], k / v [B, Skv, H, hd] (kv heads already repeated to H),
// float32 or bfloat16 (one dtype), Sq != Skv allowed, optional causal mask
// aligned top-left (key j is seen by query i when j <= i), output in q's
// dtype and layout.
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention` (the
// Pallas `_flash_kernel`): grid (bh, q block, kv block) with the kv axis
// sequential, a running (max, sum, f32 accumulator) in VMEM updated once
// per kv block of bkv = min(512, Skv rounded up to 8) keys, masked scores
// set to NEG_INF = -0.7 * f32 max, p cast to V's dtype before the PV
// product, and O = acc / max(l, 1e-30) written once.  The reference wrapper
// transposes q/k/v to [B*H, S, hd] and pads hd to 128 in HBM.
//
// Bound on the H100: at the shapes of the repo's models (hd 64, a few
// hundred to 1500 keys) the bf16 tensor work and the bytes are both about a
// microsecond; this kernel runs its products on FMA in f32, so it is bound
// by its own arithmetic and sits far above either (the tensor-core version
// is later work).
//
// Design: one CTA of 4 warps per (b * H + h, tile of 64 query rows), reading
// q/k/v in place through their [B, S, H, hd] strides (nothing transposed or
// padded in device memory).  The Q tile is staged once in shared memory as
// f32; the CTA then walks the keys in tiles of 64, staging each K and V tile
// in shared memory (K rows padded by one float so the lanes of a warp, one
// key each, read distinct banks).  Warp w owns query rows 16w..16w+15:
// each lane scores two keys of the tile for every owned row, so a row's max
// and sum are warp reductions, and the running (max, sum) and the row's
// f32 accumulator (lane = feature, hd/32 features per lane) stay in
// registers.  p is rounded to V's dtype on its way through shared memory to
// the PV product; the sum l takes the unrounded p, as in the Pallas kernel.
// Masked: the causal condition and the key tail kpos >= Skv; a causal CTA
// stops at the last key its rows can see (later tiles contribute exactly 0
// and leave the running max unchanged).  The running max is rescaled per
// 64-key tile where the reference rescales per bkv keys: identical sums in
// f32 up to rounding; at bf16 p is rounded against another running max, so
// single probabilities may differ by one bf16 step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "dtype.cuh"

namespace {

constexpr float kNegInf = -0.7f * 3.40282346638528859812e38f;
constexpr int kBQ = 64;                  // query rows per CTA
constexpr int kBKV = 64;                 // keys per tile (two per lane)
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;      // query rows per warp

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)kBQ * hd + (size_t)kBKV * (hd + 1) +
                          (size_t)kBKV * hd + (size_t)kBQ * kBKV);
}

// HC: features per lane, ceil(hd / 32)
template <typename T, int HC>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int H, int Sq,
              int Skv, int hd, float scale, int causal) {
  extern __shared__ float sm[];
  const int kp = hd + 1;
  float* Qs = sm;                        // [kBQ][hd]
  float* Ks = Qs + kBQ * hd;             // [kBKV][hd + 1]
  float* Vs = Ks + kBKV * kp;            // [kBKV][hd]
  float* Ps = Vs + kBKV * hd;            // [kBQ][kBKV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t rs = (size_t)H * hd;      // stride of one sequence position
  const T* qb = q + (size_t)b * Sq * rs + (size_t)h * hd;
  const T* kb = k + (size_t)b * Skv * rs + (size_t)h * hd;
  const T* vb = v + (size_t)b * Skv * rs + (size_t)h * hd;
  T* ob = o + (size_t)b * Sq * rs + (size_t)h * hd;
  const int q0 = blockIdx.x * kBQ;

  for (int idx = tid; idx < kBQ * hd; idx += kWarps * 32) {
    const int r = idx / hd, d = idx % hd;
    Qs[idx] = (q0 + r < Sq) ? to_f(qb[(q0 + r) * rs + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][HC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[r][c] = 0.f;
  }

  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBKV) {
    __syncthreads();                     // the last tile's K/V are consumed
    for (int idx = tid; idx < kBKV * hd; idx += kWarps * 32) {
      const int r = idx / hd, d = idx % hd;
      const bool in = k0 + r < Skv;
      Ks[r * kp + d] = in ? to_f(kb[(k0 + r) * rs + d]) : 0.f;
      Vs[idx] = in ? to_f(vb[(k0 + r) * rs + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float k_a = Ks[lane * kp + d], k_b = Ks[(lane + 32) * kp + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = Qs[(warp * kRows + r) * hd + d];
        s[r][0] = fmaf(qv, k_a, s[r][0]);
        s[r][1] = fmaf(qv, k_b, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = warp * kRows + r, qpos = q0 + i;
      float p[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        const bool ok = kpos < Skv && (!causal || kpos <= qpos);
        s[r][c] = ok ? s[r][c] * scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float alpha = expf(m[r] - m_new);
#pragma unroll
      for (int c = 0; c < 2; ++c) p[c] = expf(s[r][c] - m_new);
      l[r] = l[r] * alpha + warp_sum(p[0] + p[1]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        Ps[i * kBKV + lane + 32 * c] = round_as<T>(p[c]);
#pragma unroll
      for (int c = 0; c < HC; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();                        // a warp reads only its own rows of Ps

    const int jn = min(kBKV, Skv - k0);
    for (int j = 0; j < jn; ++j) {
      float vv[HC];
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < hd ? Vs[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = Ps[(warp * kRows + r) * kBKV + j];
#pragma unroll
        for (int c = 0; c < HC; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos >= Sq) continue;
    const float lr = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) ob[qpos * rs + d] = from_f<T>(acc[r][c] / lr);
    }
  }
}

template <typename T, int HC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Sq, int Skv, int hd, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, HC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd<T, HC><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Sq, Skv, hd, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Sq, int Skv, int hd, float scale,
                        int causal, cudaStream_t s) {
  if (hd <= 32) return launch<T, 1>(q, k, v, o, B, H, Sq, Skv, hd, scale, causal, s);
  if (hd <= 64) return launch<T, 2>(q, k, v, o, B, H, Sq, Skv, hd, scale, causal, s);
  if (hd <= 96) return launch<T, 3>(q, k, v, o, B, H, Sq, Skv, hd, scale, causal, s);
  return launch<T, 4>(q, k, v, o, B, H, Sq, Skv, hd, scale, causal, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it); hd <= 128.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Sq, int Skv, int hd,
                               float scale, int causal, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || hd <= 0 || hd > 128 ||
      (long long)B * H > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, B, H, Sq, Skv, hd, scale, causal, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, H, Sq, Skv, hd, scale,
                                      causal, s);
  return cudaErrorInvalidValue;
}
