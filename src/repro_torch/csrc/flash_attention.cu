// Flash attention over contiguous sequences for Hopper (sm_90a):
//   o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h] / sqrt(hd)) v[b, j, h]
// q [B, Sq, H, hd], k / v [B, Skv, H, hd] (kv heads already repeated to H),
// float32 or bfloat16 (one dtype), any hd and any Sq the grid holds, Sq !=
// Skv allowed, optional causal mask aligned top-left (key j is seen by
// query i when j <= i), output in q's dtype and layout.
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention` (the
// Pallas `_flash_kernel`): grid (bh, q block, kv block) with the kv axis
// sequential, a running (max, sum, f32 accumulator) in VMEM updated once
// per kv block of bkv = min(512, Skv rounded up to 8) keys, masked scores
// set to NEG_INF = -0.7 * f32 max, the QK^T product of bf16 inputs summed
// in f32 and scaled after it, p cast to V's dtype before the PV product,
// the sum l over the unrounded p, and O = acc / max(l, 1e-30) written once.
//
// Bound on the H100: bytes.  Each input read once and the output written
// once is 1-2 us at 3.35 TB/s for a causal 512-token prompt [1,512,16,64]
// (4.2 MB), adaptor_bert [8,64,12,64] (1.6 MB) and whisper-medium cross
// attention [1,64|1500,16,64] (6.4 MB); the bf16 tensor work is under a
// microsecond at each.  So the kernel is bound by latency and by how much
// of the card it occupies, and the design is about those:
//  1. Tensor cores (bf16).  A CTA of 4 warps owns 64 query rows of one
//     (b, h), 16 rows per warp.  Q is loaded once into registers as
//     m16n8k16 A fragments (ldmatrix).  For each 64-key tile S = Q K^T runs
//     on mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with K as the B
//     operand (ldmatrix), is scaled by 1/sqrt(hd) in f32 and masked in the
//     accumulator fragments.  The online softmax works on the fragments:
//     each thread holds 16 scores of two rows, the row max is reduced over
//     the 4-lane quad (__shfl_xor 1, 2), the sum is kept per thread and
//     reduced over the quad once at the end.  p = exp2f(s*log2e - m*log2e)
//     (one FMA and one ex2 per score; its ~1e-6 relative error sits far
//     inside the bf16 gate of min(2^-7 max|V|, 2^-6 max|O|)), rounded to
//     bf16 and repacked in registers into the A fragments of P V (the C
//     layout of two adjacent n8 tiles is the k16 A layout), with V as the
//     B operand through ldmatrix.trans.  f32 keeps its products on FMA
//     (TF32 would round the inputs; the reference's f32 dot is full f32).
//  2. Staging (bf16).  K and V tiles of 64 keys go to shared memory with
//     16-byte cp.async into a ring of two stages (2 x (K + V) x 64 x hd
//     bf16, 32 KB at hd 64); tile t+1's copies are issued before tile t's
//     math.  A third stage (kStages) barely moved the causal prompt on the
//     H100 and lost at hd 128, where the larger ring halves the CTAs per
//     SM.  Rows are padded by 16 bytes so ldmatrix is free of bank
//     conflicts.  hd is padded to 32, 64, 96 or 128 in shared memory only,
//     zero-filled at the load.  Where hd*2 bytes or a base pointer is not
//     16-byte aligned, the same kernel takes element loads (template VEC).
//  3. The grid.  (B*H, q tiles, key ranges): a causal call launches its q
//     tiles longest first.  y holds at most 65535 q tiles, so past that
//     the tiles come in chunks of 65535 on x (x = B*H x column groups x
//     chunks, up to 2^31 - 1; a CTA past the last tile returns at once):
//     any Sq the hardware's grid holds is taken, and a call of at most
//     65535 tiles and 128 columns keeps the grid of one (b, h) per x.
//     Where the CTAs fall short of the SM count, the
//     wrapper splits the keys into ranges of whole 64-key tiles (kv_splits
//     in kernels/flash_attention.py); each CTA then writes its
//     unnormalised f32 accumulator and its (m, l) to a workspace, and the
//     merge kernel combines the ranges in order (no atomics).  A range in
//     which a row sees no key leaves m = NEG_INF, l = 0: p of a masked
//     score is 0, never exp(NEG_INF - NEG_INF).
//  4. P never leaves registers, and each row's max takes two shuffles.
//  5. hd > 128 (recurrentgemma's 256, 512): Q fragments of the whole hd
//     and a 16 x hd accumulator would not fit a warp's registers.  So a
//     CTA owns its 64 query rows and one group of at most 128 output
//     columns (ceil(hd/128) groups on x).  S = Q K^T is summed over the
//     whole hd in slices of 64 columns, Q and K staged slice by slice in a
//     two-stage cp.async ring (smem bounded for any hd), and P V runs over
//     the group's columns only, so a thread keeps the registers of the hd
//     128 kernel.  Every group sums the same S in the same order (the k16
//     steps in hd order, as the hd <= 128 kernel), so its m and l are the
//     other groups' bit for bit: the workspace and the merge need only
//     each group's columns of acc, and group 0 writes (m, l).  The QK^T
//     work is repeated per group: (groups + 1) / 2 times the minimum.  f32
//     keeps the same plan on FMA.  hd <= 128 is one group on the kernels
//     above.
// A causal CTA stops at the last key its rows can see (later tiles add
// exactly 0 in the reference).  The running max is rescaled per 64-key
// tile where the reference rescales per bkv keys: the same sums in f32 up
// to rounding; at bf16 p is rounded against another running max, so one
// probability may differ by a bf16 step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "dtype.cuh"
#include "mma_sync.cuh"

namespace {

constexpr float kNegInf = -0.7f * 3.40282346638528859812e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;                  // query rows per CTA
constexpr int kBKV = 64;                 // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;      // query rows per warp
constexpr int kStages = 2;               // bf16 K/V ring depth (tiles)
constexpr int kGroup = 128;              // hd > 128: output columns per CTA
constexpr int kSlice = 64;               // hd > 128: hd columns per S slice
constexpr int kMaxY = 65535;             // grid y: q tiles per chunk

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* ws;          // splits > 1: acc [splits][rows][hd], m, l [splits][rows]
  int B, H, Sq, Skv, hd;
  float scale;
  int causal, splits;
  int qtiles, groups; // ceil(Sq / 64), column groups
};

// The CTA's (b, h), first query row (Sq: past the last tile), key range
// [k_lo, k_hi) and column group (first column c0).
struct Tile {
  int b, h, q0, k_lo, k_hi, c0;
};

__device__ __forceinline__ Tile tile_of(const Args& a) {
  Tile t;
  const int bh = a.B * a.H;
  const int pair = blockIdx.x % bh, rest = blockIdx.x / bh;
  t.b = pair / a.H;
  t.h = pair % a.H;
  t.c0 = rest % a.groups * kGroup;
  const int qi = rest / a.groups * kMaxY + blockIdx.y;
  if (qi >= a.qtiles) {
    t.q0 = a.Sq;
    t.k_lo = t.k_hi = 0;
    return t;
  }
  // causal: the last q tiles walk the most keys; launch them first
  const int qt = a.causal ? a.qtiles - 1 - qi : qi;
  t.q0 = qt * kBQ;
  // the keys any query sees, cut into `splits` ranges of whole tiles
  // (the same plan as kv_ranges in kernels/flash_attention.py)
  const int kv_len = a.causal ? min(a.Skv, a.Sq) : a.Skv;
  const long long tiles = (kv_len + kBKV - 1) / kBKV;
  const long long s = blockIdx.z;
  t.k_lo = static_cast<int>(s * tiles / a.splits) * kBKV;
  t.k_hi = min(kv_len, static_cast<int>((s + 1) * tiles / a.splits) * kBKV);
  if (a.causal) t.k_hi = min(t.k_hi, t.q0 + kBQ);
  return t;
}

// Workspace row of query qpos: [B, Sq, H] flattened, as the output.
__device__ __forceinline__ size_t ws_row(const Args& a, const Tile& t,
                                         int qpos) {
  return ((size_t)t.b * a.Sq + qpos) * a.H + t.h;
}

__device__ __forceinline__ size_t ws_rows(const Args& a) {
  return (size_t)a.B * a.Sq * a.H;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync body.  HDP: hd padded to a multiple of 16 (32/64/96/128).
// ---------------------------------------------------------------------------
template <int HDP, bool VEC>
__global__ void __launch_bounds__(kThreads) flash_bf16(const Args a) {
  constexpr int P = HDP + 8;             // shared row, 16 bytes of pad
  constexpr int CH = HDP / 8;            // 16-byte chunks per row
  constexpr int KT = HDP / 16;           // k16 steps over hd (QK^T)
  constexpr int DT = HDP / 8;            // n8 tiles of the output (PV)
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);   // [kBQ][P]
  bf16* Ks = Qs + kBQ * P;                    // [kStages][kBKV][P]
  bf16* Vs = Ks + kStages * kBKV * P;         // [kStages][kBKV][P]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile t = tile_of(a);
  if (t.q0 >= a.Sq) return;              // past the last q tile
  const int hd = a.hd;
  const size_t rs = (size_t)a.H * hd;    // stride of one sequence position
  const bf16* qb = static_cast<const bf16*>(a.q) + (size_t)t.b * a.Sq * rs +
                   (size_t)t.h * hd;
  const bf16* kb = static_cast<const bf16*>(a.k) + (size_t)t.b * a.Skv * rs +
                   (size_t)t.h * hd;
  const bf16* vb = static_cast<const bf16*>(a.v) + (size_t)t.b * a.Skv * rs +
                   (size_t)t.h * hd;

  // rows [r0, r0 + 64) of src into dst; rows >= end and features >= hd
  // are zero-filled (VEC: hd % 8 == 0, so a chunk is all in or all out)
  auto stage = [&](bf16* dst, const bf16* src, int r0, int end) {
    for (int c = tid; c < kBKV * CH; c += kThreads) {
      const int r = c / CH, d = (c % CH) * 8;
      bf16* sp = dst + r * P + d;
      const bool row_in = r0 + r < end;
      if constexpr (VEC) {
        const bool in = row_in && d < hd;
        cp_async16(sp, in ? src + (size_t)(r0 + r) * rs + d : src,
                   in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sp[e] = (row_in && d + e < hd) ? src[(size_t)(r0 + r) * rs + d + e]
                                         : __float2bfloat16(0.f);
      }
    }
  };

  const int n_tiles =
      t.k_hi > t.k_lo ? (t.k_hi - t.k_lo + kBKV - 1) / kBKV : 0;
  // one copy group for Q, then one per K/V tile (empty past the last)
  stage(Qs, qb, t.q0, a.Sq);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) {
      stage(Ks + st * kBKV * P, kb, t.k_lo + st * kBKV, a.Skv);
      stage(Vs + st * kBKV * P, vb, t.k_lo + st * kBKV, a.Skv);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();          // Q has landed
  __syncthreads();

  uint32_t qf[KT][4];
#pragma unroll
  for (int ks = 0; ks < KT; ++ks)
    ldmatrix_x4(qf[ks], Qs + (warp * kRows + (lane & 15)) * P + ks * 16 +
                            (lane >> 4) * 8);

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // this thread's rows: row0 (fragment elements 0, 1) and row0 + 8 (2, 3)
  const int row0 = t.q0 + warp * kRows + (lane >> 2);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = t.k_lo + it * kBKV, cur = it % kStages;
    const int nxt = it + kStages - 1;    // in flight during this tile's math
    if (nxt < n_tiles) {
      stage(Ks + (nxt % kStages) * kBKV * P, kb, t.k_lo + nxt * kBKV, a.Skv);
      stage(Vs + (nxt % kStages) * kBKV * P, vb, t.k_lo + nxt * kBKV, a.Skv);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();        // tile it has landed
    __syncthreads();
    const bf16* Kt = Ks + cur * kBKV * P;
    const bf16* Vt = Vs + cur * kBKV * P;

    // S = Q K^T: 8 n8 tiles of keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KT; ++ks) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (j * 8 + (lane & 7) + (lane >> 4) * 8) * P +
                            ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[j], qf[ks], kf);
        mma_bf16(s[j + 1], qf[ks], kf + 2);
      }
    }

    // scale, mask, online softmax on the fragments
    const bool edge =
        k0 + kBKV > a.Skv || (a.causal && k0 + kBKV - 1 > t.q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * a.scale;
        if (edge) {
          const int key = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int qpos = row0 + (e >> 1) * 8;
          if (!(key < a.Skv && (!a.causal || key <= qpos))) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      mb[r] = mx[r] * kLog2e;
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // p: 0 where masked (a row that has seen no key yet keeps l = 0)
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        p[e] = mx[r] == kNegInf ? 0.f : exp2f(fmaf(s[j][e], kLog2e, -mb[r]));
        l[r] += p[e];
      }
      pf[j >> 1][(j & 1) * 2] =
          pack2(__float2bfloat16(p[0]), __float2bfloat16(p[1]));
      pf[j >> 1][(j & 1) * 2 + 1] =
          pack2(__float2bfloat16(p[2]), __float2bfloat16(p[3]));
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P V: 4 k16 steps over the keys, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 15)) * P + d * 8 +
                                  (lane >> 4) * 8);
        mma_bf16(acc[d], pf[kk], vf);
        mma_bf16(acc[d + 1], pf[kk], vf + 2);
      }
    }
    __syncthreads();                     // this stage is free again
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int col0 = (lane & 3) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    if (qpos >= a.Sq) continue;
    if (a.ws == nullptr) {
      const float lr = fmaxf(l[r], 1e-30f);
      bf16* orow = static_cast<bf16*>(a.o) + (size_t)t.b * a.Sq * rs +
                   (size_t)qpos * rs + (size_t)t.h * hd;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int c = d * 8 + col0;
        const float v0 = acc[d][2 * r] / lr, v1 = acc[d][2 * r + 1] / lr;
        if constexpr (VEC) {
          if (c < hd)
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < hd) orow[c] = __float2bfloat16(v0);
          if (c + 1 < hd) orow[c + 1] = __float2bfloat16(v1);
        }
      }
    } else {
      const size_t rows = ws_rows(a), row = ws_row(a, t, qpos);
      const size_t at = blockIdx.z * rows + row;
      float* prow = a.ws + at * hd;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int c = d * 8 + col0;
        if constexpr (VEC) {
          if (c < hd)
            *reinterpret_cast<float2*>(prow + c) =
                make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
        } else {
          if (c < hd) prow[c] = acc[d][2 * r];
          if (c + 1 < hd) prow[c + 1] = acc[d][2 * r + 1];
        }
      }
      if ((lane & 3) == 0) {
        float* mws = a.ws + (size_t)a.splits * rows * hd;
        mws[at] = m[r];
        mws[(size_t)a.splits * rows + at] = l[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA body.  HC: features per lane, ceil(hd / 32).
// ---------------------------------------------------------------------------
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

size_t f32_smem_bytes(int hd) {
  return sizeof(float) * ((size_t)kBQ * hd + (size_t)kBKV * (hd + 1) +
                          (size_t)kBKV * hd + (size_t)kBQ * kBKV);
}

// Q, K and V tiles staged in shared memory as f32 (K rows padded by one
// float so the lanes of a warp, one key each, read distinct banks); each
// lane scores two keys of the tile for every row of its warp, so a row's
// max and sum are warp reductions, and the row's accumulator (lane =
// feature) stays in registers.
template <int HC>
__global__ void __launch_bounds__(kThreads) flash_f32(const Args a) {
  extern __shared__ float sm[];
  const int hd = a.hd, kp = hd + 1;
  float* Qs = sm;                        // [kBQ][hd]
  float* Ks = Qs + kBQ * hd;             // [kBKV][hd + 1]
  float* Vs = Ks + kBKV * kp;            // [kBKV][hd]
  float* Ps = Vs + kBKV * hd;            // [kBQ][kBKV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile t = tile_of(a);
  if (t.q0 >= a.Sq) return;              // past the last q tile
  const size_t rs = (size_t)a.H * hd;
  const float* qb = static_cast<const float*>(a.q) +
                    (size_t)t.b * a.Sq * rs + (size_t)t.h * hd;
  const float* kb = static_cast<const float*>(a.k) +
                    (size_t)t.b * a.Skv * rs + (size_t)t.h * hd;
  const float* vb = static_cast<const float*>(a.v) +
                    (size_t)t.b * a.Skv * rs + (size_t)t.h * hd;

  for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx % hd;
    Qs[idx] = (t.q0 + r < a.Sq) ? qb[(t.q0 + r) * rs + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][HC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = t.k_lo; k0 < t.k_hi; k0 += kBKV) {
    __syncthreads();                     // the last tile's K/V are consumed
    for (int idx = tid; idx < kBKV * hd; idx += kThreads) {
      const int r = idx / hd, d = idx % hd;
      const bool in = k0 + r < a.Skv;
      Ks[r * kp + d] = in ? kb[(k0 + r) * rs + d] : 0.f;
      Vs[idx] = in ? vb[(k0 + r) * rs + d] : 0.f;
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
      const int i = warp * kRows + r, qpos = t.q0 + i;
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        ok[c] = kpos < a.Skv && (!a.causal || kpos <= qpos);
        s[r][c] = ok[c] ? s[r][c] * a.scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float alpha = expf(m[r] - m_new);
      float p[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) p[c] = ok[c] ? expf(s[r][c] - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[0] + p[1]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 2; ++c) Ps[i * kBKV + lane + 32 * c] = p[c];
#pragma unroll
      for (int c = 0; c < HC; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();                        // a warp reads only its own rows of Ps

    const int jn = min(kBKV, a.Skv - k0);
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
    const int qpos = t.q0 + warp * kRows + r;
    if (qpos >= a.Sq) continue;
    if (a.ws == nullptr) {
      float* orow = static_cast<float*>(a.o) + (size_t)t.b * a.Sq * rs +
                    (size_t)qpos * rs + (size_t)t.h * hd;
      const float lr = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) orow[d] = acc[r][c] / lr;
      }
    } else {
      const size_t rows = ws_rows(a);
      const size_t at = blockIdx.z * rows + ws_row(a, t, qpos);
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) a.ws[at * hd + d] = acc[r][c];
      }
      if (lane == 0) {
        float* mws = a.ws + (size_t)a.splits * rows * hd;
        mws[at] = m[r];
        mws[(size_t)a.splits * rows + at] = l[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// hd > 128: a CTA owns 64 query rows and the column group [c0, c0 + 128)
// of the output (grid y); S is summed over hd in slices of 64 columns.
// ---------------------------------------------------------------------------
template <bool VEC>
__global__ void __launch_bounds__(kThreads) flash_bf16_wide(const Args a) {
  constexpr int PS = kSlice + 8;         // Q / K slice row, 16 bytes of pad
  constexpr int PG = kGroup + 8;         // V group row
  constexpr int KT = kSlice / 16;        // k16 steps per slice (QK^T)
  constexpr int DT = kGroup / 8;         // n8 tiles of the group (PV)
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);   // [2][kBQ][PS]
  bf16* Ks = Qs + 2 * kBQ * PS;               // [2][kBKV][PS]
  bf16* Vs = Ks + 2 * kBKV * PS;              // [2][kBKV][PG]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile t = tile_of(a);
  if (t.q0 >= a.Sq) return;              // past the last q tile
  const int hd = a.hd, c0 = t.c0;
  const int ns = (hd + kSlice - 1) / kSlice;
  const size_t rs = (size_t)a.H * hd;
  const bf16* qb = static_cast<const bf16*>(a.q) + (size_t)t.b * a.Sq * rs +
                   (size_t)t.h * hd;
  const bf16* kb = static_cast<const bf16*>(a.k) + (size_t)t.b * a.Skv * rs +
                   (size_t)t.h * hd;
  const bf16* vb = static_cast<const bf16*>(a.v) + (size_t)t.b * a.Skv * rs +
                   (size_t)t.h * hd;

  // rows [r0, r0 + 64) and columns [col, col + W) of src into dst (row
  // pitch W + 8); rows >= end and columns >= hd are zero-filled
  auto stage = [&](bf16* dst, int W, const bf16* src, int r0, int end,
                   int col) {
    const int ch = W / 8;
    for (int c = tid; c < 64 * ch; c += kThreads) {
      const int r = c / ch, d = col + (c % ch) * 8;
      bf16* sp = dst + r * (W + 8) + (c % ch) * 8;
      const bool row_in = r0 + r < end;
      if constexpr (VEC) {
        const bool in = row_in && d < hd;
        cp_async16(sp, in ? src + (size_t)(r0 + r) * rs + d : src,
                   in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sp[e] = (row_in && d + e < hd) ? src[(size_t)(r0 + r) * rs + d + e]
                                         : __float2bfloat16(0.f);
      }
    }
  };
  // step i: slice i % ns of key tile i / ns, into ring stage i % 2
  auto load_step = [&](int i) {
    const int it = i / ns, col = (i % ns) * kSlice;
    stage(Qs + (i & 1) * kBQ * PS, kSlice, qb, t.q0, a.Sq, col);
    stage(Ks + (i & 1) * kBKV * PS, kSlice, kb, t.k_lo + it * kBKV, a.Skv,
          col);
  };
  auto load_v = [&](int it) {
    stage(Vs + (it & 1) * kBKV * PG, kGroup, vb, t.k_lo + it * kBKV, a.Skv,
          c0);
  };

  const int n_tiles =
      t.k_hi > t.k_lo ? (t.k_hi - t.k_lo + kBKV - 1) / kBKV : 0;
  const int steps = n_tiles * ns;
  // one copy group for step 0 and V of tile 0, then one per step: step
  // i + 1's slices and, on a tile's first step, the next tile's V
  if (steps > 0) {
    load_step(0);
    load_v(0);
  }
  cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = t.q0 + warp * kRows + (lane >> 2);
  float s[8][4];

  for (int i = 0; i < steps; ++i) {
    const int it = i / ns, sl = i % ns;
    __syncthreads();                     // step i - 1 has read its stages
    if (i + 1 < steps) load_step(i + 1);
    if (sl == 0 && it + 1 < n_tiles) load_v(it + 1);
    cp_async_commit();
    cp_async_wait<1>();                  // step i's slices (and V of it)
    __syncthreads();
    if (sl == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
    const bf16* Qt = Qs + (i & 1) * kBQ * PS;
    const bf16* Kt = Ks + (i & 1) * kBKV * PS;
#pragma unroll
    for (int ks = 0; ks < KT; ++ks) {
      uint32_t qf[4];
      ldmatrix_x4(qf, Qt + (warp * kRows + (lane & 15)) * PS + ks * 16 +
                          (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (j * 8 + (lane & 7) + (lane >> 4) * 8) * PS +
                            ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[j], qf, kf);
        mma_bf16(s[j + 1], qf, kf + 2);
      }
    }
    if (sl < ns - 1) continue;

    // the tile's S is complete: scale, mask, online softmax, P V
    const int k0 = t.k_lo + it * kBKV;
    const bool edge =
        k0 + kBKV > a.Skv || (a.causal && k0 + kBKV - 1 > t.q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * a.scale;
        if (edge) {
          const int key = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int qpos = row0 + (e >> 1) * 8;
          if (!(key < a.Skv && (!a.causal || key <= qpos))) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      mb[r] = mx[r] * kLog2e;
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        p[e] = mx[r] == kNegInf ? 0.f : exp2f(fmaf(s[j][e], kLog2e, -mb[r]));
        l[r] += p[e];
      }
      pf[j >> 1][(j & 1) * 2] =
          pack2(__float2bfloat16(p[0]), __float2bfloat16(p[1]));
      pf[j >> 1][(j & 1) * 2 + 1] =
          pack2(__float2bfloat16(p[2]), __float2bfloat16(p[3]));
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }
    const bf16* Vt = Vs + (it & 1) * kBKV * PG;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 15)) * PG + d * 8 +
                                  (lane >> 4) * 8);
        mma_bf16(acc[d], pf[kk], vf);
        mma_bf16(acc[d + 1], pf[kk], vf + 2);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int col0 = c0 + (lane & 3) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    if (qpos >= a.Sq) continue;
    if (a.ws == nullptr) {
      const float lr = fmaxf(l[r], 1e-30f);
      bf16* orow = static_cast<bf16*>(a.o) + (size_t)t.b * a.Sq * rs +
                   (size_t)qpos * rs + (size_t)t.h * hd;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int c = d * 8 + col0;
        const float v0 = acc[d][2 * r] / lr, v1 = acc[d][2 * r + 1] / lr;
        if constexpr (VEC) {
          if (c < hd)
            *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < hd) orow[c] = __float2bfloat16(v0);
          if (c + 1 < hd) orow[c + 1] = __float2bfloat16(v1);
        }
      }
    } else {
      const size_t rows = ws_rows(a);
      const size_t at = blockIdx.z * rows + ws_row(a, t, qpos);
      float* prow = a.ws + at * hd;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int c = d * 8 + col0;
        if constexpr (VEC) {
          if (c < hd)
            *reinterpret_cast<float2*>(prow + c) =
                make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
        } else {
          if (c < hd) prow[c] = acc[d][2 * r];
          if (c + 1 < hd) prow[c + 1] = acc[d][2 * r + 1];
        }
      }
      if (c0 == 0 && (lane & 3) == 0) {
        float* mws = a.ws + (size_t)a.splits * rows * hd;
        mws[at] = m[r];
        mws[(size_t)a.splits * rows + at] = l[r];
      }
    }
  }
}

size_t f32_wide_smem_bytes() {
  return sizeof(float) *
         ((size_t)kBQ * kSlice + (size_t)kBKV * (kSlice + 1) +
          (size_t)kBKV * kGroup + (size_t)kBQ * kBKV);
}

// f32, hd > 128: the FMA body of flash_f32 with Q and K staged in slices
// of 64 columns (each lane's two scores summed over hd in order) and V in
// the group's 128 columns (HC = 4 features per lane).
__global__ void __launch_bounds__(kThreads) flash_f32_wide(const Args a) {
  constexpr int KP = kSlice + 1;
  constexpr int HC = kGroup / 32;
  extern __shared__ float sm[];
  float* Qs = sm;                        // [kBQ][kSlice]
  float* Ks = Qs + kBQ * kSlice;         // [kBKV][kSlice + 1]
  float* Vs = Ks + kBKV * KP;            // [kBKV][kGroup]
  float* Ps = Vs + kBKV * kGroup;        // [kBQ][kBKV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile t = tile_of(a);
  if (t.q0 >= a.Sq) return;              // past the last q tile
  const int hd = a.hd, c0 = t.c0;
  const size_t rs = (size_t)a.H * hd;
  const float* qb = static_cast<const float*>(a.q) +
                    (size_t)t.b * a.Sq * rs + (size_t)t.h * hd;
  const float* kb = static_cast<const float*>(a.k) +
                    (size_t)t.b * a.Skv * rs + (size_t)t.h * hd;
  const float* vb = static_cast<const float*>(a.v) +
                    (size_t)t.b * a.Skv * rs + (size_t)t.h * hd;

  float m[kRows], l[kRows], acc[kRows][HC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = t.k_lo; k0 < t.k_hi; k0 += kBKV) {
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    for (int cs = 0; cs < hd; cs += kSlice) {
      __syncthreads();                   // the last slice is consumed
      for (int idx = tid; idx < kBQ * kSlice; idx += kThreads) {
        const int r = idx / kSlice, d = cs + idx % kSlice;
        Qs[idx] =
            (t.q0 + r < a.Sq && d < hd) ? qb[(t.q0 + r) * rs + d] : 0.f;
      }
      for (int idx = tid; idx < kBKV * kSlice; idx += kThreads) {
        const int r = idx / kSlice, d = idx % kSlice;
        Ks[r * KP + d] = (k0 + r < a.Skv && cs + d < hd)
                             ? kb[(k0 + r) * rs + cs + d] : 0.f;
      }
      __syncthreads();
      const int dn = min(kSlice, hd - cs);
      for (int d = 0; d < dn; ++d) {
        const float k_a = Ks[lane * KP + d], k_b = Ks[(lane + 32) * KP + d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float qv = Qs[(warp * kRows + r) * kSlice + d];
          s[r][0] = fmaf(qv, k_a, s[r][0]);
          s[r][1] = fmaf(qv, k_b, s[r][1]);
        }
      }
    }
    for (int idx = tid; idx < kBKV * kGroup; idx += kThreads) {
      const int r = idx / kGroup, d = c0 + idx % kGroup;
      Vs[idx] = (k0 + r < a.Skv && d < hd) ? vb[(k0 + r) * rs + d] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = warp * kRows + r, qpos = t.q0 + i;
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        ok[c] = kpos < a.Skv && (!a.causal || kpos <= qpos);
        s[r][c] = ok[c] ? s[r][c] * a.scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float alpha = expf(m[r] - m_new);
      float p[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) p[c] = ok[c] ? expf(s[r][c] - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[0] + p[1]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 2; ++c) Ps[i * kBKV + lane + 32 * c] = p[c];
#pragma unroll
      for (int c = 0; c < HC; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();                        // a warp reads only its own rows of Ps

    const int jn = min(kBKV, a.Skv - k0);
    for (int j = 0; j < jn; ++j) {
      float vv[HC];
#pragma unroll
      for (int c = 0; c < HC; ++c) vv[c] = Vs[j * kGroup + lane + 32 * c];
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
    const int qpos = t.q0 + warp * kRows + r;
    if (qpos >= a.Sq) continue;
    if (a.ws == nullptr) {
      float* orow = static_cast<float*>(a.o) + (size_t)t.b * a.Sq * rs +
                    (size_t)qpos * rs + (size_t)t.h * hd;
      const float lr = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int d = c0 + lane + 32 * c;
        if (d < hd) orow[d] = acc[r][c] / lr;
      }
    } else {
      const size_t rows = ws_rows(a);
      const size_t at = blockIdx.z * rows + ws_row(a, t, qpos);
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int d = c0 + lane + 32 * c;
        if (d < hd) a.ws[at * hd + d] = acc[r][c];
      }
      if (c0 == 0 && lane == 0) {
        float* mws = a.ws + (size_t)a.splits * rows * hd;
        mws[at] = m[r];
        mws[(size_t)a.splits * rows + at] = l[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// merge of the key ranges: one thread per output element, ranges in order
//   m* = max_s m_s, w_s = e^(m_s - m*), O = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30)
// A range in which the row saw no key has m_s = NEG_INF, l_s = 0 and
// weight e^(NEG_INF - m*) = 0 (key 0 is seen by every row, so m* is finite).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256) flash_merge(const Args a) {
  const size_t rows = ws_rows(a), n = rows * a.hd;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const size_t row = idx / a.hd;
  const float* mws = a.ws + (size_t)a.splits * n;
  const float* lws = mws + (size_t)a.splits * rows;
  float mx = kNegInf;
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, mws[s * rows + row]);
  float lsum = 0.f, o = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const float w = expf(mws[s * rows + row] - mx);
    lsum += lws[s * rows + row] * w;
    o += a.ws[s * n + idx] * w;
  }
  static_cast<T*>(a.o)[idx] = from_f<T>(o / fmaxf(lsum, 1e-30f));
}

int col_groups(int hd) {
  return hd <= kGroup ? 1 : (hd + kGroup - 1) / kGroup;
}

dim3 grid_of(const Args& a) {
  const int chunks = (a.qtiles - 1) / kMaxY + 1;
  return dim3(static_cast<unsigned>(a.B * a.H) * a.groups * chunks,
              a.qtiles < kMaxY ? a.qtiles : kMaxY, a.splits);
}

template <class Kern>
cudaError_t launch(Kern kern, size_t smem, const Args& a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<grid_of(a), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_bf16(const Args& a, bool vec, cudaStream_t s) {
  const size_t smem =
      sizeof(__nv_bfloat16) * (size_t)(kBQ + 2 * kStages * kBKV) * (HDP + 8);
  return vec ? launch(flash_bf16<HDP, true>, smem, a, s)
             : launch(flash_bf16<HDP, false>, smem, a, s);
}

cudaError_t dispatch_bf16(const Args& a, cudaStream_t s) {
  bool vec = a.hd % 8 == 0;
  for (const void* p : {a.q, a.k, a.v, static_cast<const void*>(a.o)})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  if (a.hd <= 32) return launch_bf16<32>(a, vec, s);
  if (a.hd <= 64) return launch_bf16<64>(a, vec, s);
  if (a.hd <= 96) return launch_bf16<96>(a, vec, s);
  if (a.hd <= 128) return launch_bf16<128>(a, vec, s);
  const size_t smem = sizeof(__nv_bfloat16) *
                      (size_t)(2 * (kBQ + kBKV) * (kSlice + 8) +
                               2 * kBKV * (kGroup + 8));
  return vec ? launch(flash_bf16_wide<true>, smem, a, s)
             : launch(flash_bf16_wide<false>, smem, a, s);
}

cudaError_t dispatch_f32(const Args& a, cudaStream_t s) {
  const size_t smem = f32_smem_bytes(a.hd);
  if (a.hd <= 32) return launch(flash_f32<1>, smem, a, s);
  if (a.hd <= 64) return launch(flash_f32<2>, smem, a, s);
  if (a.hd <= 96) return launch(flash_f32<3>, smem, a, s);
  if (a.hd <= 128) return launch(flash_f32<4>, smem, a, s);
  return launch(flash_f32_wide, f32_wide_smem_bytes(), a, s);
}

template <typename T>
cudaError_t launch_merge(const Args& a, cudaStream_t s) {
  const size_t n = (size_t)a.B * a.Sq * a.H * a.hd;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  flash_merge<T><<<blocks, 256, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it); any hd and
// Sq for which grid x, B * H x column groups x ceil(q tiles / 65535),
// stays under 2^31.
// splits: key ranges (>= 1); with splits > 1, ws holds splits * B * Sq * H
// * (hd + 2) floats and a merge kernel follows the main one on the stream.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Sq, int Skv, int hd,
                               float scale, int causal, int dtype, void* ws,
                               int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int qtiles = Sq > 0 ? (Sq - 1) / kBQ + 1 : 0;
  const int groups = hd > 0 ? col_groups(hd) : 0;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || hd <= 0 ||
      (long long)B * H * groups * ((qtiles - 1) / kMaxY + 1) > 0x7fffffffLL ||
      splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr) ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, splits > 1 ? static_cast<float*>(ws) : nullptr,
               B, H, Sq, Skv, hd, scale, causal, splits, qtiles, groups};
  cudaError_t e = dtype == 0 ? dispatch_f32(a, s) : dispatch_bf16(a, s);
  if (e != cudaSuccess || splits == 1) return e;
  return dtype == 0 ? launch_merge<float>(a, s)
                    : launch_merge<__nv_bfloat16>(a, s);
}
