// The split-KV walk over the paged pool for Hopper (sm_90a), shared by
// chunked-prefill attention (csrc/chunked_prefill.cu, W query lanes per
// sequence) and one-token decode (csrc/paged_attention.cu, W = 1).
//
//   q       [B, W, H, HD]       query lanes; lane l of sequence b sits at
//                               position s0 = start[b] + len_offset + l
//   k/v     [NB, BS, KV, HD]    the shared block pool (block 0 = null
//                               block), 16-byte aligned, in float32,
//                               bfloat16 or int8
//   k/vsc   [NB, BS, KV] float  int8 pools only: one scale per (position,
//                               kv head), the int8 cache codec's
//   tables  [B, NBLK] int32     physical block of each logical block
//   start   [B] int32           the chunk's lane-0 position (len_offset 0)
//                               or decode's lengths (len_offset -1)
//   live_kv [B] int32 or null   multi-topology serving: the live kv groups
//                               of each sequence; every output row of a
//                               group g >= live_kv[b] is exact zeros
// Lane l sees the positions <= min(s0 + l, NBLK * BS - 1).  HD is any
// head dim whose CTA fits in shared memory (every hd up to 512 in every
// dtype pair); the output is in q's dtype.
//
// Numerics (the reference kernels'): QK^T of the stored dtypes summed in
// f32 and scaled after the product, one online-softmax update per 16-
// position tile (one pool block at BS = 16), l over the unrounded p, p
// rounded to the pool's dtype before PV, O = acc / max(l, 1e-30); an int8
// pool is dequantized with its row scales and attended by f32 q with f32 p.
//
// Design:
//  1. Split-KV over the block table.  The grid is (sequence x kv head x row
//     tile, key range).  A key range is a run of whole logical blocks,
//     floor(z * NBLK / splits) up to floor((z + 1) * NBLK / splits); the
//     wrapper chooses `splits` from the shapes alone (kv_splits in
//     kernels/chunked_prefill.py: about one wave of CTAs, the wave counted
//     from the walk's occupancy, walk_resident_ctas below; at least two
//     pool blocks per range), so no host ever reads start or the tables.
//     A CTA whose range begins past the last position its rows see writes
//     m = NEG_INF, l = 0 and no accumulator (one range: a zero output).
//     With splits > 1 the CTAs write the unnormalised f32 accumulator and
//     (m, l) of their range to a workspace, and a merge kernel
//     (flash_merge's arithmetic, csrc/flash_attention.cu, ranges in order,
//     skipping those with m = NEG_INF) follows on the same stream.  (A
//     merge by the last CTA of each row tile to finish saves decode the
//     second launch, but 128 threads merging a 16-row tile cost the chunk
//     kernel more than the launch: PERF.md, Findings.)
//  2. Inside a CTA, 4 warps share 16 query rows (row r = lane * n_rep +
//     rep, as the reference's query group; at W = 1 the n_rep heads of one
//     kv group) and split the range's 16-position tiles between them (warp
//     w takes tiles w, w + 4, ...).  Each warp walks its tiles alone, with
//     no CTA barrier, through its own ring of shared-memory stages, and the
//     four partial (acc, m, l) are merged in shared memory at the end.
//  3. cp.async staging in the pool's dtype.  Each 16-position tile's K and V
//     rows (HD * 2 bytes bf16, HD bytes int8 plus a 4-byte scale, HD * 4
//     bytes f32) are copied by 16-byte cp.async straight from
//     table[pos / BS] into the warp's ring (3 stages, 2 for f32 pools);
//     rows are padded by 16 bytes so that ldmatrix and row-per-lane reads
//     hit distinct banks.  Widening and dequantization happen when a row is
//     read from shared memory.  start[b], the range's slice of the block
//     table and q are loaded once, together, at the start.
//  4. bf16 q over a bf16 pool on tensor cores: QK^T and PV are mma.sync
//     m16n8k16 bf16 -> f32 (csrc/mma_sync.cuh).  Q is loaded once as A
//     fragments; a 16-position tile is one k16 step of PV, so at BS = 16
//     the online-softmax update falls on every pool block as in the
//     reference (other block sizes update every 16 positions: the same
//     sums in f32 up to rounding, p rounded against another running max).
//     P stays in registers as the A fragment, V goes in through
//     ldmatrix.trans.  The pairs with f32 q or an int8 pool compute in f32
//     as the reference does, on FMA: lanes over (position, row half) for
//     the scores, lanes over features for PV; decode's copy (kSkipDead)
//     skips the rows past the CTA's live rows (n_rep < 16).
//  5. Dead kv groups (live_kv).  A fleet pads the head axis to its maxima,
//     and the padded groups may hold anything, NaN included, in q and in the
//     pool.  A CTA whose group is dead reads nothing: with one key range it
//     writes exact zeros to its output rows, with several it writes nothing,
//     and the merge, which reads live_kv for each of its rows, writes exact
//     zeros there without reading the workspace (no 0 / 0).
//  6. NaN never reaches an output.  An mma multiplies p = 0 by the staged V
//     row, so every staged row that no row of the CTA may see (past its
//     last position or its range), or whose physical block is the null
//     block 0, is zero-filled by the copy itself (src-size 0) and never
//     read from the pool; an int8 row's scale likewise.  A live lane never
//     sees the null block; dead lanes (which the caller drops) do, and see
//     zeros there.
//  7. Every other head dim (fault F; the reference pads hd to 128 lanes and
//     takes any): HD not a multiple of 16, or past 128, runs the general
//     bodies (chunk_mma_gen, chunk_fma_gen).  K and q rows are staged at
//     KP = HD rounded up to 16, their tails zero, so QK^T over KP is QK^T
//     over HD.  A CTA owns one group of GW = 128 output columns
//     (blockIdx.z picks the group, flash_bf16_wide's design; the last
//     group's columns past HD are zeros that no one writes out): it sums S
//     over the whole row and runs PV over its own columns, staging only
//     their V columns, so acc stays 128 columns in registers.  One width
//     keeps the general bodies to one instantiation per dtype pair.  Every
//     group sums the same scores in the same order, so m and l agree bit
//     for bit and the split workspace and merge are the hd <= 128 walk's
//     (group 0 writes m, l).  q stays in shared memory (one ldmatrix per
//     k16 step).  Rows that are not 16-byte aligned (hd * dtype bytes) are
//     copied in 4-byte cp.async units where hd * bytes is a multiple of 4,
//     else byte by byte through registers.  The ring takes 3 stages (2 for
//     f32 pools), fewer where a CTA's shared memory would pass 227 KB
//     (plan_general).
// Shared memory is bounded whatever W * n_rep is: a CTA holds 16 rows.
// Everything here has internal linkage: each entry point's translation
// unit compiles its own copy of the walk.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "dtype.cuh"
#include "mma_sync.cuh"

namespace {

constexpr float kNegInf = -0.7f * 3.40282346638528859812e38f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;  // query rows per CTA: one m16 tile
constexpr int kTile = 16;  // pool positions per step: one k16 step of PV

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ksc;
  const float* vsc;
  const int* tables;
  const int* start;
  const int* live_kv;  // null: every group is live
  void* out;
  float* ws;  // splits > 1: acc [splits][rows][HD], then m, l [splits][rows]
  int B, W, H, KV, HD, BS, NBLK, splits, row_tiles;
  int len_offset;  // lane 0 sits at start[b] + len_offset
  float scale;
  // the general bodies only (plan_general): staged K / q row KP = HD
  // rounded up to 16, GW columns per group, ring stages S, copy unit bytes
  int KP, GW, S, unit;
};

constexpr int kGroupCols = 128;  // GW of the general bodies

// HD that the hd <= 128 bodies take; every other runs the general ones
__host__ __device__ inline bool general_hd(int hd) {
  return hd % 16 != 0 || hd > 128;
}

// f32 pools take two stages (their rows are twice a bf16 row)
template <typename TKV>
__host__ __device__ constexpr int stages() {
  return sizeof(TKV) == 4 ? 2 : 3;
}

// one staged pool row, 16 bytes of pad; one stage of one warp: the K and V
// tiles, then the tile's K and V scales (int8 pools)
__host__ __device__ inline int row_bytes(int hd, int esz) {
  return hd * esz + 16;
}
__host__ __device__ inline int stage_bytes(int hd, int esz) {
  return 2 * kTile * row_bytes(hd, esz) + 2 * kTile * 4;
}
// the block-table entries of one range (floor division gives ranges of at
// most ceil(NBLK / splits) blocks)
__host__ __device__ inline int table_slots(const Args& a) {
  return (a.NBLK + a.splits - 1) / a.splits + 1;
}

// Shared memory: q rows (f32 or padded bf16), the range's table entries,
// the warps' rings, and for the FMA body each warp's p and rescale factors.
// The warps' partial results reuse the rings at the end.
size_t smem_bytes(const Args& a, int esz, int n_stages, bool fma) {
  const size_t q = (size_t)kRows * a.HD * 4;
  const size_t tbl = ((size_t)table_slots(a) * 4 + 15) / 16 * 16;
  const size_t ring = (size_t)kWarps * n_stages * stage_bytes(a.HD, esz);
  const size_t p = fma ? (size_t)kWarps * (kRows * kTile + kRows) * 4 : 0;
  return q + tbl + ring + p;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The CTA's sequence, kv head, query rows and key range; s0 and hi are set
// by the prologue, once start[b] has landed.
struct Cta {
  int b, g, r0, rows, n_rep, s0;
  int lo_blk, hi_blk;  // the range's logical blocks [lo_blk, hi_blk)
  int lo, hi;          // its positions [lo, hi), cut at the last seen
};

__device__ __forceinline__ Cta cta_of(const Args& a) {
  Cta c;
  int x = blockIdx.x;
  c.r0 = (x % a.row_tiles) * kRows;
  x /= a.row_tiles;
  c.g = x % a.KV;
  c.b = x / a.KV;
  c.n_rep = a.H / a.KV;
  c.rows = min(kRows, a.W * c.n_rep - c.r0);
  const long long z = blockIdx.y;
  c.lo_blk = static_cast<int>(z * a.NBLK / a.splits);
  c.hi_blk = static_cast<int>((z + 1) * a.NBLK / a.splits);
  c.lo = c.lo_blk * a.BS;
  return c;
}

// row i of the CTA's tile: its lane's last visible position (-1: no row)
__device__ __forceinline__ int limit_of(const Cta& c, int i) {
  return i < c.rows ? c.s0 + (c.r0 + i) / c.n_rep : -1;
}

// row i of the CTA's tile as a row of q / out / the workspace ([B, W, H])
__device__ __forceinline__ size_t out_row(const Args& a, const Cta& c,
                                          int i) {
  const int r = c.r0 + i;
  return ((size_t)c.b * a.W + r / c.n_rep) * a.H + c.g * c.n_rep +
         r % c.n_rep;
}

// Tile [t0, t0 + 16) of the pool into one stage.  Rows past hi or in the
// null block are zero-filled and not read.
template <typename TKV>
__device__ __forceinline__ void stage_tile(const Args& a, const Cta& c,
                                           const int* tbl,
                                           unsigned char* dst, int t0,
                                           int lane) {
  constexpr int E = sizeof(TKV);
  const int rb = row_bytes(a.HD, E), ch = a.HD * E / 16;
  unsigned char* kd = dst;
  unsigned char* vd = dst + kTile * rb;
  const unsigned char* kp = static_cast<const unsigned char*>(a.k);
  const unsigned char* vp = static_cast<const unsigned char*>(a.v);
  for (int i = lane; i < kTile * ch; i += 32) {
    const int r = i / ch, x = i % ch, pos = t0 + r;
    const int phys = pos < c.hi ? tbl[pos / a.BS - c.lo_blk] : 0;
    const bool in = phys != 0;
    const size_t off =
        (((size_t)phys * a.BS + pos % a.BS) * a.KV + c.g) * a.HD * E + x * 16;
    cp_async16(kd + r * rb + x * 16, in ? kp + off : kp, in ? 16 : 0);
    cp_async16(vd + r * rb + x * 16, in ? vp + off : vp, in ? 16 : 0);
  }
  if constexpr (std::is_same<TKV, int8_t>::value) {
    if (lane < kTile) {
      const int pos = t0 + lane;
      const int phys = pos < c.hi ? tbl[pos / a.BS - c.lo_blk] : 0;
      const bool in = phys != 0;
      const size_t row = ((size_t)phys * a.BS + pos % a.BS) * a.KV + c.g;
      float* sd = reinterpret_cast<float*>(dst + 2 * kTile * rb);
      cp_async4(sd + lane, in ? a.ksc + row : a.ksc, in ? 4 : 0);
      cp_async4(sd + kTile + lane, in ? a.vsc + row : a.vsc, in ? 4 : 0);
    }
  }
}

// A warp's walk over its tiles of the CTA's range through an n_stages ring;
// body(stage, t0) consumes one landed tile.
template <typename TKV, int S, typename Body>
__device__ __forceinline__ void walk(const Args& a, const Cta& c,
                                     const int* tbl, unsigned char* ring,
                                     int warp, int lane, Body&& body) {
  const int sb = stage_bytes(a.HD, sizeof(TKV));
  const int n_tiles = (c.hi - c.lo + kTile - 1) / kTile;
  const int mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  auto t0_of = [&](int it) { return c.lo + (warp + it * kWarps) * kTile; };
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < mine) stage_tile<TKV>(a, c, tbl, ring + st * sb, t0_of(st), lane);
    cp_async_commit();
  }
  for (int it = 0; it < mine; ++it) {
    const int nxt = it + S - 1;  // in flight during this tile's math
    if (nxt < mine)
      stage_tile<TKV>(a, c, tbl, ring + (nxt % S) * sb, t0_of(nxt), lane);
    cp_async_commit();
    cp_async_wait<S - 1>();  // tile it has landed (this lane's copies)
    __syncwarp();            // ... and every lane's
    body(ring + (it % S) * sb, t0_of(it));
    __syncwarp();  // this stage is free again
  }
}

// Shared prologue: start[b], the range's table entries and q (as f32, or as
// bf16 rows padded by 16 bytes for ldmatrix), loaded together since none
// depends on another.  Returns false (after writing the empty partial) when
// the range begins past the last position the rows see.  kGen: the general
// bodies' layout (q rows of KP columns, zeros past HD, loaded element by
// element; a dead group zeroes only its CTA's columns).
template <typename TQ, bool kBf16Q, bool kGen = false>
__device__ __forceinline__ bool prologue(const Args& a, Cta& c,
                                         unsigned char* smem, int* tbl) {
  const int tid = threadIdx.x;
  if (a.live_kv != nullptr && c.g >= a.live_kv[c.b]) {
    // a dead group: exact zeros (one range) or nothing (the merge zeroes it)
    if (a.splits == 1) {
      const int c0 = kGen ? blockIdx.z * a.GW : 0;
      const int nc = kGen ? min(a.GW, a.HD - c0) : a.HD;
      for (int i = tid; i < c.rows * nc; i += kThreads)
        static_cast<TQ*>(a.out)[out_row(a, c, i / nc) * a.HD + c0 + i % nc] =
            from_f<TQ>(0.f);
    }
    return false;
  }
  c.s0 = a.start[c.b] + a.len_offset;
  const int* trow = a.tables + (size_t)c.b * a.NBLK + c.lo_blk;
  for (int i = tid; i < c.hi_blk - c.lo_blk; i += kThreads) tbl[i] = trow[i];
  const TQ* q = static_cast<const TQ*>(a.q);
  if constexpr (kGen) {
    // [16][KP + 8] bf16 or [16][KP] f32, zeros past HD and past the rows
    const int p = kBf16Q ? a.KP + 8 : a.KP;
    for (int i = tid; i < kRows * a.KP; i += kThreads) {
      const int r = i / a.KP, d = i % a.KP;
      const TQ val = r < c.rows && d < a.HD ? q[out_row(a, c, r) * a.HD + d]
                                            : from_f<TQ>(0.f);
      if constexpr (kBf16Q)
        reinterpret_cast<__nv_bfloat16*>(smem)[r * p + d] = val;
      else
        reinterpret_cast<float*>(smem)[r * p + d] = to_f(val);
    }
  } else if constexpr (kBf16Q) {
    using bf16 = __nv_bfloat16;
    bf16* qs = reinterpret_cast<bf16*>(smem);  // [16][HD + 8]
    const int ch = a.HD / 8, p = a.HD + 8;
    for (int i = tid; i < kRows * ch; i += kThreads) {
      const int r = i / ch, d = (i % ch) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < c.rows)
        val = *reinterpret_cast<const uint4*>(q + out_row(a, c, r) * a.HD + d);
      *reinterpret_cast<uint4*>(qs + r * p + d) = val;
    }
  } else {
    float* qs = reinterpret_cast<float*>(smem);  // [16][HD]
    for (int i = tid; i < kRows * a.HD; i += kThreads) {
      const int r = i / a.HD, d = i % a.HD;
      qs[i] = r < c.rows ? to_f(q[out_row(a, c, r) * a.HD + d]) : 0.f;
    }
  }
  // the last position any row of the CTA sees
  const int last = min(c.s0 + (c.r0 + c.rows - 1) / c.n_rep,
                       a.NBLK * a.BS - 1);
  c.hi = min(c.hi_blk * a.BS, last + 1);
  // only with splits > 1 (range 0 holds position 0, which every row sees,
  // but for a decode length of 0: that single range walks no tile and the
  // epilogue writes O = 0 / max(0, 1e-30) = 0)
  if (c.hi <= c.lo && a.splits > 1) {
    if (kGen && blockIdx.z != 0) return false;  // group 0 writes m, l
    const size_t rows = (size_t)a.B * a.W * a.H;
    float* mws = a.ws + (size_t)a.splits * rows * a.HD;
    for (int i = tid; i < c.rows; i += kThreads) {
      const size_t at = blockIdx.y * rows + out_row(a, c, i);
      mws[at] = kNegInf;
      mws[(size_t)a.splits * rows + at] = 0.f;
    }
    return false;
  }
  __syncthreads();
  return true;
}

// Shared epilogue: the four warps' partials (red [4][16][RW], then m, l
// [4][16], written by the bodies; RW = HD, or GW for the general bodies)
// merged in order; the normalised output (one range) or the range's partial
// to the workspace.  kGen: the CTA's columns c0 .. c0 + GW (cut at HD), m
// and l from group 0.
template <typename TQ, bool kGen = false>
__device__ __forceinline__ void epilogue(const Args& a, const Cta& c,
                                         const float* red) {
  const int rw = kGen ? a.GW : a.HD;
  const int c0 = kGen ? blockIdx.z * a.GW : 0;
  const int nc = kGen ? min(a.GW, a.HD - c0) : a.HD;
  const float* rm = red + kWarps * kRows * rw;
  const float* rl = rm + kWarps * kRows;
  const size_t rows = (size_t)a.B * a.W * a.H;
  for (int idx = threadIdx.x; idx < c.rows * nc; idx += kThreads) {
    const int i = idx / nc, d = idx % nc;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, rm[w * kRows + i]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = rm[w * kRows + i];
      if (mw == kNegInf) continue;  // this warp saw nothing of the row
      const float wt = expf(mw - mx);
      lsum += rl[w * kRows + i] * wt;
      o += red[(w * kRows + i) * rw + d] * wt;
    }
    const size_t row = out_row(a, c, i);
    if (a.splits == 1) {
      static_cast<TQ*>(a.out)[row * a.HD + c0 + d] =
          from_f<TQ>(o / fmaxf(lsum, 1e-30f));
    } else {
      const size_t at = blockIdx.y * rows + row;
      a.ws[at * a.HD + c0 + d] = o;
      if (d == 0 && c0 == 0) {
        float* mws = a.ws + (size_t)a.splits * rows * a.HD;
        mws[at] = mx;
        mws[(size_t)a.splits * rows + at] = lsum;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 q over a bf16 pool: mma.sync body.  At HD 16 it asks for 8 CTAs per
// SM (64 registers): left alone, ptxas takes 70, 7 CTAs fit and the
// key-range plan changes.  The 0 leaves every other HD unbounded (an
// explicit 1 moves their registers too).
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 16 ? 8 : 0)
    chunk_mma(const Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int S = stages<bf16>();
  constexpr int P = HD + 8;  // staged row, in elements
  constexpr int KT = HD / 16;
  constexpr int DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Cta c = cta_of(a);
  int* tbl = reinterpret_cast<int*>(smem + kRows * HD * 4);
  unsigned char* ring = smem + kRows * HD * 4 +
                        ((size_t)table_slots(a) * 4 + 15) / 16 * 16;
  if (!prologue<bf16, true>(a, c, smem, tbl)) return;

  const bf16* qs = reinterpret_cast<const bf16*>(smem);
  uint32_t qf[KT][4];
#pragma unroll
  for (int ks = 0; ks < KT; ++ks)
    ldmatrix_x4(qf[ks], qs + (lane & 15) * P + ks * 16 + (lane >> 4) * 8);
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // this thread's rows: lane / 4 (fragment elements 0, 1) and lane / 4 + 8
  const int lim[2] = {limit_of(c, lane >> 2), limit_of(c, (lane >> 2) + 8)};

  walk<bf16, S>(a, c, tbl, ring + warp * S * stage_bytes(HD, 2), warp, lane,
                [&](const unsigned char* st, int t0) {
    const bf16* Kt = reinterpret_cast<const bf16*>(st);
    const bf16* Vt = Kt + kTile * P;
    // S = Q K^T: two n8 tiles of positions
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KT; ++ks) {
      uint32_t kf[4];
      ldmatrix_x4(kf, Kt + ((lane & 7) + (lane >> 4) * 8) * P + ks * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], qf[ks], kf);
      mma_bf16(s[1], qf[ks], kf + 2);
    }
    // scale, mask, one online-softmax update for the tile
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = t0 + j * 8 + (lane & 3) * 2 + (e & 1);
        const bool ok = pos < c.hi && pos <= lim[e >> 1];
        s[j][e] = ok ? s[j][e] * a.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // p: 0 where masked (a row that has seen nothing keeps l = 0); l over
    // the unrounded p, the A fragment of PV rounded to bf16
    uint32_t pf[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = s[j][e] == kNegInf ? 0.f : expf(s[j][e] - mx[e >> 1]);
        l[e >> 1] += p[e];
      }
      pf[j * 2] = pack2(__float2bfloat16(p[0]), __float2bfloat16(p[1]));
      pf[j * 2 + 1] = pack2(__float2bfloat16(p[2]), __float2bfloat16(p[3]));
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }
    // O += P V: V through ldmatrix.trans
#pragma unroll
    for (int d = 0; d < DT; d += 2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, Vt + (lane & 15) * P + d * 8 + (lane >> 4) * 8);
      mma_bf16(acc[d], pf, vf);
      mma_bf16(acc[d + 1], pf, vf + 2);
    }
  });

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();  // every warp is done with its ring
  float* red = reinterpret_cast<float*>(ring);
  float* rm = red + kWarps * kRows * HD;
  float* rl = rm + kWarps * kRows;
  const int col0 = (lane & 3) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = (lane >> 2) + r * 8;
    float* row = red + (warp * kRows + i) * HD;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(row + d * 8 + col0) =
          make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
    if ((lane & 3) == 0) {
      rm[warp * kRows + i] = m[r];
      rl[warp * kRows + i] = l[r];
    }
  }
  __syncthreads();
  epilogue<bf16>(a, c, red);
}

// ---------------------------------------------------------------------------
// f32 q, or an int8 pool: FMA body in f32.  HC: features per lane in PV,
// ceil(HD / 32).
// ---------------------------------------------------------------------------
template <typename TKV>
__device__ __forceinline__ void load8(const TKV* p, float* f);
template <>
__device__ __forceinline__ void load8<float>(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const float4 y = *reinterpret_cast<const float4*>(p + 4);
  f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
  f[4] = y.x, f[5] = y.y, f[6] = y.z, f[7] = y.w;
}
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
}
template <>
__device__ __forceinline__ void load8<int8_t>(const int8_t* p, float* f) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(e[i]);
}

template <typename TQ, typename TKV, int HC, bool kSkipDead>
__global__ void __launch_bounds__(kThreads) chunk_fma(const Args a) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int S = stages<TKV>();
  constexpr int E = sizeof(TKV);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HD = a.HD;
  Cta c = cta_of(a);
  int* tbl = reinterpret_cast<int*>(smem + kRows * HD * 4);
  unsigned char* ring = smem + kRows * HD * 4 +
                        ((size_t)table_slots(a) * 4 + 15) / 16 * 16;
  const int sb = stage_bytes(HD, E);
  // this warp's p [16 rows][16 positions] and per-row rescale factors
  float* ps = reinterpret_cast<float*>(ring + (size_t)kWarps * S * sb) +
              warp * (kRows * kTile + kRows);
  float* as = ps + kRows * kTile;
  if (!prologue<TQ, false>(a, c, smem, tbl)) return;
  const float* qs = reinterpret_cast<const float*>(smem);

  // scores: lane = position j of the tile, rows h8 * 8 .. h8 * 8 + 7
  const int j = lane & 15, h8 = lane >> 4;
  float m[8], l[8];
  int lim[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    lim[i] = limit_of(c, h8 * 8 + i);
  }
  // PV: lane = features lane + 32 * cc, all 16 rows
  float acc[kRows][HC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int cc = 0; cc < HC; ++cc) acc[i][cc] = 0.f;
  const int rbe = row_bytes(HD, E) / E;  // staged row, in elements

  walk<TKV, S>(a, c, tbl, ring + warp * S * sb, warp, lane,
               [&](const unsigned char* st, int t0) {
    const TKV* Kt = reinterpret_cast<const TKV*>(st);
    const TKV* Vt = Kt + kTile * rbe;
    const float* ksc = reinterpret_cast<const float*>(Vt + kTile * rbe);
    const float* vsc = ksc + kTile;
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    const TKV* kr = Kt + j * rbe;
    const float kscale = kQuant ? ksc[j] : 1.f;
#pragma unroll 2
    for (int d0 = 0; d0 < HD; d0 += 8) {
      float kf[8];
      load8<TKV>(kr + d0, kf);
      if constexpr (kQuant) {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] *= kscale;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (kSkipDead && h8 * 8 + i >= c.rows) continue;  // no such row
        const float* qr = qs + (h8 * 8 + i) * HD + d0;
        const float4 qa = *reinterpret_cast<const float4*>(qr);
        const float4 qb = *reinterpret_cast<const float4*>(qr + 4);
        s[i] = fmaf(qa.x, kf[0], s[i]);
        s[i] = fmaf(qa.y, kf[1], s[i]);
        s[i] = fmaf(qa.z, kf[2], s[i]);
        s[i] = fmaf(qa.w, kf[3], s[i]);
        s[i] = fmaf(qb.x, kf[4], s[i]);
        s[i] = fmaf(qb.y, kf[5], s[i]);
        s[i] = fmaf(qb.z, kf[6], s[i]);
        s[i] = fmaf(qb.w, kf[7], s[i]);
      }
    }
    const int pos = t0 + j;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (kSkipDead && i >= c.rows) break;  // neither half has row i
      const bool ok = pos < c.hi && pos <= lim[i];
      const float x = ok ? s[i] * a.scale : kNegInf;
      float mx = x;
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mx = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mx);
      const float p = ok ? expf(x - mx) : 0.f;
      l[i] = l[i] * alpha + p;
      m[i] = mx;
      // f32 p over an int8 or f32 pool; rounded to bf16 over a bf16 pool
      if constexpr (kQuant) ps[(h8 * 8 + i) * kTile + j] = p;
      else ps[(h8 * 8 + i) * kTile + j] = round_as<TKV>(p);
      if (j == 0) as[h8 * 8 + i] = alpha;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (kSkipDead && i >= c.rows) break;
      const float al = as[i];
#pragma unroll
      for (int cc = 0; cc < HC; ++cc) acc[i][cc] *= al;
    }
#pragma unroll
    for (int j4 = 0; j4 < kTile; j4 += 4) {
      float v[4][HC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float vscale = kQuant ? vsc[j4 + jj] : 1.f;
#pragma unroll
        for (int cc = 0; cc < HC; ++cc) {
          const int d = lane + 32 * cc;
          v[jj][cc] = d < HD ? to_f(Vt[(j4 + jj) * rbe + d]) * vscale : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (kSkipDead && i >= c.rows) break;
        const float4 p4 = *reinterpret_cast<const float4*>(ps + i * kTile + j4);
#pragma unroll
        for (int cc = 0; cc < HC; ++cc) {
          acc[i][cc] = fmaf(p4.x, v[0][cc], acc[i][cc]);
          acc[i][cc] = fmaf(p4.y, v[1][cc], acc[i][cc]);
          acc[i][cc] = fmaf(p4.z, v[2][cc], acc[i][cc]);
          acc[i][cc] = fmaf(p4.w, v[3][cc], acc[i][cc]);
        }
      }
    }
  });

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
  __syncthreads();  // every warp is done with its ring
  float* red = reinterpret_cast<float*>(ring);
  float* rm = red + kWarps * kRows * HD;
  float* rl = rm + kWarps * kRows;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int cc = 0; cc < HC; ++cc) {
      const int d = lane + 32 * cc;
      if (d < HD) red[(warp * kRows + i) * HD + d] = acc[i][cc];
    }
  if (j == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      rm[warp * kRows + h8 * 8 + i] = m[i];
      rl[warp * kRows + h8 * 8 + i] = l[i];
    }
  }
  __syncthreads();
  epilogue<TQ>(a, c, red);
}

// ---------------------------------------------------------------------------
// The general bodies (design, 7): any HD, in column groups of GW.
// ---------------------------------------------------------------------------
// one stage of one warp: K tile (rows of KP), V tile (rows of GW: the
// group's columns), then the tile's K and V scales (int8 pools)
__host__ __device__ inline int gen_stage_bytes(int kp, int gw, int esz) {
  return kTile * (kp * esz + 16) + kTile * (gw * esz + 16) + 2 * kTile * 4;
}

// Shared memory of a general body at `stages` ring stages: q rows, the
// table of a one-range walk (the largest), the warps' rings (at least the
// partials red [4][16][GW] + m, l that reuse them), the FMA body's p.
__host__ inline size_t gen_smem_bytes(const Args& a, int esz, int stages,
                                      bool fma) {
  const size_t q = (size_t)kRows * a.KP * 4;
  const size_t tbl = ((size_t)(a.NBLK + 1) * 4 + 15) / 16 * 16;
  size_t ring = (size_t)kWarps * stages * gen_stage_bytes(a.KP, a.GW, esz);
  const size_t red = ((size_t)kWarps * kRows * a.GW + 2 * kWarps * kRows) * 4;
  if (ring < red) ring = red;
  const size_t p = fma ? (size_t)kWarps * (kRows * kTile + kRows) * 4 : 0;
  return q + tbl + ring + p;
}

// The general bodies' geometry for a.HD: KP, GW, the copy unit (16 or 4
// bytes where the rows' alignment allows, else 1) and the most ring stages
// (3, or 2 for f32 pools, down to 1) whose shared memory fits a CTA; false
// when one stage does not fit.  The column groups are ceil(HD / GW).  The
// stages are planned at one key range, so a split launch (a smaller table)
// takes the same ring.
__host__ inline bool plan_general(Args& a, int esz, bool fma) {
  a.KP = (a.HD + 15) / 16 * 16;
  a.GW = kGroupCols;
  const int bytes = a.HD * esz;
  a.unit = bytes % 16 == 0 ? 16 : bytes % 4 == 0 ? 4 : 1;
  for (a.S = esz == 4 ? 2 : 3; a.S >= 1; --a.S)
    if (gen_smem_bytes(a, esz, a.S, fma) <= 227 * 1024) return true;
  return false;
}

__host__ __device__ inline int col_groups(const Args& a) {
  return general_hd(a.HD) ? (a.HD + a.GW - 1) / a.GW : 1;
}

// One U-byte piece of a staged row: cp.async for 16 and 4 bytes
// (zero-filled, the source not read, where !in), a load and a store for 1.
template <int U>
__device__ __forceinline__ void copy_unit(unsigned char* dst,
                                          const unsigned char* src,
                                          bool in) {
  if constexpr (U == 16) {
    cp_async16(dst, src, in ? 16 : 0);
  } else if constexpr (U == 4) {
    cp_async4(dst, src, in ? 4 : 0);
  } else {
    *dst = in ? *src : static_cast<unsigned char>(0);
  }
}

// `n` bytes of each of the tile's 16 pool rows from byte `col` of the row
// into rows of `stride` bytes at dst, in U-byte pieces; rows past hi or in
// the null block are zero-filled and not read.
template <int U>
__device__ __forceinline__ void stage_rows(const Args& a, const Cta& c,
                                           const int* tbl,
                                           const unsigned char* pool,
                                           unsigned char* dst, int stride,
                                           int col, int n, int esz, int t0,
                                           int lane) {
  const int ch = n / U;
  for (int i = lane; i < kTile * ch; i += 32) {
    const int r = i / ch, x = i % ch, pos = t0 + r;
    const int phys = pos < c.hi ? tbl[pos / a.BS - c.lo_blk] : 0;
    const bool in = phys != 0;
    const size_t off =
        (((size_t)phys * a.BS + pos % a.BS) * a.KV + c.g) * a.HD * esz +
        col + x * U;
    copy_unit<U>(dst + r * stride + x * U, in ? pool + off : pool, in);
  }
}

template <int U>
__device__ __forceinline__ void stage_kv_gen(const Args& a, const Cta& c,
                                             const int* tbl,
                                             unsigned char* dst, int esz,
                                             int t0, int lane) {
  const int krb = a.KP * esz + 16, c0 = blockIdx.z * a.GW;
  stage_rows<U>(a, c, tbl, static_cast<const unsigned char*>(a.k), dst, krb,
                0, a.HD * esz, esz, t0, lane);
  stage_rows<U>(a, c, tbl, static_cast<const unsigned char*>(a.v),
                dst + kTile * krb, a.GW * esz + 16, c0 * esz,
                min(a.GW, a.HD - c0) * esz, esz, t0, lane);
}

// Tile [t0, t0 + 16) of the pool into one stage of a general body: K rows
// whole, V rows over the CTA's column group, in the call's copy unit.
template <typename TKV>
__device__ __forceinline__ void stage_tile_gen(const Args& a, const Cta& c,
                                               const int* tbl,
                                               unsigned char* dst, int t0,
                                               int lane) {
  constexpr int E = sizeof(TKV);
  switch (a.unit) {
    case 16: stage_kv_gen<16>(a, c, tbl, dst, E, t0, lane); break;
    case 4: stage_kv_gen<4>(a, c, tbl, dst, E, t0, lane); break;
    default: stage_kv_gen<1>(a, c, tbl, dst, E, t0, lane); break;
  }
  if constexpr (std::is_same<TKV, int8_t>::value) {
    if (lane < kTile) {
      const int pos = t0 + lane;
      const int phys = pos < c.hi ? tbl[pos / a.BS - c.lo_blk] : 0;
      const bool in = phys != 0;
      const size_t row = ((size_t)phys * a.BS + pos % a.BS) * a.KV + c.g;
      float* sd = reinterpret_cast<float*>(
          dst + kTile * (a.KP * E + 16) + kTile * (a.GW * E + 16));
      cp_async4(sd + lane, in ? a.ksc + row : a.ksc, in ? 4 : 0);
      cp_async4(sd + kTile + lane, in ? a.vsc + row : a.vsc, in ? 4 : 0);
    }
  }
}

// The staged rows' tails, which no copy writes: K columns [HD, KP) and the
// group's V columns past HD, zeroed once in each stage of the warp's ring,
// so that QK^T over KP and PV over GW add zeros there.
template <typename TKV>
__device__ __forceinline__ void zero_tails(const Args& a, unsigned char* ring,
                                           int lane) {
  constexpr int E = sizeof(TKV);
  const int krb = a.KP * E + 16, vrb = a.GW * E + 16;
  const int sb = gen_stage_bytes(a.KP, a.GW, E);
  const int vt = min(a.GW, a.HD - (int)blockIdx.z * a.GW) * E;
  for (int i = lane; i < a.S * kTile; i += 32) {
    unsigned char* k = ring + (i / kTile) * sb + (i % kTile) * krb;
    unsigned char* v = ring + (i / kTile) * sb + kTile * krb +
                       (i % kTile) * vrb;
    for (int b = a.HD * E; b < a.KP * E; ++b) k[b] = 0;
    for (int b = vt; b < a.GW * E; ++b) v[b] = 0;
  }
  __syncwarp();
}

template <int N>
__device__ __forceinline__ void wait_upto(int n) {
  if (n >= N) {
    cp_async_wait<N>();
  } else if constexpr (N > 0) {
    wait_upto<N - 1>(n);
  }
}

// walk() for the general bodies: a ring of a.S stages (1-3, chosen by
// plan_general) staged by stage_tile_gen.
template <typename TKV, typename Body>
__device__ __forceinline__ void walk_gen(const Args& a, const Cta& c,
                                         const int* tbl, unsigned char* ring,
                                         int warp, int lane, Body&& body) {
  const int S = a.S;
  const int sb = gen_stage_bytes(a.KP, a.GW, sizeof(TKV));
  const int n_tiles = (c.hi - c.lo + kTile - 1) / kTile;
  const int mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  auto t0_of = [&](int it) { return c.lo + (warp + it * kWarps) * kTile; };
  for (int st = 0; st < S - 1; ++st) {
    if (st < mine)
      stage_tile_gen<TKV>(a, c, tbl, ring + st * sb, t0_of(st), lane);
    cp_async_commit();
  }
  for (int it = 0; it < mine; ++it) {
    const int nxt = it + S - 1;  // in flight during this tile's math
    if (nxt < mine)
      stage_tile_gen<TKV>(a, c, tbl, ring + (nxt % S) * sb, t0_of(nxt),
                          lane);
    cp_async_commit();
    wait_upto<2>(S - 1);  // tile it has landed (this lane's copies)
    __syncwarp();         // ... and every lane's
    body(ring + (it % S) * sb, t0_of(it));
    __syncwarp();  // this stage is free again
  }
}

// bf16 q over a bf16 pool at any HD: the mma.sync body of chunk_mma with q
// read from shared memory each k16 step and PV over the CTA's GW columns.
__global__ void __launch_bounds__(kThreads) chunk_mma_gen(const Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int GW = kGroupCols;
  constexpr int DT = GW / 8;
  constexpr int VR = GW + 8;  // staged V row, in elements
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KR = a.KP + 8;  // staged K row and q row, in elements
  Cta c = cta_of(a);
  int* tbl = reinterpret_cast<int*>(smem + kRows * a.KP * 4);
  unsigned char* ring = smem + kRows * a.KP * 4 +
                        ((size_t)table_slots(a) * 4 + 15) / 16 * 16;
  if (!prologue<bf16, true, true>(a, c, smem, tbl)) return;
  const int sb = gen_stage_bytes(a.KP, GW, 2);
  unsigned char* mine = ring + warp * a.S * sb;
  zero_tails<bf16>(a, mine, lane);

  const bf16* qs = reinterpret_cast<const bf16*>(smem);
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int lim[2] = {limit_of(c, lane >> 2), limit_of(c, (lane >> 2) + 8)};
  const int kt = a.KP / 16;

  walk_gen<bf16>(a, c, tbl, mine, warp, lane,
                 [&](const unsigned char* st, int t0) {
    const bf16* Kt = reinterpret_cast<const bf16*>(st);
    const bf16* Vt = Kt + kTile * KR;
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < kt; ++ks) {
      uint32_t qf[4], kf[4];
      ldmatrix_x4(qf, qs + (lane & 15) * KR + ks * 16 + (lane >> 4) * 8);
      ldmatrix_x4(kf, Kt + ((lane & 7) + (lane >> 4) * 8) * KR + ks * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], qf, kf);
      mma_bf16(s[1], qf, kf + 2);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = t0 + j * 8 + (lane & 3) * 2 + (e & 1);
        const bool ok = pos < c.hi && pos <= lim[e >> 1];
        s[j][e] = ok ? s[j][e] * a.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    uint32_t pf[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = s[j][e] == kNegInf ? 0.f : expf(s[j][e] - mx[e >> 1]);
        l[e >> 1] += p[e];
      }
      pf[j * 2] = pack2(__float2bfloat16(p[0]), __float2bfloat16(p[1]));
      pf[j * 2 + 1] = pack2(__float2bfloat16(p[2]), __float2bfloat16(p[3]));
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }
#pragma unroll
    for (int d = 0; d < DT; d += 2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, Vt + (lane & 15) * VR + d * 8 + (lane >> 4) * 8);
      mma_bf16(acc[d], pf, vf);
      mma_bf16(acc[d + 1], pf, vf + 2);
    }
  });

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();  // every warp is done with its ring
  float* red = reinterpret_cast<float*>(ring);
  float* rm = red + kWarps * kRows * GW;
  float* rl = rm + kWarps * kRows;
  const int col0 = (lane & 3) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = (lane >> 2) + r * 8;
    float* row = red + (warp * kRows + i) * GW;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(row + d * 8 + col0) =
          make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
    if ((lane & 3) == 0) {
      rm[warp * kRows + i] = m[r];
      rl[warp * kRows + i] = l[r];
    }
  }
  __syncthreads();
  epilogue<bf16, true>(a, c, red);
}

// f32 q, or an int8 pool, at any HD: chunk_fma's body over K rows of KP and
// the CTA's GW columns of V (HC = GW / 32 features per lane in PV).  One CTA
// per SM is asked for, so ptxas may take every register a thread can have
// (at most 2 fit by shared memory where HD > 128).
template <typename TQ, typename TKV, bool kSkipDead>
__global__ void __launch_bounds__(kThreads, 1) chunk_fma_gen(const Args a) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int E = sizeof(TKV);
  constexpr int GW = kGroupCols;
  constexpr int HC = GW / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KP = a.KP;
  Cta c = cta_of(a);
  int* tbl = reinterpret_cast<int*>(smem + kRows * KP * 4);
  unsigned char* ring = smem + kRows * KP * 4 +
                        ((size_t)table_slots(a) * 4 + 15) / 16 * 16;
  const int sb = gen_stage_bytes(KP, GW, E);
  const size_t red_bytes =
      ((size_t)kWarps * kRows * GW + 2 * kWarps * kRows) * 4;
  size_t ring_bytes = (size_t)kWarps * a.S * sb;
  if (ring_bytes < red_bytes) ring_bytes = red_bytes;
  float* ps = reinterpret_cast<float*>(ring + ring_bytes) +
              warp * (kRows * kTile + kRows);
  float* as = ps + kRows * kTile;
  if (!prologue<TQ, false, true>(a, c, smem, tbl)) return;
  unsigned char* mine = ring + warp * a.S * sb;
  zero_tails<TKV>(a, mine, lane);
  const float* qs = reinterpret_cast<const float*>(smem);

  const int j = lane & 15, h8 = lane >> 4;
  float m[8], l[8];
  int lim[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    lim[i] = limit_of(c, h8 * 8 + i);
  }
  float acc[kRows][HC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int cc = 0; cc < HC; ++cc) acc[i][cc] = 0.f;
  const int kre = (KP * E + 16) / E;  // staged K row, in elements
  constexpr int vre = (GW * E + 16) / E;

  walk_gen<TKV>(a, c, tbl, mine, warp, lane,
                [&](const unsigned char* st, int t0) {
    const TKV* Kt = reinterpret_cast<const TKV*>(st);
    const TKV* Vt = Kt + kTile * kre;
    const float* ksc = reinterpret_cast<const float*>(Vt + kTile * vre);
    const float* vsc = ksc + kTile;
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    const TKV* kr = Kt + j * kre;
    const float kscale = kQuant ? ksc[j] : 1.f;
#pragma unroll 2
    for (int d0 = 0; d0 < KP; d0 += 8) {
      float kf[8];
      load8<TKV>(kr + d0, kf);
      if constexpr (kQuant) {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] *= kscale;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (kSkipDead && h8 * 8 + i >= c.rows) continue;  // no such row
        const float* qr = qs + (h8 * 8 + i) * KP + d0;
        const float4 qa = *reinterpret_cast<const float4*>(qr);
        const float4 qb = *reinterpret_cast<const float4*>(qr + 4);
        s[i] = fmaf(qa.x, kf[0], s[i]);
        s[i] = fmaf(qa.y, kf[1], s[i]);
        s[i] = fmaf(qa.z, kf[2], s[i]);
        s[i] = fmaf(qa.w, kf[3], s[i]);
        s[i] = fmaf(qb.x, kf[4], s[i]);
        s[i] = fmaf(qb.y, kf[5], s[i]);
        s[i] = fmaf(qb.z, kf[6], s[i]);
        s[i] = fmaf(qb.w, kf[7], s[i]);
      }
    }
    const int pos = t0 + j;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (kSkipDead && i >= c.rows) break;  // neither half has row i
      const bool ok = pos < c.hi && pos <= lim[i];
      const float x = ok ? s[i] * a.scale : kNegInf;
      float mx = x;
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mx = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mx);
      const float p = ok ? expf(x - mx) : 0.f;
      l[i] = l[i] * alpha + p;
      m[i] = mx;
      if constexpr (kQuant) ps[(h8 * 8 + i) * kTile + j] = p;
      else ps[(h8 * 8 + i) * kTile + j] = round_as<TKV>(p);
      if (j == 0) as[h8 * 8 + i] = alpha;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (kSkipDead && i >= c.rows) break;
      const float al = as[i];
#pragma unroll
      for (int cc = 0; cc < HC; ++cc) acc[i][cc] *= al;
    }
#pragma unroll
    for (int j4 = 0; j4 < kTile; j4 += 4) {
      float v[4][HC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float vscale = kQuant ? vsc[j4 + jj] : 1.f;
#pragma unroll
        for (int cc = 0; cc < HC; ++cc)
          v[jj][cc] = to_f(Vt[(j4 + jj) * vre + lane + 32 * cc]) * vscale;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (kSkipDead && i >= c.rows) break;
        const float4 p4 = *reinterpret_cast<const float4*>(ps + i * kTile + j4);
#pragma unroll
        for (int cc = 0; cc < HC; ++cc) {
          acc[i][cc] = fmaf(p4.x, v[0][cc], acc[i][cc]);
          acc[i][cc] = fmaf(p4.y, v[1][cc], acc[i][cc]);
          acc[i][cc] = fmaf(p4.z, v[2][cc], acc[i][cc]);
          acc[i][cc] = fmaf(p4.w, v[3][cc], acc[i][cc]);
        }
      }
    }
  });

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
  __syncthreads();  // every warp is done with its ring
  float* red = reinterpret_cast<float*>(ring);
  float* rm = red + kWarps * kRows * GW;
  float* rl = rm + kWarps * kRows;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int cc = 0; cc < HC; ++cc)
      red[(warp * kRows + i) * GW + lane + 32 * cc] = acc[i][cc];
  if (j == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      rm[warp * kRows + h8 * 8 + i] = m[i];
      rl[warp * kRows + h8 * 8 + i] = l[i];
    }
  }
  __syncthreads();
  epilogue<TQ, true>(a, c, red);
}

// ---------------------------------------------------------------------------
// merge of the key ranges, one thread per output element, ranges in order:
//   m* = max_s m_s, w_s = e^(m_s - m*), O = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30)
// A range in which the row saw nothing (m_s = NEG_INF) weighs 0 and its
// accumulator, never written, is not read.  m* is finite but for a decode
// length of 0, whose every range weighs 0: O = 0.  A row of a dead kv group
// (live_kv) is exact zeros, its workspace never read.
// ---------------------------------------------------------------------------
template <typename TQ>
__global__ void __launch_bounds__(256) chunk_merge(const Args a) {
  const size_t rows = (size_t)a.B * a.W * a.H, n = rows * a.HD;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const size_t row = idx / a.HD;
  if (a.live_kv != nullptr) {
    const int b = static_cast<int>(row / ((size_t)a.W * a.H));
    const int g = static_cast<int>(row % a.H) / (a.H / a.KV);
    if (g >= a.live_kv[b]) {
      static_cast<TQ*>(a.out)[idx] = from_f<TQ>(0.f);
      return;
    }
  }
  const float* mws = a.ws + (size_t)a.splits * n;
  const float* lws = mws + (size_t)a.splits * rows;
  float mx = kNegInf;
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, mws[s * rows + row]);
  float lsum = 0.f, o = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const float ms = mws[s * rows + row];
    if (ms == kNegInf) continue;
    const float w = expf(ms - mx);
    lsum += lws[s * rows + row] * w;
    o += a.ws[s * n + idx] * w;
  }
  static_cast<TQ*>(a.out)[idx] = from_f<TQ>(o / fmaxf(lsum, 1e-30f));
}

// f(kernel, dynamic shared memory) after allowing the kernel that much
template <class Kern, class F>
cudaError_t with_smem(Kern kern, size_t smem, F f) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  return e != cudaSuccess ? e : f(kern, smem);
}

template <class F>
cudaError_t with_mma(const Args& a, F f) {
  const size_t smem = smem_bytes(a, 2, stages<__nv_bfloat16>(), false);
  switch (a.HD) {
    case 16: return with_smem(chunk_mma<16>, smem, f);
    case 32: return with_smem(chunk_mma<32>, smem, f);
    case 48: return with_smem(chunk_mma<48>, smem, f);
    case 64: return with_smem(chunk_mma<64>, smem, f);
    case 80: return with_smem(chunk_mma<80>, smem, f);
    case 96: return with_smem(chunk_mma<96>, smem, f);
    case 112: return with_smem(chunk_mma<112>, smem, f);
    case 128: return with_smem(chunk_mma<128>, smem, f);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV, bool kSkipDead, class F>
cudaError_t with_fma(const Args& a, F f) {
  const size_t smem = smem_bytes(a, sizeof(TKV), stages<TKV>(), true);
  switch ((a.HD + 31) / 32) {
    case 1: return with_smem(chunk_fma<TQ, TKV, 1, kSkipDead>, smem, f);
    case 2: return with_smem(chunk_fma<TQ, TKV, 2, kSkipDead>, smem, f);
    case 3: return with_smem(chunk_fma<TQ, TKV, 3, kSkipDead>, smem, f);
    default: return with_smem(chunk_fma<TQ, TKV, 4, kSkipDead>, smem, f);
  }
}

// the general bodies (any HD): plan_general sets the geometry in `a`
template <class F>
cudaError_t with_mma_gen(Args& a, F f) {
  if (!plan_general(a, 2, false)) return cudaErrorInvalidValue;
  return with_smem(chunk_mma_gen, gen_smem_bytes(a, 2, a.S, false), f);
}

template <typename TQ, typename TKV, bool kSkipDead, class F>
cudaError_t with_fma_gen(Args& a, F f) {
  if (!plan_general(a, sizeof(TKV), true)) return cudaErrorInvalidValue;
  return with_smem(chunk_fma_gen<TQ, TKV, kSkipDead>,
                   gen_smem_bytes(a, sizeof(TKV), a.S, true), f);
}

template <typename TQ, typename TKV, bool kSkipDead, class F>
cudaError_t with_fma_any(Args& a, F f) {
  return general_hd(a.HD) ? with_fma_gen<TQ, TKV, kSkipDead>(a, f)
                          : with_fma<TQ, TKV, kSkipDead>(a, f);
}

// f(kernel, dynamic shared memory) with the walk of the (q, pool) dtype pair
// and a.HD (a.HD a multiple of 16 up to 128: the bodies above; any other:
// the general ones, their geometry planned into `a`); any other pair is
// cudaErrorInvalidValue.  kSkipDead: the FMA
// body skips the rows past a CTA's live rows (decode, where n_rep < 16
// leaves most of the 16 dead); the chunk kernel, whose CTAs hold 16 live
// rows but at the edge, keeps the unconditional body.  Each is the faster
// body for its kernel (H100, serving shape, hd 64, int8 pool: decode's
// walk 14.1 us with the skip against 20.5 without; the chunk's 27.8
// without against 33.3 with, and 42.0 against 79.6 at one key range).
template <bool kSkipDead, class F>
cudaError_t with_walk(Args& a, int q_dtype, int kv_dtype, F f) {
  if (q_dtype == 1 && kv_dtype == 1)
    return general_hd(a.HD) ? with_mma_gen(a, f) : with_mma(a, f);
  if (q_dtype == 0 && kv_dtype == 0)
    return with_fma_any<float, float, kSkipDead>(a, f);
  if (q_dtype == 0 && kv_dtype == 1)
    return with_fma_any<float, __nv_bfloat16, kSkipDead>(a, f);
  if (q_dtype == 0 && kv_dtype == 2)
    return with_fma_any<float, int8_t, kSkipDead>(a, f);
  if (q_dtype == 1 && kv_dtype == 2)
    return with_fma_any<__nv_bfloat16, int8_t, kSkipDead>(a, f);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_merge(const Args& a, cudaStream_t s) {
  const size_t n = (size_t)a.B * a.W * a.H * a.HD;
  chunk_merge<TQ><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(a);
  return cudaGetLastError();
}

// One call of the walk on `stream`: the operands checked, the walk
// launched on the grid (B * KV * row tiles, splits), and with splits > 1
// the merge kernel after it.  dtype codes: 0 = float32, 1 = bfloat16,
// 2 = int8.  Taken: (q, pool) in {(f32, f32), (f32, bf16), (bf16, bf16),
// (f32, int8), (bf16, int8)}; an int8 pool needs both scale pools, a float
// pool takes none.  HD: any whose CTA fits in shared memory (the general
// bodies add a third grid dimension, the column groups).  splits: key
// ranges (>= 1); with splits > 1, ws holds splits * B * W * H * (HD + 2)
// floats.  live_kv: [B] int32, or null for no masking.
template <bool kSkipDead>
int launch_walk(const void* q, const void* k_pool, const void* v_pool,
                const float* k_scale, const float* v_scale, const int* tables,
                const int* start, int len_offset, const int* live_kv,
                void* out, void* ws, int B,
                int W, int H, int KV, int HD, int BS, int NBLK, int splits,
                int q_dtype, int kv_dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || W <= 0 || KV <= 0 || H % KV || BS <= 0 || NBLK <= 0 ||
      HD <= 0 || splits < 1 || splits > 65535 || splits > NBLK ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  if ((kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return cudaErrorInvalidValue;
  const int rows = W * (H / KV);
  Args a{q,      k_pool,  v_pool, k_scale, v_scale, tables,
         start,  live_kv, out,
         splits > 1 ? static_cast<float*>(ws) : nullptr,
         B,      W,       H,      KV,      HD,      BS,
         NBLK,   splits,  (rows + kRows - 1) / kRows, len_offset, scale};
  if ((long long)B * KV * a.row_tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaError_t e =
      with_walk<kSkipDead>(a, q_dtype, kv_dtype, [&](auto kern,
                                                      size_t smem) {
        kern<<<dim3(a.B * a.KV * a.row_tiles, a.splits, col_groups(a)),
               kThreads, smem, s>>>(a);
        return cudaGetLastError();
      });
  if (e != cudaSuccess || splits == 1) return e;
  return q_dtype == 0 ? launch_merge<float>(a, s)
                      : launch_merge<__nv_bfloat16>(a, s);
}

// The walk's CTAs resident on one SM (its shared memory at one key range,
// its registers and threads) for the (q, pool) dtype pair at HD and NBLK:
// the wave that the wrappers' split plan fills.  An HD whose CTA does not
// fit in shared memory is cudaErrorInvalidValue.
template <bool kSkipDead>
int walk_resident_ctas(int HD, int NBLK, int q_dtype, int kv_dtype,
                       int* ctas) {
  if (HD <= 0 || NBLK <= 0 || ctas == nullptr) return cudaErrorInvalidValue;
  Args a{};
  a.HD = HD;
  a.NBLK = NBLK;
  a.splits = 1;
  return with_walk<kSkipDead>(a, q_dtype, kv_dtype, [&](auto kern,
                                                      size_t smem) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kern,
                                                         kThreads, smem);
  });
}

}  // namespace
