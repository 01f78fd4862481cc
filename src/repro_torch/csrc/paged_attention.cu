// One-token paged decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py `paged_decode_attention`
// (the Pallas `_paged_kernel`): a (sequence, kv head, block) grid whose
// block-table walk rides scalar-prefetched index maps and whose online
// softmax state (m, l, acc) is carried across the block axis in VMEM
// scratch; the query group is padded to 8 rows, head_dim to 128 lanes, the
// pool swapped to kv-major, and whole null blocks are masked to -inf.
//
// Bound on the H100: bytes.  Every live K and V row is read once, 2 * sum
// of lengths * KV * HD * 2 bytes per layer in bf16 (qwen1.5-0.5b, 8
// sequences of 1-512 positions, 1952 in all: 8.0 MB, 2.4 us at 3.35 TB/s),
// against 4 * sum of lengths * H * HD operations (8 MFLOP).  An int8 pool
// (the int8 cache codec) stores a row as HD int8 values plus one float
// scale, 68 bytes instead of 128 at HD = 64.  One CTA per (sequence, kv
// head) walking the whole table in series is bound by latency (128 CTAs
// at the serving shape, under one per SM, the slot of 512 positions
// setting the time), so the design is parallelism over the table:
//
// Design: the split-KV walk of csrc/split_walk.cuh at W = 1.  A CTA's 16
// query rows hold the n_rep query heads of one kv group (the reference's
// query group: GQA fills them; at MHA one row is live and the tensor cores
// do 16 rows' work for it, which costs nothing a byte-bound kernel feels,
// while the f32 FMA body skips the dead rows).  The grid is (B * KV * row
// tiles, key ranges) with the key ranges planned from the shapes and this
// walk's occupancy alone (kv_splits), so each CTA walks a few tiles
// through its warps' cp.async rings and a merge kernel combines the
// ranges.  The walk reads lengths as they are (len_offset -1: the query
// sits at lengths[b] - 1) and stops after the sequence's last live
// position: no block past it, null-block entries included, is read.
#include "split_walk.cuh"

// lengths[b]: live positions of sequence b (its cache index + 1).
// k_scale / v_scale: [NB, BS, KV] float for an int8 pool, else null.
// live_kv: [B] live kv groups per sequence (multi-topology serving), or
// null; a CTA of a dead group reads nothing and its rows are exact zeros.
// splits, ws: as for chunked_prefill_attention.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* lengths, const int* live_kv, void* out, void* ws, int B,
    int H, int KV, int HD, int BS, int NBLK, int splits, int q_dtype,
    int kv_dtype, float scale, void* stream) {
  return launch_walk</*kSkipDead=*/true>(
      q, k_pool, v_pool, k_scale, v_scale, tables, lengths,
      /*len_offset=*/-1, live_kv, out, ws, B, /*W=*/1, H, KV, HD, BS, NBLK,
      splits, q_dtype, kv_dtype, scale, stream);
}

// Decode's own walk's CTAs resident on one SM (its FMA body skips dead rows
// and so takes other registers than the chunk kernel's: 128-168 against
// 142-205, 4 CTAs per SM instead of 3 over an int8 pool at hd 64).
extern "C" int paged_decode_resident_ctas(int HD, int NBLK, int q_dtype,
                                          int kv_dtype, int* ctas) {
  return walk_resident_ctas</*kSkipDead=*/true>(HD, NBLK, q_dtype,
                                                kv_dtype, ctas);
}
