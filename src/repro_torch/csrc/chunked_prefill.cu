// W-lane chunked-prefill attention over the paged pool for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/chunked_prefill.py `chunked_prefill_attention`
// (the Pallas `_chunk_kernel`): a (sequence, kv head, lane, block) grid with
// the block table scalar-prefetched, one lane's query group per program, the
// (m, l, acc) state carried across the block axis in VMEM scratch, rows and
// head_dim padded to the TPU tile, and every block masked to -inf past the
// lane's position.  Its numerics are the walk's (csrc/split_walk.cuh).
//
// Bound on the H100: bytes.  The K/V rows up to each sequence's last lane
// are read once, 2 * B * (start + W) * KV * HD * 2 bytes per layer in bf16
// (8 sequences up to 512 positions at qwen1.5-0.5b widths: ~7 MB, ~2 us at
// 3.35 TB/s; an int8 row is HD + 4 bytes), against 4 * B * W * H * len * HD
// operations, under a microsecond on the tensor cores.  A single CTA walking
// a sequence's whole table in series is bound by latency instead, so the
// design is about parallelism and latency: the split-KV walk of
// csrc/split_walk.cuh (key ranges of whole blocks planned from the shapes,
// 16 query rows per CTA, cp.async rings in the pool's dtype, bf16 mma.sync,
// a merge kernel over the ranges).  Lane 0 of sequence b sits at start[b]
// (len_offset 0).
#include "split_walk.cuh"

// live_kv: [B] live kv groups per sequence (multi-topology serving), or
// null; every output row of a group g >= live_kv[b] is exact zeros.
extern "C" int chunked_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* start, const int* live_kv, void* out, void* ws, int B, int W,
    int H, int KV, int HD, int BS, int NBLK, int splits, int q_dtype,
    int kv_dtype, float scale, void* stream) {
  return launch_walk</*kSkipDead=*/false>(
      q, k_pool, v_pool, k_scale, v_scale, tables, start, /*len_offset=*/0,
      live_kv, out, ws, B, W, H, KV, HD, BS, NBLK, splits, q_dtype, kv_dtype,
      scale, stream);
}

// The walk's CTAs resident on one SM for the (q, pool) dtype pair at HD and
// NBLK: the wave that the wrapper's split plan fills.
extern "C" int chunked_prefill_resident_ctas(int HD, int NBLK, int q_dtype,
                                             int kv_dtype, int* ctas) {
  return walk_resident_ctas</*kSkipDead=*/false>(HD, NBLK, q_dtype,
                                                kv_dtype, ctas);
}
