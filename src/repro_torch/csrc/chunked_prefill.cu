// W-lane chunked-prefill / decode attention over the paged pool for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/chunked_prefill.py `chunked_prefill_attention`
// (the Pallas `_chunk_kernel`): a (sequence, kv head, lane, block) grid with
// the block table scalar-prefetched, one lane's query group per program, the
// (m, l, acc) state carried across the block axis in VMEM scratch, rows and
// head_dim padded to the TPU tile, and every block masked to -inf past the
// lane's position.
//
// Bound on the H100: the K/V rows up to each sequence's last lane are read
// once, 2 * B * (start + W) * kv * hd * 2 bytes per layer in bf16 (8
// sequences near 512 positions at qwen1.5-0.5b widths: ~17 MB, ~5 us at
// 3.35 TB/s), against 4 * B * W * h * len * hd FLOPs (16 lanes: 0.27 GFLOP,
// 0.27 us at 989 TFLOP/s), so the kernel is bound by K/V bytes.
//
// Design: the shared walk of csrc/paged_walk.cuh.  One CTA per (sequence,
// kv head) holds all W lanes x n_rep query heads, so each K/V row is read
// from device memory once for the whole chunk instead of once per lane as
// the per-lane TPU grid does; the walk stops after the last position the
// chunk's last lane can see.  At W = 1 it computes what
// paged_decode_attention computes.
#include "paged_walk.cuh"

// start[b]: cache position of lane 0; lane l sees positions <= start[b] + l.
extern "C" int chunked_prefill_attention(const void* q, const void* k_pool,
                                         const void* v_pool, const int* tables,
                                         const int* start, void* out, int B,
                                         int W, int H, int KV, int HD, int BS,
                                         int NBLK, int q_dtype, int kv_dtype,
                                         float scale, void* stream) {
  return launch(q_dtype, kv_dtype, HD, q, k_pool, v_pool, tables, start,
                /*len_offset=*/0, out, B, W, H, KV, BS, NBLK, scale, stream);
}
