// One-token paged decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention.py `paged_decode_attention`
// (the Pallas `_paged_kernel`): a (sequence, kv head, block) grid whose
// block-table walk rides scalar-prefetched index maps and whose online
// softmax state (m, l, acc) is carried across the block axis in VMEM
// scratch; the query group is padded to 8 rows, head_dim to 128 lanes, the
// pool swapped to kv-major, and whole null blocks are masked to -inf.
//
// Bound on the H100: every live K and V row is read once, 2 * B * len * kv *
// hd * 2 bytes per layer in bf16 (for qwen1.5-0.5b, 8 sequences of 512
// positions: 16.8 MB, 5.0 us at 3.35 TB/s), against 4 * B * h * len * hd
// FLOPs (16.8 MFLOP), so the kernel is bound by K/V bytes.
//
// Design: the shared walk of csrc/paged_walk.cuh with one query lane; one
// CTA per (sequence, kv head) with its n_rep query heads reads its own block
// table and stops after the sequence's last live position, so no block past
// the length (null-block entries included) is read.  The pool is read in
// its [NB, bs, kv, hd] layout as stored; there is no padding.
#include "paged_walk.cuh"

// lengths[b]: live positions of sequence b (its cache index + 1).
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const int* tables,
                                      const int* lengths, void* out, int B,
                                      int H, int KV, int HD, int BS, int NBLK,
                                      int q_dtype, int kv_dtype, float scale,
                                      void* stream) {
  return launch(q_dtype, kv_dtype, HD, q, k_pool, v_pool, tables, lengths,
                /*len_offset=*/-1, out, B, /*W=*/1, H, KV, BS, NBLK, scale,
                stream);
}
