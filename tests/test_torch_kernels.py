"""The port's kernels against the JAX reference's Pallas kernels.

On the CPU every wrapper runs its kernel's plain PyTorch version; each is
held here against the reference Pallas kernel run in interpret mode, on
the same numpy inputs made from a seed.  Inputs cover ragged lengths,
null-block table entries past each length, block tables in random order,
GQA n_rep in {1, 4}, head_dim in {16, 64}, and matmul shapes that divide
no tile.  Tolerance: float32 inputs at 2e-6 (relative to the largest
reference value for the matmul), the reference kernels' own tolerance;
differences are summation order only.

The kernels themselves run only on a CUDA card (``cuda`` marker).  This
module imports the JAX reference only inside its fixture, so the card
tests also run where JAX is absent:
``python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels import tiled_matmul as tm_mod
from repro_torch.kernels.chunked_prefill import (
    chunked_prefill_attention, chunked_prefill_attention_plain)
from repro_torch.kernels.paged_attention import (
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.qkv_proj import qkv_proj
from repro_torch.kernels.tiled_matmul import (
    matmul, tiled_matmul, tiled_matmul_plain)
from test_torch_threads import one_thread  # noqa: F401 (autouse)

F32_TOL = 2e-6


@pytest.fixture(scope="module")
def ref():
    """The reference's Pallas kernels (interpret mode on the CPU)."""
    import jax.numpy as jnp

    from repro.kernels.chunked_prefill import chunked_prefill_attention
    from repro.kernels.paged_attention import paged_decode_attention
    from repro.kernels.tiled_matmul import tiled_matmul
    return types.SimpleNamespace(jnp=jnp, matmul=tiled_matmul,
                                 decode=paged_decode_attention,
                                 chunk=chunked_prefill_attention)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# tiled_matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,K,N,blocks", [
    (77, 300, 199, (32, 128, 64)),   # divides no tile
    (5, 64, 33, (8, 32, 32)),        # decode-like skinny M
    (128, 96, 160, (64, 64, 128)),   # mixed-step M, ragged K / N tiles
])
def test_tiled_matmul_plain_matches_pallas(ref, M, K, N, blocks):
    rs = np.random.RandomState(M + K + N)
    a = rs.randn(M, K).astype(np.float32)
    b = rs.randn(K, N).astype(np.float32)
    jnp = ref.jnp
    want = np.asarray(ref.matmul(jnp.asarray(a), jnp.asarray(b),
                                 bm=blocks[0], bk=blocks[1], bn=blocks[2],
                                 interpret=True))
    got = tiled_matmul(_t(a), _t(b)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_TOL * np.abs(want).max())


def test_tiled_matmul_bf16_output_in_a_dtype(ref):
    """bf16 operands: f32 accumulate, one rounding to bf16 on the way out
    (at most one bf16 step, 2^-8 relative, from the reference)."""
    rs = np.random.RandomState(3)
    a = rs.randn(9, 70).astype(np.float32)
    b = rs.randn(70, 40).astype(np.float32)
    jnp = ref.jnp
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = np.asarray(ref.matmul(ja, jb, bm=8, bk=32, bn=32, interpret=True),
                      np.float32)
    got = tiled_matmul(_t(a).bfloat16(), _t(b).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                               atol=1e-6)


def test_matmul_folds_leading_dims():
    rs = np.random.RandomState(4)
    x = _t(rs.randn(2, 3, 5, 12).astype(np.float32))
    w = _t(rs.randn(12, 7).astype(np.float32))
    got = matmul(x, w)
    assert got.shape == (2, 3, 5, 7)
    np.testing.assert_allclose(got.numpy(), (x @ w).numpy(), rtol=1e-6,
                               atol=1e-6)


def test_wrappers_reject_bad_operands_and_other_devices():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="do not form a matmul"):
        tiled_matmul(a, torch.zeros(7, 3))
    with pytest.raises(ValueError, match="dtypes"):
        tiled_matmul(a, torch.zeros(8, 3, dtype=torch.float64))
    # no silent fallback: a tensor on neither the CPU nor CUDA raises
    with pytest.raises(ValueError, match="CUDA tensors"):
        tiled_matmul(a.to("meta"), torch.zeros(8, 3, device="meta"))
    q = torch.zeros(2, 1, 4, 16)
    pool = torch.zeros(5, 8, 2, 16)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    start = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="block_tables"):
        chunked_prefill_attention(q, pool, pool, bt.long(), start)
    with pytest.raises(ValueError, match="dtypes"):
        chunked_prefill_attention(q.bfloat16(), pool, pool, bt, start)
    with pytest.raises(ValueError, match="CUDA tensors"):
        chunked_prefill_attention(q.to("meta"), pool.to("meta"),
                                  pool.to("meta"), bt.to("meta"),
                                  start.to("meta"))
    with pytest.raises(ValueError, match=r"\[B, h, hd\]"):
        paged_decode_attention(q, pool, pool, bt, start)


def test_plain_path_counts_no_launch():
    before = (tiled_matmul.launches, paged_decode_attention.launches,
              chunked_prefill_attention.launches)
    tiled_matmul(torch.ones(2, 3), torch.ones(3, 4))
    q = torch.zeros(1, 2, 16)
    pool = torch.zeros(3, 8, 2, 16)
    bt = torch.ones(1, 2, dtype=torch.int32)
    paged_decode_attention(q, pool, pool, bt,
                           torch.ones(1, dtype=torch.int32))
    chunked_prefill_attention(q[:, None], pool, pool, bt,
                              torch.zeros(1, dtype=torch.int32))
    assert (tiled_matmul.launches, paged_decode_attention.launches,
            chunked_prefill_attention.launches) == before


# ---------------------------------------------------------------------------
# paged attention: decode and chunk
# ---------------------------------------------------------------------------
def _paged_case(seed, B, h, kv, hd, bs, nblk, reach):
    """Pool + block tables in random order; entries past each sequence's
    reach point at the null block (row 0)."""
    rs = np.random.RandomState(seed)
    nb = B * nblk + 1
    kp = rs.randn(nb, bs, kv, hd).astype(np.float32)
    vp = rs.randn(nb, bs, kv, hd).astype(np.float32)
    bt = (rs.permutation(nb - 1) + 1)[:B * nblk].reshape(B, nblk)
    for b, r in enumerate(reach):
        bt[b, -(-r // bs):] = 0
    return rs, kp, vp, bt.astype(np.int32)


ATTN_SHAPES = [  # (h, kv, hd)
    (4, 4, 16), (4, 1, 16), (8, 2, 64), (16, 16, 64)]


@pytest.mark.parametrize("h,kv,hd", ATTN_SHAPES)
def test_paged_decode_plain_matches_pallas(ref, h, kv, hd):
    B, bs, nblk = 4, 8, 5
    lengths = np.array([1, 8, 13, 40], np.int32)      # ragged, full table
    rs, kp, vp, bt = _paged_case(h * 7 + hd, B, h, kv, hd, bs, nblk, lengths)
    q = rs.randn(B, h, hd).astype(np.float32)
    jnp = ref.jnp
    want = np.asarray(ref.decode(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(bt),
                                 jnp.asarray(lengths), interpret=True))
    got = paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                 _t(lengths)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("h,kv,hd", ATTN_SHAPES)
def test_chunked_prefill_plain_matches_pallas(ref, h, kv, hd):
    B, W, bs, nblk = 4, 6, 8, 5
    start = np.array([0, 5, 16, 37], np.int32)   # last slot overruns the table
    rs, kp, vp, bt = _paged_case(h * 11 + hd, B, h, kv, hd, bs, nblk,
                                 np.minimum(start + W, nblk * bs))
    q = rs.randn(B, W, h, hd).astype(np.float32)
    jnp = ref.jnp
    want = np.asarray(ref.chunk(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(bt),
                                jnp.asarray(start), interpret=True))
    got = chunked_prefill_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                    _t(start)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_paged_attention_bf16_pool_matches_pallas(ref):
    """f32 queries over a bf16 pool (the f32-compute serving layout): p is
    rounded to bf16 per block exactly as the reference kernel rounds it."""
    B, W, h, kv, hd, bs, nblk = 3, 4, 8, 2, 16, 8, 4
    start = np.array([3, 9, 28], np.int32)
    rs, kp, vp, bt = _paged_case(21, B, h, kv, hd, bs, nblk, start + W)
    q = rs.randn(B, W, h, hd).astype(np.float32)
    jnp = ref.jnp
    jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (kp, vp))
    tk, tv = (_t(a).bfloat16() for a in (kp, vp))
    want = np.asarray(ref.chunk(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                                jnp.asarray(start), interpret=True))
    got = chunked_prefill_attention(_t(q), tk, tv, _t(bt), _t(start))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    ref_d = np.asarray(ref.decode(jnp.asarray(q[:, 0]), jk, jv,
                                  jnp.asarray(bt), jnp.asarray(start + 1),
                                  interpret=True))
    got_d = paged_decode_attention(_t(q[:, 0]), tk, tv, _t(bt),
                                   _t(start + 1))
    np.testing.assert_allclose(got_d.numpy(), ref_d, atol=1e-5, rtol=1e-5)


def test_decode_is_the_one_lane_chunk():
    B, h, kv, hd, bs, nblk = 3, 4, 2, 16, 8, 3
    lengths = np.array([2, 9, 24], np.int32)
    rs, kp, vp, bt = _paged_case(5, B, h, kv, hd, bs, nblk, lengths)
    q = _t(rs.randn(B, h, hd).astype(np.float32))
    a = paged_decode_attention_plain(q, _t(kp), _t(vp), _t(bt), _t(lengths))
    b = chunked_prefill_attention_plain(q[:, None], _t(kp), _t(vp), _t(bt),
                                        _t(lengths) - 1)[:, 0]
    assert torch.equal(a, b)


def test_unseen_pool_rows_never_reach_the_output():
    """Table entries past a sequence's reach point at the null block; NaN
    there (or in the unseen tail of a live block) must not leak."""
    B, W, h, kv, hd, bs, nblk = 2, 3, 4, 4, 16, 8, 4
    start = np.array([2, 10], np.int32)
    rs, kp, vp, bt = _paged_case(8, B, h, kv, hd, bs, nblk, start + W)
    clean = chunked_prefill_attention(
        _t(rs.randn(B, W, h, hd).astype(np.float32)), _t(kp), _t(vp),
        _t(bt), _t(start))
    rs2, kp2, vp2, _ = _paged_case(8, B, h, kv, hd, bs, nblk, start + W)
    q2 = _t(rs2.randn(B, W, h, hd).astype(np.float32))
    kp2[0] = vp2[0] = np.nan
    for b, s in enumerate(start):
        last = s + W - 1
        blk, off = bt[b, last // bs], last % bs
        kp2[blk, off + 1:] = vp2[blk, off + 1:] = np.nan
    got = chunked_prefill_attention(q2, _t(kp2), _t(vp2), _t(bt), _t(start))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, clean)


# ---------------------------------------------------------------------------
# the kernels on the card (run where a CUDA device is present)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    runtime.build()
    rs = np.random.RandomState(0)
    # the six bf16 serving shapes (a decode and a mixed step against each
    # weight shape), ragged shapes (K = 300 in one range; K = 2000 in 7
    # ranges, the last one ragged; K = 1000, N = 67: element loads, 3
    # ranges) and f32; a second run must give the same bits
    shapes = [((m, k, n), torch.bfloat16) for m in (8, 128)
              for k, n in ((1024, 1024), (1024, 2816), (2816, 1024))]
    shapes += [((77, 300, 199), torch.float32),
               ((77, 300, 199), torch.bfloat16),
               ((8, 2000, 136), torch.bfloat16),
               ((5, 1000, 67), torch.bfloat16)]
    for (M, K, N), dt in shapes:
        a = _t(rs.randn(M, K).astype(np.float32)).to(dev, dt)
        b = _t((rs.randn(K, N) / np.sqrt(K)).astype(np.float32)).to(dev, dt)
        ref = tiled_matmul_plain(a, b).float()
        tol = (1e-5 if dt == torch.float32 else 2 ** -7) * ref.abs().max()
        got = tiled_matmul(a, b)
        assert tm_mod.launched_grid()[1] == (
            tm_mod.k_splits(M, K) if dt == torch.bfloat16 else 1)
        assert (got.float() - ref).abs().max() <= tol, (M, K, N, dt)
        assert torch.equal(got, tiled_matmul(a, b)), (M, K, N, dt)
    # qkv_proj bit for bit three tiled_matmuls, MHA and GQA, with a split
    for M, D, nq, nkv in ((128, 1024, 1024, 1024), (128, 2048, 2048, 256),
                          (8, 1024, 1024, 128)):
        x = _t(rs.randn(M, D).astype(np.float32)).to(dev, torch.bfloat16)
        ws = [_t((rs.randn(D, n) / np.sqrt(D)).astype(np.float32))
              .to(dev, torch.bfloat16) for n in (nq, nkv, nkv)]
        assert tm_mod.k_splits(M, D) > 1
        for o, w in zip(qkv_proj(x, *ws), ws, strict=True):
            assert torch.equal(o, tiled_matmul(x, w))
    # a split launch makes no host sync
    a = torch.randn(128, 1024, device=dev).bfloat16()
    b = torch.randn(1024, 2816, device=dev).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tiled_matmul(a, b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for h, kv, hd in ATTN_SHAPES:
        B, W, bs, nblk = 4, 6, 8, 5
        start = np.array([0, 5, 16, 37], np.int32)
        _, kp, vp, bt = _paged_case(h + hd, B, h, kv, hd, bs, nblk,
                                    np.minimum(start + W, nblk * bs))
        q = _t(rs.randn(B, W, h, hd).astype(np.float32)).to(dev)
        args = [_t(x).to(dev) for x in (kp, vp, bt, start)]
        torch.testing.assert_close(
            chunked_prefill_attention(q, *args),
            chunked_prefill_attention_plain(q, *args), atol=2e-5, rtol=2e-5)
        qd, lens = q[:, 0].contiguous(), args[3] + 1
        torch.testing.assert_close(
            paged_decode_attention(qd, *args[:3], lens),
            paged_decode_attention_plain(qd, *args[:3], lens),
            atol=2e-5, rtol=2e-5)
