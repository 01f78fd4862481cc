"""The port's fully-quantized serving path against the JAX reference.

int8 weights (``quant="int8"``, dense kernels per column, the embedding
table per row) and the int8 KV pool (``kv_dtype="int8"``, one float32
scale per (position, kv head)), on the CPU, where every wrapper runs its
kernel's plain PyTorch version and the reference's Pallas kernels run in
interpret mode.  Inputs are made from a seed with numpy; the reduced
qwen1.5-0.5b quantizes every eligible leaf (``quant_min_size=1``).

* The quantizers (``quantize``, ``quantize_dynamic``, ``quantize_params``,
  ``CacheCodec.encode``) are bit-identical to the reference's, zero rows
  and exact ``.5`` ties included.
* ``int8_matmul`` and ``quantized_dense`` against the Pallas
  ``int8_matmul``: the integer sums are exact, and the float32 outputs
  agree to 1e-6 relative (the same epilogue, ``acc * (sx * sw)``).
* The kernel's plan (``int8_plan``: BN and a split of K into ranges of
  whole 32-deep slices) at the serving shapes and at ragged K, and the
  split in plain PyTorch (each range's int32 partial sums, their total,
  the epilogue) bit for bit against the Pallas ``int8_matmul`` at every
  split count the plan can take.
* The paged attention kernels over an int8 pool with its scales against
  both Pallas kernels: 2e-6 for float32 q (summation order only).
* ``mixed_step``/``decode_step`` of the fully-quantized model, and the
  engine's greedy streams and events, against the reference's.

The kernels themselves run only on a CUDA card (``cuda`` marker).  This
module imports the JAX reference only inside its fixtures, so the card
tests also run where JAX is absent:
``python -m pytest -q --noconftest -m cuda tests/test_torch_quant.py``.
"""
import itertools
import types
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.core import quant as tq
from repro_torch.core import masking
from repro_torch.core.kv_quant import CacheCodec, cache_put, last_writer
from repro_torch.core.paging import PagingConfig
from repro_torch.core.serve_quant import quantize_params
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec)
from repro_torch.kernels import int8_matmul as i8
from repro_torch.kernels import runtime
from repro_torch.kernels.chunked_prefill import (
    chunked_prefill_attention, chunked_prefill_attention_plain)
from repro_torch.kernels.int8_matmul import (int8_matmul, int8_matmul_plain,
                                             quantized_dense)
from repro_torch.kernels.paged_attention import (
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.models.attention import paged_write_slot
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from test_torch_threads import one_thread  # noqa: F401 (autouse)

CFG = reduced(get_config("qwen1.5-0.5b"))
F32_TOL = 2e-6
INT8 = CacheCodec("int8")
ATTN_SHAPES = [  # (h, kv, hd), as tests/test_torch_kernels.py
    (4, 4, 16), (4, 1, 16), (8, 2, 64), (16, 16, 64)]


@pytest.fixture(scope="module")
def ref():
    """The reference's quantizers, Pallas kernels (interpret mode on the
    CPU), model and engine surface."""
    import jax
    import jax.numpy as jnp

    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import kv_quant, quant, serve_quant
    from repro.core import spec as j_spec
    from repro.core.paging import PagingConfig as JPagingConfig
    from repro.kernels import ops
    from repro.kernels.chunked_prefill import chunked_prefill_attention
    from repro.kernels.int8_matmul import int8_matmul as j_int8_matmul
    from repro.kernels.paged_attention import paged_decode_attention
    from repro.models.model import Model as JModel
    from repro.models.model import ModelOptions
    from repro.serving.engine import ServingEngine as JServingEngine
    cfg = j_reduced(REGISTRY["qwen1.5-0.5b"])
    params = JModel(cfg).init(jax.random.PRNGKey(0))
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, quant=quant, serve_quant=serve_quant,
        kv_quant=kv_quant, ops=ops, int8_matmul=j_int8_matmul,
        decode=paged_decode_attention, chunk=chunked_prefill_attention,
        cfg=cfg, params=params, model=JModel, options=ModelOptions,
        paging=JPagingConfig, spec=j_spec, engine=JServingEngine,
        np_tree=lambda tree: jax.tree.map(np.asarray, tree))


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(got: torch.Tensor, want) -> None:
    """Bit-identical: same dtype, shape and values."""
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# (a) the quantizers, bit for bit
# ---------------------------------------------------------------------------
def _rows_with_ties(seed: int) -> np.ndarray:
    """[6, 40] float32: random rows, a zero row, and two rows whose scale is
    exact (amax 127 -> scale 1, amax 63.5 -> scale 0.5) with values on
    exact .5 ties of x / scale, which round half to even."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(6, 40) * 3).astype(np.float32)
    x[1] = 0.0
    x[2] = np.concatenate([[127.0], np.arange(-19.5, 19.5, 1.0)])
    x[3] = np.concatenate([[63.5], np.arange(-9.75, 9.75, 0.5)])
    return x.astype(np.float32)


@pytest.mark.parametrize("axis", [-1, 0, None])
def test_quantize_is_bit_identical(ref, axis):
    x = _rows_with_ties(5)
    want = ref.quant.quantize(ref.jnp.asarray(x), axis=axis)
    got = tq.quantize(_t(x), axis=axis)
    _same(got.values, want.values)
    _same(got.scale, want.scale)
    np.testing.assert_array_equal(tq.dequantize(got).numpy(),
                                  np.asarray(ref.quant.dequantize(want)))


def test_quantize_dynamic_and_ties_round_half_even(ref):
    x = _rows_with_ties(3)
    want = ref.quant.quantize_dynamic(ref.jnp.asarray(x))
    got = tq.quantize_dynamic(_t(x))
    _same(got.values, want.values)
    _same(got.scale, want.scale)
    assert got.scale.dim() == 0
    # per-row: the tie rows land on even integers, the zero row on zeros
    q = tq.quantize(_t(x), axis=0).values
    assert q[1].abs().max() == 0
    assert q[2, 1:5].tolist() == [-20, -18, -18, -16]   # -19.5 .. -16.5
    assert q[3, 1:5].tolist() == [-20, -18, -18, -16]   # the same / 0.5


def test_int8_matmul_ref_is_bit_identical(ref):
    """The unfused reference product: dynamic-quant x, integer sum, then
    ``(acc * sx) * sw`` in x's dtype."""
    rs = np.random.RandomState(12)
    x = rs.randn(2, 7, 48).astype(np.float32)
    w = ref.quant.quantize(ref.jnp.asarray(rs.randn(48, 24)
                                           .astype(np.float32)), axis=-1)
    want = ref.quant.int8_matmul_ref(ref.jnp.asarray(x), w)
    got = tq.int8_matmul_ref(_t(x), tq.QTensor(_t(np.asarray(w.values)),
                                               _t(np.asarray(w.scale))))
    _same(got, want)


def test_codec_encode_is_bit_identical(ref):
    x = _rows_with_ties(11).reshape(2, 3, 40)
    wq, ws = ref.kv_quant.CacheCodec("int8").encode(ref.jnp.asarray(x))
    gq, gs = INT8.encode(_t(x))
    _same(gq, wq)
    _same(gs, ws)
    np.testing.assert_array_equal(
        INT8.decode(gq, gs, torch.float32).numpy(),
        np.asarray(ref.kv_quant.CacheCodec("int8").decode(
            wq, ws, ref.jnp.float32)))
    assert INT8.bytes_per_feature_row(64) == 68
    assert CacheCodec().bytes_per_feature_row(64) == 128


def test_pool_write_has_one_winner_per_destination():
    """Dead lanes, lanes past a slot's table and table entries at the null
    block all write (block 0, some offset): many rows per destination.
    ``cache_put`` must leave, at each destination, the values and the
    scale of one and the same row, the last in row-major (slot, lane)
    order, as a sequential loop does, whatever order the writes land in."""
    B, W, bs, kv, hd = 3, 6, 4, 2, 8
    tables = torch.tensor([[3, 1], [2, 0], [4, 5]], dtype=torch.int32)
    start = torch.tensor([2, 3, 5])
    n_live = torch.tensor([6, 2, 0])
    pos = start[:, None] + torch.arange(W)[None, :]
    idx_w = torch.where(masking.lane_mask(W, n_live), pos, 2 * bs)
    blk, off = paged_write_slot(idx_w, tables, bs)
    rs = np.random.RandomState(7)
    kq, ks = INT8.store(_t(rs.randn(B, W, kv, hd).astype(np.float32)),
                        torch.int8)
    vals, scales = INT8.cache_tensors((6, bs, kv, hd), "cpu")
    cache_put(vals, scales, (blk, off), kq, ks)

    dest = (blk * bs + off).reshape(-1)
    assert dest.unique().numel() < dest.numel()    # duplicates, null block
    src = last_writer((blk, off), bs, 6)
    want_v, want_s = np.zeros(tuple(vals.shape), np.int8), \
        np.zeros(tuple(scales.shape), np.float32)
    flat_q, flat_s = kq.reshape(B * W, kv, hd), ks.reshape(B * W, kv)
    for r in range(B * W):                         # sequential, row-major
        b_, o_ = int(blk.reshape(-1)[r]), int(off.reshape(-1)[r])
        want_v[b_, o_], want_s[b_, o_] = flat_q[r].numpy(), flat_s[r].numpy()
        # the winner is the last row with this destination
        assert int(src[r]) == max(i for i in range(B * W)
                                  if int(dest[i]) == int(dest[r]))
    np.testing.assert_array_equal(vals.numpy(), want_v)
    np.testing.assert_array_equal(scales.numpy(), want_s)
    # another order of the writes (as a device may apply them) lands the
    # same bytes: every duplicate carries its winner's row
    again_v, again_s = INT8.cache_tensors((6, bs, kv, hd), "cpu")
    for r in reversed(range(B * W)):
        b_, o_ = int(blk.reshape(-1)[r]), int(off.reshape(-1)[r])
        again_v[b_, o_] = flat_q[src[r]]
        again_s[b_, o_] = flat_s[src[r]]
    assert torch.equal(again_v, vals) and torch.equal(again_s, scales)


# below the reduced model's smallest stacked kernel (2 x 64 x 64 = 8192)
# but above its per-layer size (4096): the reference's stacked count
# quantizes the attention projections, a per-layer count would not
@pytest.mark.parametrize("min_size", [1, 6000, 10_000, 65_536])
def test_quantize_params_is_bit_identical(ref, min_size):
    want = from_jax_params(ref.np_tree(ref.serve_quant.quantize_params(
        ref.params, min_size=min_size)), CFG, "cpu")
    got = quantize_params(from_jax_params(ref.np_tree(ref.params), CFG,
                                          "cpu"), min_size)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        assert torch.equal(got[name], w), name
    n_int8 = sum(t.dtype == torch.int8 for t in got.values())
    assert n_int8 == {1: 15, 6000: 15, 10_000: 6, 65_536: 0}[min_size]
    # the model holds exactly those leaves as int8, and loads them
    tm = Model(CFG, compute_dtype=torch.float32, quant="int8",
               quant_min_size=min_size, device="cpu")
    assert {k for k, t in tm.state_dict().items()
            if t.dtype == torch.int8} == {k for k, t in want.items()
                                          if t.dtype == torch.int8}
    tm.load_state_dict(from_jax_params(ref.np_tree(ref.params), CFG, "cpu"))
    for name, t in tm.state_dict().items():
        if t.dtype == torch.int8 or name.endswith("_scale"):
            assert torch.equal(t, want[name]), name


def test_init_quantizes_its_own_draws():
    """``Model.init`` of an int8 model equals quantizing the float model's
    draws from the same generator, so the draw order is unchanged."""
    f = Model(CFG, compute_dtype=torch.float32, device="cpu")
    f.init(torch.Generator().manual_seed(3))
    q = Model(CFG, compute_dtype=torch.float32, quant="int8",
              quant_min_size=1, device="cpu")
    q.init(torch.Generator().manual_seed(3))
    want = quantize_params(f.state_dict(), 1)
    got = q.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert got["embed.table_scale"].shape == (CFG.vocab_size, 1)
    assert got["layers.0.ffn.w1.kernel_scale"].shape == (1, CFG.d_ff)


# ---------------------------------------------------------------------------
# (b) int8_matmul and quantized_dense
# ---------------------------------------------------------------------------
MATMUL_CASES = [
    (77, 300, 199, (32, 128, 64)),   # divides no tile
    (5, 64, 33, (8, 32, 32)),        # decode-like skinny M
    (128, 96, 160, (64, 64, 128)),   # mixed-step M, ragged K / N tiles
]


def _int8_operands(M, K, N):
    rs = np.random.RandomState(M + K + N)
    qx = rs.randint(-127, 128, (M, K)).astype(np.int8)
    qw = rs.randint(-127, 128, (K, N)).astype(np.int8)
    sx = np.float32(rs.uniform(1e-3, 5e-2))
    sw = rs.uniform(1e-3, 5e-2, (1, N)).astype(np.float32)
    return qx, qw, sx, sw


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,blocks", MATMUL_CASES)
def test_int8_matmul_plain_matches_pallas(ref, M, K, N, blocks, out):
    qx, qw, sx, sw = _int8_operands(M, K, N)
    jnp = ref.jnp
    want = np.asarray(ref.int8_matmul(
        jnp.asarray(qx), jnp.asarray(sx), jnp.asarray(qw), jnp.asarray(sw),
        bm=blocks[0], bk=blocks[1], bn=blocks[2], interpret=True,
        out_dtype=getattr(jnp, out)), np.float32)
    got = int8_matmul(_t(qx), torch.tensor(sx), _t(qw), _t(sw),
                      out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    # float32: the same exact sum and epilogue; bf16: one rounding of it
    tol = 1e-6 if out == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=0)


@pytest.mark.parametrize("M,K,N,blocks", MATMUL_CASES)
def test_int8_matmul_integer_sums_are_exact(ref, M, K, N, blocks):
    """With unit scales the output is the int32 sum itself (|sum| < 2^24
    here, so float32 holds it exactly), in both packages."""
    qx, qw, _, _ = _int8_operands(M, K, N)
    exact = (qx.astype(np.int64) @ qw.astype(np.int64)).astype(np.float32)
    assert np.abs(exact).max() < 2 ** 24
    one, ones = np.float32(1.0), np.ones((1, N), np.float32)
    jnp = ref.jnp
    want = np.asarray(ref.int8_matmul(
        jnp.asarray(qx), jnp.asarray(one), jnp.asarray(qw), jnp.asarray(ones),
        bm=blocks[0], bk=blocks[1], bn=blocks[2], interpret=True,
        out_dtype=jnp.float32))
    got = int8_matmul_plain(_t(qx), torch.tensor(one), _t(qw), _t(ones),
                            torch.float32).numpy()
    np.testing.assert_array_equal(want, exact)
    np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_dense_matches_reference(ref, dtype):
    """Leading dims folded into rows, one per-tensor activation scale over
    all of them, then the kernel, in x's dtype."""
    rs = np.random.RandomState(9)
    x = rs.randn(3, 5, 96).astype(np.float32)
    w = rs.randn(96, 40).astype(np.float32) / 10
    jnp = ref.jnp
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jq = ref.quant.quantize(jnp.asarray(w), axis=-1)
    want = np.asarray(ref.ops.quantized_dense(jx, jq), np.float32)
    tx = _t(x).to(getattr(torch, dtype))
    got = quantized_dense(tx, tq.QTensor(_t(np.asarray(jq.values)),
                                         _t(np.asarray(jq.scale))))
    assert got.shape == (3, 5, 40) and got.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


# the six serving shapes of int8_matmul (a decode step's 8 rows and a mixed
# step's 128 against qwen1.5-0.5b's wq/wk/wv/wo, w1/wg and w2) and ragged
# ones (K not a multiple of 32 or of 16, K < 32)
INT8_SERVING = [(m, k, n) for m in (8, 128)
                for k, n in ((1024, 1024), (1024, 2816), (2816, 1024))]
INT8_RAGGED = [(77, 300, 199), (5, 1000, 67), (3, 12, 10), (300, 40, 16)]


def _split_counts(K):
    """Every split count the plan can take at this K."""
    return range(1, min(-(-K // i8.K_SLICE), i8.MAX_SPLITS) + 1)


@pytest.mark.parametrize("M,K,N", INT8_SERVING + INT8_RAGGED)
def test_int8_plan_ranges_hold_whole_slices(M, K, N):
    """The plan takes a BN the kernel has and a split count it can take;
    every such count cuts [0, K) into contiguous, non-empty ranges of
    whole 32-deep slices (only the last may end ragged, at K) whose slice
    counts differ by at most one."""
    bm, bn, splits = i8.int8_plan(M, K, N)
    assert bm == (16 if M <= 16 else 32) and bn in (32, 64)
    assert splits in _split_counts(K)
    slices = -(-K // i8.K_SLICE)
    for s in _split_counts(K):
        r = i8.int8_k_ranges(K, s)
        assert len(r) == s and r[0][0] == 0 and r[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
        assert all(lo % i8.K_SLICE == 0 and hi > lo for lo, hi in r)
        n = [-(-(hi - lo) // i8.K_SLICE) for lo, hi in r]
        assert sum(n) == slices and max(n) - min(n) <= 1


def test_int8_plan_at_the_serving_shapes():
    """The serving shapes take one K range (32 column tiles and up; BN 64
    only where that still gives about a wave of CTAs); a product with few
    column tiles and a deep K splits into ranges of at least 512."""
    assert [i8.int8_plan(*s) for s in INT8_SERVING] == [
        (16, 32, 1), (16, 32, 1), (16, 32, 1),
        (32, 32, 1), (32, 64, 1), (32, 32, 1)]
    assert i8.int8_plan(8, 8192, 256) == (16, 32, 4)
    assert i8.int8_plan(8, 1000, 256) == (16, 32, 1)
    assert i8.int8_plan(8, 2048, 64) == (16, 32, 4)


INT8_SPLIT_CASES = [(8, 96, 64), (16, 256, 48), (128, 160, 96),
                    (77, 300, 199), (5, 1000, 67), (3, 12, 10)]


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", INT8_SPLIT_CASES)
def test_int8_split_partials_match_pallas(ref, M, K, N, out):
    """Each range's int32 partial sums, added in order and rescaled once,
    equal the Pallas kernel's output bit for bit at every split count:
    integer sums are exact in any order."""
    qx, qw, sx, sw = _int8_operands(M, K, N)
    jnp = ref.jnp
    want = np.asarray(ref.int8_matmul(
        jnp.asarray(qx), jnp.asarray(sx), jnp.asarray(qw), jnp.asarray(sw),
        bm=32, bk=64, bn=64, interpret=True,
        out_dtype=getattr(jnp, out)), np.float32)
    for splits in _split_counts(K):
        parts = i8.int8_partials_plain(_t(qx), _t(qw), splits)
        assert len(parts) == splits
        assert all(p.dtype == torch.int32 and p.shape == (M, N)
                   for p in parts)
        got = i8.int8_reduce_plain(parts, torch.tensor(sx), _t(sw),
                                   getattr(torch, out))
        assert got.dtype == getattr(torch, out)
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_int8_wrapper_rejects_bad_operands_and_counts_no_plain_launch():
    qx = torch.zeros(4, 8, dtype=torch.int8)
    qw = torch.zeros(8, 3, dtype=torch.int8)
    sx, sw = torch.ones(()), torch.ones(1, 3)
    with pytest.raises(ValueError, match="do not form a matmul"):
        int8_matmul(qx, sx, qw.t(), sw)
    with pytest.raises(ValueError, match="int8"):
        int8_matmul(qx.float(), sx, qw, sw)
    with pytest.raises(ValueError, match="scales"):
        int8_matmul(qx, sx, qw, torch.ones(1, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        int8_matmul(qx.to("meta"), sx.to("meta"), qw.to("meta"),
                    sw.to("meta"))
    before = int8_matmul.launches
    assert int8_matmul(qx, sx, qw, sw).shape == (4, 3)
    assert int8_matmul.launches == before


# ---------------------------------------------------------------------------
# (c) paged attention over an int8 pool
# ---------------------------------------------------------------------------
def _int8_paged_case(seed, B, kv, hd, bs, nblk, reach):
    """An int8 pool with per-row scales, block tables in random order, and
    entries past each sequence's reach at the null block (row 0)."""
    rs = np.random.RandomState(seed)
    nb = B * nblk + 1
    kq, vq = (rs.randint(-127, 128, (nb, bs, kv, hd)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rs.uniform(5e-3, 3e-2, (nb, bs, kv)).astype(np.float32)
              for _ in range(2))
    bt = (rs.permutation(nb - 1) + 1)[:B * nblk].reshape(B, nblk)
    for b, r in enumerate(reach):
        bt[b, -(-r // bs):] = 0
    return rs, (kq, vq, ks, vs), bt.astype(np.int32)


def _pallas_pool(ref, pool):
    return [ref.jnp.asarray(a) for a in pool]


@pytest.mark.parametrize("h,kv,hd", ATTN_SHAPES)
def test_int8_paged_decode_plain_matches_pallas(ref, h, kv, hd):
    B, bs, nblk = 4, 8, 5
    lengths = np.array([1, 8, 13, 40], np.int32)
    rs, pool, bt = _int8_paged_case(h * 7 + hd, B, kv, hd, bs, nblk, lengths)
    q = rs.randn(B, h, hd).astype(np.float32)
    jnp = ref.jnp
    jk, jv, jks, jvs = _pallas_pool(ref, pool)
    want = np.asarray(ref.decode(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                                 jnp.asarray(lengths), k_scale=jks,
                                 v_scale=jvs, interpret=True))
    kq, vq, ks, vs = (_t(a) for a in pool)
    got = paged_decode_attention(_t(q), kq, vq, _t(bt), _t(lengths),
                                 k_scale=ks, v_scale=vs).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("h,kv,hd", ATTN_SHAPES)
def test_int8_chunked_prefill_plain_matches_pallas(ref, h, kv, hd):
    B, W, bs, nblk = 4, 6, 8, 5
    start = np.array([0, 5, 16, 37], np.int32)   # last slot overruns the table
    rs, pool, bt = _int8_paged_case(h * 11 + hd, B, kv, hd, bs, nblk,
                                    np.minimum(start + W, nblk * bs))
    q = rs.randn(B, W, h, hd).astype(np.float32)
    jnp = ref.jnp
    jk, jv, jks, jvs = _pallas_pool(ref, pool)
    want = np.asarray(ref.chunk(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                                jnp.asarray(start), k_scale=jks, v_scale=jvs,
                                interpret=True))
    kq, vq, ks, vs = (_t(a) for a in pool)
    got = chunked_prefill_attention(_t(q), kq, vq, _t(bt), _t(start),
                                    k_scale=ks, v_scale=vs).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_int8_pool_bf16_queries_match_pallas(ref):
    """bf16 q over an int8 pool: the reference computes in float32 (p not
    rounded) and casts the output to bf16 once."""
    B, W, h, kv, hd, bs, nblk = 3, 4, 8, 2, 16, 8, 4
    start = np.array([3, 9, 28], np.int32)
    rs, pool, bt = _int8_paged_case(21, B, kv, hd, bs, nblk, start + W)
    q = rs.randn(B, W, h, hd).astype(np.float32)
    jnp = ref.jnp
    jk, jv, jks, jvs = _pallas_pool(ref, pool)
    want = np.asarray(ref.chunk(jnp.asarray(q, jnp.bfloat16), jk, jv,
                                jnp.asarray(bt), jnp.asarray(start),
                                k_scale=jks, v_scale=jvs, interpret=True),
                      np.float32)
    kq, vq, ks, vs = (_t(a) for a in pool)
    got = chunked_prefill_attention(_t(q).bfloat16(), kq, vq, _t(bt),
                                    _t(start), k_scale=ks, v_scale=vs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                               atol=1e-6)


def test_int8_pool_equals_its_dequantized_float32_pool():
    """The int8 option is the float32 walk over the dequantized pool."""
    B, W, h, kv, hd, bs, nblk = 3, 5, 4, 2, 16, 8, 3
    start = np.array([0, 7, 17], np.int32)
    rs, pool, bt = _int8_paged_case(4, B, kv, hd, bs, nblk, start + W)
    kq, vq, ks, vs = (_t(a) for a in pool)
    q = _t(rs.randn(B, W, h, hd).astype(np.float32))
    got = chunked_prefill_attention(q, kq, vq, _t(bt), _t(start), k_scale=ks,
                                    v_scale=vs)
    want = chunked_prefill_attention(
        q, INT8.decode(kq, ks, torch.float32), INT8.decode(vq, vs,
                                                           torch.float32),
        _t(bt), _t(start))
    assert torch.equal(got, want)
    lens = _t(start + 1)
    assert torch.equal(
        paged_decode_attention(q[:, 0], kq, vq, _t(bt), lens, k_scale=ks,
                               v_scale=vs),
        paged_decode_attention_plain(q[:, 0], kq, vq, _t(bt), lens,
                                     k_scale=ks, v_scale=vs))


def test_int8_unseen_rows_and_null_scales_never_reach_the_output():
    """NaN scales in the null block and in the unseen tail of each
    sequence's last block must not leak into any lane's output."""
    B, W, h, kv, hd, bs, nblk = 2, 3, 4, 4, 16, 8, 4
    start = np.array([2, 10], np.int32)
    rs, pool, bt = _int8_paged_case(8, B, kv, hd, bs, nblk, start + W)
    q = _t(rs.randn(B, W, h, hd).astype(np.float32))
    kq, vq, ks, vs = (_t(a) for a in pool)
    clean = chunked_prefill_attention(q, kq, vq, _t(bt), _t(start),
                                      k_scale=ks, v_scale=vs)
    ks2, vs2 = ks.clone(), vs.clone()
    ks2[0] = vs2[0] = float("nan")
    for b, s in enumerate(start):
        last = s + W - 1
        blk, off = bt[b, last // bs], last % bs
        ks2[blk, off + 1:] = vs2[blk, off + 1:] = float("nan")
    got = chunked_prefill_attention(q, kq, vq, _t(bt), _t(start),
                                    k_scale=ks2, v_scale=vs2)
    assert torch.isfinite(got).all()
    assert torch.equal(got, clean)


def test_attention_wrappers_check_the_scale_option():
    q = torch.zeros(2, 1, 4, 16)
    pool = torch.zeros(5, 8, 2, 16, dtype=torch.int8)
    sc = torch.ones(5, 8, 2)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    start = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int8 pool and only with one"):
        chunked_prefill_attention(q, pool, pool, bt, start)
    with pytest.raises(ValueError, match="int8 pool and only with one"):
        chunked_prefill_attention(q, pool.float(), pool.float(), bt, start,
                                  k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError, match="one per pool row"):
        chunked_prefill_attention(q, pool, pool, bt, start,
                                  k_scale=sc[:, :4], v_scale=sc)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_decode_attention(q[:, 0].to("meta"), pool.to("meta"),
                               pool.to("meta"), bt.to("meta"),
                               start.to("meta"), k_scale=sc.to("meta"),
                               v_scale=sc.to("meta"))


# ---------------------------------------------------------------------------
# (d) the fully-quantized model steps
# ---------------------------------------------------------------------------
BS, NBLK, NUM_BLOCKS = 8, 4, 12
TABLES = np.array([[3, 1, 7, 0], [2, 9, 4, 11], [5, 0, 0, 0]], np.int32)
N_LIVE = np.array([8, 8, 5], np.int32)
# float32 compute: summation order only (measured ~6e-7 x max|logits| on
# these inputs), as the float tests' 1e-4.  A last-bit difference that
# moved one activation across an int8 rounding boundary (one step of
# amax / 127) in one package only would show as ~1e-3 and fail here.
QUANT_LOGIT_TOL = 1e-4


def _quant_pair(ref, mm, impl, kv_dtype="int8", quant="int8"):
    jnp = ref.jnp
    jm = ref.model(ref.cfg, ref.options(
        compute_dtype=jnp.float32, matmul_backend=mm, paged_attn_impl=impl,
        kv_dtype=kv_dtype))
    params = ref.params
    if quant == "int8":
        params = ref.serve_quant.quantize_params(params, min_size=1)
    tm = Model(CFG, compute_dtype=torch.float32, matmul_backend=mm,
               paged_attn_impl=impl, quant=quant, quant_min_size=1,
               kv_dtype=kv_dtype, device="cpu")
    tm.load_state_dict(from_jax_params(ref.np_tree(params), CFG, "cpu"))
    return jm, params, tm


def _quant_steps(ref, jm, params, tm, seed=0):
    """mixed_step (a chunk with a partial slot) then decode_step in both
    packages; returns the (jax, port) logits pairs and final caches."""
    jnp = ref.jnp
    rs = np.random.RandomState(seed)
    W = 8
    toks = rs.randint(0, CFG.vocab_size, (3, W)).astype(np.int32)
    start = np.zeros(3, np.int32)
    jc = jm.init_cache(3, NBLK * BS, paging=ref.paging(BS, NUM_BLOCKS))
    tc = tm.init_cache(PagingConfig(BS, NUM_BLOCKS))
    jl, jc = jm.mixed_step(params, jc, jnp.asarray(toks), jnp.asarray(start),
                           jnp.asarray(N_LIVE),
                           block_tables=jnp.asarray(TABLES))
    tl = tm.mixed_step(tc, _t(toks), _t(start), _t(N_LIVE), _t(TABLES))
    live = np.arange(W)[None, :] < N_LIVE[:, None]
    mixed = (np.asarray(jl)[live], tl.numpy()[live])
    dtoks = rs.randint(0, CFG.vocab_size, (3, 1)).astype(np.int32)
    jd, jc = jm.decode_step(params, jc, jnp.asarray(dtoks),
                            jnp.asarray(N_LIVE),
                            block_tables=jnp.asarray(TABLES))
    td = tm.decode_step(tc, _t(dtoks), _t(N_LIVE), _t(TABLES))
    return mixed, (np.asarray(jd), td.numpy()), jc, tc


def _close(pair, rel):
    want, got = pair
    assert np.isfinite(got).all()
    err, scale = np.abs(want - got).max(), np.abs(want).max()
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


@pytest.mark.parametrize("mm,impl", [("xla", "gather"), ("pallas", "gather"),
                                     ("pallas", "pallas")])
def test_quantized_steps_match_reference(ref, mm, impl):
    jm, params, tm = _quant_pair(ref, mm, impl)
    mixed, dec, jc, tc = _quant_steps(ref, jm, params, tm)
    _close(mixed, QUANT_LOGIT_TOL)
    _close(dec, QUANT_LOGIT_TOL)
    assert tc.k.dtype == torch.int8 and tc.k_scale.dtype == torch.float32
    assert tc.k_scale.shape == tc.k.shape[:-1]
    # the written pool blocks (row 0, the null block, holds dead-lane
    # writes and is excluded): scales to float32 rounding, int8 values
    # within one step where a rounding boundary fell between the packages
    for jv, tv, js, ts in ((jc.k, tc.k, jc.k_scale, tc.k_scale),
                           (jc.v, tc.v, jc.v_scale, tc.v_scale)):
        np.testing.assert_allclose(ts[:, 1:].numpy(), np.asarray(js[:, 1:]),
                                   rtol=1e-5, atol=0)
        diff = np.abs(tv[:, 1:].numpy().astype(np.int32)
                      - np.asarray(jv[:, 1:]).astype(np.int32))
        assert diff.max() <= 1 and diff.mean() < 1e-2
        assert np.abs(np.asarray(jv[:, 1:])).max() > 0


def test_int8_pool_float_weights_steps_match_reference_gather(ref):
    """Float weights over the int8 pool: the port's kernel path against the
    reference's gather path (the reference's Pallas engine is red in this
    configuration; its kernels alone match a dequantized pool)."""
    jm, params, _ = _quant_pair(ref, "xla", "gather", quant="none")
    _, _, tm = _quant_pair(ref, "xla", "pallas", quant="none")
    mixed, dec, _, _ = _quant_steps(ref, jm, params, tm, seed=4)
    _close(mixed, QUANT_LOGIT_TOL)
    _close(dec, QUANT_LOGIT_TOL)


# ---------------------------------------------------------------------------
# (e) the engine: greedy streams and events
# ---------------------------------------------------------------------------
# the reference's near-tie-free workload for int8 serving
# (tests/test_kv_quant.py PROMPTS)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9], [7] * 12, [30, 31]]


def _engine_pair(ref, quant, mm, impl, ref_impl=None):
    mem = dict(max_batch=4, max_len=64, block_size=8, kv_dtype="int8")
    je = ref.engine(ref.spec.RuntimeSpec(
        arch=ref.cfg,
        execution=ref.spec.ExecutionSpec(
            matmul_backend=mm, paged_attn_impl=ref_impl or impl,
            compute_dtype="fp32", quant=quant, quant_min_size=1),
        memory=ref.spec.MemorySpec(cache_layout="paged", **mem),
        scheduler=ref.spec.SchedulerSpec(chunk_size=8)))
    je.load(ref.params)
    te = ServingEngine(RuntimeSpec(
        arch=CFG,
        execution=ExecutionSpec(matmul_backend=mm, paged_attn_impl=impl,
                                compute_dtype="fp32", quant=quant,
                                quant_min_size=1),
        memory=MemorySpec(cache_layout="paged", **mem),
        scheduler=SchedulerSpec(chunk_size=8)), device="cpu")
    te.load(from_jax_params(ref.np_tree(ref.params), CFG, "cpu"))
    return je, te


def _drain(eng, max_new=6):
    log = []
    eng.events.subscribe(log.append)
    uids = {eng.submit(p, max_new_tokens=max_new): i
            for i, p in enumerate(PROMPTS)}
    done = eng.run_to_completion()
    assert len(done) == len(PROMPTS)
    streams = {uids[r.uid]: r.generated for r in done}
    return streams, [(e.kind, e.uid, e.step, e.data) for e in log]


@pytest.mark.parametrize("mm,impl", [("xla", "gather"), ("pallas", "pallas")])
def test_quantized_engine_matches_reference(ref, mm, impl):
    """The acceptance spec: int8 weights through ``int8_matmul`` and the
    int8 pool through the attention kernels' scale option."""
    je, te = _engine_pair(ref, "int8", mm, impl)
    want, got = _drain(je), _drain(te)
    assert got == want
    assert te.cache.k.dtype == torch.int8
    assert te.model.layers[0].attn.wq.kernel.dtype == torch.int8
    assert te.stats["decode_steps"] == je.stats["decode_steps"]


def test_int8_pool_kernel_engine_matches_reference_gather(ref):
    """Float weights + int8 pool + the attention kernels, against the
    reference's gather engine (its Pallas engine diverges here)."""
    je, te = _engine_pair(ref, "none", "xla", "pallas", ref_impl="gather")
    want, got = _drain(je), _drain(te)
    assert got == want


def test_launch_serve_quantized_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--requests", "3", "--max-new", "4",
          "--max-len", "32", "--block-size", "8", "--chunk-size", "8",
          "--cache-layout", "paged",
          "--kernels", "pallas", "--attn", "pallas", "--quant", "int8",
          "--quant-min-size", "1", "--kv-dtype", "int8"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out


# ---------------------------------------------------------------------------
# (f) the kernels on the card (run where a CUDA device is present)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_int8_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    runtime.build()
    for M, K, N in ((8, 1024, 2816), (128, 2816, 1024), (77, 300, 199),
                    (5, 64, 33)):
        qx, qw, sx, sw = (_t(np.asarray(a)).to(dev)
                          for a in _int8_operands(M, K, N))
        for dt in (torch.float32, torch.bfloat16):
            # the same exact integer sum and epilogue: bit-identical
            assert torch.equal(int8_matmul(qx, sx, qw, sw, out_dtype=dt),
                               int8_matmul_plain(qx, sx, qw, sw, dt))
    for h, kv, hd in ATTN_SHAPES:
        B, W, bs, nblk = 4, 6, 8, 5
        start = np.array([0, 5, 16, 37], np.int32)
        rs, pool, bt = _int8_paged_case(h + hd, B, kv, hd, bs, nblk,
                                        np.minimum(start + W, nblk * bs))
        kq, vq, ks, vs = (_t(a).to(dev) for a in pool)
        ks[0] = vs[0] = float("nan")      # a read of the null block shows
        q = _t(rs.randn(B, W, h, hd).astype(np.float32)).to(dev)
        bt_d, st = _t(bt).to(dev), _t(start).to(dev)
        for qq in (q, q.bfloat16()):
            tol = 2e-5 if qq.dtype == torch.float32 else 2 ** -6
            got = chunked_prefill_attention(qq, kq, vq, bt_d, st, k_scale=ks,
                                            v_scale=vs)
            assert torch.isfinite(got).all()
            torch.testing.assert_close(
                got, chunked_prefill_attention_plain(
                    qq, kq, vq, bt_d, st, k_scale=ks, v_scale=vs),
                atol=tol, rtol=tol)
            qd = qq[:, 0].contiguous()
            torch.testing.assert_close(
                paged_decode_attention(qd, kq, vq, bt_d, st + 1, k_scale=ks,
                                       v_scale=vs),
                paged_decode_attention_plain(qd, kq, vq, bt_d, st + 1,
                                             k_scale=ks, v_scale=vs),
                atol=tol, rtol=tol)


def _int8_on(dev, M, K, N):
    return [_t(np.asarray(a)).to(dev) for a in _int8_operands(M, K, N)]


def _planned(plan):
    """``int8_matmul`` launched at ``plan`` (BM, BN, K ranges) instead of
    ``int8_plan``'s."""
    return mock.patch.object(i8, "int8_plan", lambda M, K, N: plan)


@pytest.mark.cuda
def test_cuda_int8_matmul_is_exact_at_every_plan():
    """The six serving shapes, bf16 and f32 out, bit-equal to the plain
    version; and every BM, BN and split count bit-equal to one range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    runtime.build()
    for M, K, N in INT8_SERVING:
        qx, qw, sx, sw = _int8_on(dev, M, K, N)
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(int8_matmul(qx, sx, qw, sw, out_dtype=dt),
                               int8_matmul_plain(qx, sx, qw, sw, dt))
            grid = i8.launched_grid()
            assert (grid[3], grid[4], grid[1]) == i8.int8_plan(M, K, N)
        with _planned((16, 32, 1)):
            one = int8_matmul(qx, sx, qw, sw)
        for plan in itertools.product((16, 32), (32, 64), _split_counts(K)):
            with _planned(plan):
                got = int8_matmul(qx, sx, qw, sw)
            grid = i8.launched_grid()
            assert (grid[3], grid[4], grid[1]) == plan
            assert torch.equal(got, one), (M, K, N, plan)


@pytest.mark.cuda
def test_cuda_int8_matmul_ragged_and_unaligned():
    """Ragged shapes at every split count, a shape whose plan splits K,
    and operands one byte off a 16-byte boundary (the element-load path,
    BN 32), bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    runtime.build()
    for M, K, N in ((77, 300, 199), (5, 1000, 67)):
        qx, qw, sx, sw = _int8_on(dev, M, K, N)
        for dt in (torch.float32, torch.bfloat16):
            want = int8_matmul_plain(qx, sx, qw, sw, dt)
            for splits in _split_counts(K):
                for bm in (16, 32):
                    with _planned((bm, 64, splits)):
                        got = int8_matmul(qx, sx, qw, sw, out_dtype=dt)
                    assert torch.equal(got, want)
    qx, qw, sx, sw = _int8_on(dev, 8, 8192, 256)
    assert torch.equal(int8_matmul(qx, sx, qw, sw),
                       int8_matmul_plain(qx, sx, qw, sw))
    assert i8.launched_grid()[1] == 4
    for M in (8, 128):
        qx, qw, sx, sw = _int8_on(dev, M, 1024, 1024)
        ux = torch.empty(qx.numel() + 1, dtype=torch.int8, device=dev)[1:]
        uw = torch.empty(qw.numel() + 1, dtype=torch.int8, device=dev)[1:]
        ux, uw = ux.view(qx.shape), uw.view(qw.shape)
        ux.copy_(qx)
        uw.copy_(qw)
        with _planned((16 if M <= 16 else 32, 64, 1)):
            got = int8_matmul(ux, sx, uw, sw)
        assert i8.launched_grid()[4] == 32
        assert torch.equal(got, int8_matmul_plain(qx, sx, qw, sw))


@pytest.mark.cuda
def test_cuda_int8_matmul_makes_no_host_sync():
    """A split call (workspace, kernel, reduce) never waits for the
    device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    runtime.build()
    qx, qw, sx, sw = _int8_on(dev, 128, 2816, 1024)
    with _planned((32, 64, 4)):
        int8_matmul(qx, sx, qw, sw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = int8_matmul(qx, sx, qw, sw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert i8.launched_grid()[1] == 4
    assert torch.equal(got, int8_matmul_plain(qx, sx, qw, sw))


@pytest.mark.cuda
def test_quantized_engine_serves_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import chunked_prefill, paged_attention
    from repro_torch.kernels import int8_matmul as i8
    spec = RuntimeSpec(
        arch=CFG, execution=ExecutionSpec(matmul_backend="pallas",
                                          paged_attn_impl="pallas",
                                          quant="int8", quant_min_size=1),
        memory=MemorySpec(cache_layout="paged", max_batch=4, max_len=64,
                          block_size=8, kv_dtype="int8"),
        scheduler=SchedulerSpec(chunk_size=8))
    eng = ServingEngine(spec)
    eng.load(Model(CFG, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0)).state_dict())
    fns = (i8.int8_matmul, paged_attention.paged_decode_attention,
           chunked_prefill.chunked_prefill_attention)
    counts = [f.launches for f in fns]
    streams, _ = _drain(eng)
    assert all(len(s) == 6 for s in streams.values())
    assert all(f.launches > c for f, c in zip(fns, counts))
