"""Split-KV paged decode attention: the W = 1 key-range plan and the
plain partials and merge of ``repro_torch.kernels.chunked_prefill`` at
one lane.

The CUDA decode kernel is the chunk kernel's walk (``csrc/split_walk.cuh``)
at W = 1: a CTA's 16 query rows hold the n_rep heads of one kv group, the
block table is cut into key ranges of whole logical blocks from the shapes
alone (``kv_splits`` with rows = n_rep), each range writes its
unnormalised accumulator and running (max, sum), and a merge kernel
combines them in range order.  These tests run the same steps in
plain PyTorch on the CPU (``chunked_prefill_partial_plain`` at W = 1 with
start = lengths - 1, ``merge_partials_plain``) and hold them against
``paged_decode_attention_plain`` (float32 within 2e-6: the merge only
reorders float32 sums) and against the reference Pallas kernel in
interpret mode (atol / rtol 1e-5), also at ROADMAP Queue 3 fault F's head
dims (hd 144, recurrentgemma-2b's MQA 10 over 1 at hd 256, the ragged
72 and 66), which the reference takes by padding hd to 128 lanes.

The kernel itself runs only on a CUDA card (``cuda`` marker):
``python -m pytest -q --noconftest -m cuda tests/test_torch_decode.py``.
"""
import inspect
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunked_prefill as cp
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import runtime
from test_torch_threads import one_thread  # noqa: F401 (autouse)

F32_TOL = 2e-6
REF_TOL = 1e-5
SMS = 132                       # the H100 SXM's SM count
NEG_INF = cp.NEG_INF


@pytest.fixture(scope="module")
def ref():
    """The reference's Pallas decode kernel (interpret mode on the CPU)."""
    import jax.numpy as jnp

    from repro.kernels.paged_attention import paged_decode_attention
    return types.SimpleNamespace(jnp=jnp, decode=paged_decode_attention)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(seed, lengths, h, kv, hd, bs, nblk, pool="f32", nan=False):
    """q [B, h, hd], pools in random block order, tables whose entries past
    each length point at the null block, and for an int8 pool per-row
    scales.  ``nan`` fills the null block (values and scales) and the
    unseen tail of each sequence's last live block with NaN."""
    rs = np.random.RandomState(seed)
    B = len(lengths)
    nb = B * nblk + 1
    if pool == "int8":
        kp, vp = (rs.randint(-127, 128, (nb, bs, kv, hd)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rs.uniform(5e-3, 3e-2, (nb, bs, kv)).astype(np.float32)
                  for _ in range(2))
    else:
        kp, vp = (rs.randn(nb, bs, kv, hd).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
    lengths = np.asarray(lengths, np.int32)
    bt = (rs.permutation(nb - 1) + 1).reshape(B, nblk)
    for b, n in enumerate(lengths):
        bt[b, -(-n // bs):] = 0
    bt = bt.astype(np.int32)
    q = rs.randn(B, h, hd).astype(np.float32)
    if nan:
        vals = (ks, vs) if pool == "int8" else (kp, vp)
        for a in vals:
            a[0] = np.nan
        for b, n in enumerate(lengths):
            blk, off = bt[b, (n - 1) // bs], (n - 1) % bs
            for a in vals:
                a[blk, off + 1:] = np.nan
    return q, kp, vp, bt, lengths, ks, vs


def _torch_case(q, kp, vp, bt, lengths, ks, vs, pool):
    tk, tv = _t(kp), _t(vp)
    if pool == "bf16":
        tk, tv = tk.bfloat16(), tv.bfloat16()
    sc = {} if ks is None else dict(k_scale=_t(ks), v_scale=_t(vs))
    return _t(q), tk, tv, _t(bt), _t(lengths), sc


def _partials(q, kp, vp, bt, lengths, splits, sc):
    """Each key range's (acc, m, l) at one lane, stacked over the ranges."""
    parts = [cp.chunked_prefill_partial_plain(q[:, None], kp, vp, bt,
                                              lengths - 1, lo, hi, **sc)
             for lo, hi in cp.kv_ranges(bt.shape[1], splits)]
    return tuple(torch.stack(x) for x in zip(*parts))


def _split_merge(q, kp, vp, bt, lengths, splits, sc):
    acc, m, l = _partials(q, kp, vp, bt, lengths, splits, sc)
    return cp.merge_partials_plain(acc, m, l, q.dtype)[:, 0], m, l


# ---------------------------------------------------------------------------
# the W = 1 plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,h,kv,nblk", [
    (8, 16, 16, 32),     # the serving shape: qwen1.5-0.5b, 32 blocks
    (8, 16, 4, 32),      # GQA 4
    (8, 32, 32, 32),     # phi3-mini widths (hd 96)
    (8, 64, 8, 32),      # qwen2-72b widths: GQA 8 (hd 128)
    (1, 16, 2, 7),       # an odd block count, one sequence
    (2, 40, 2, 3),       # n_rep 20: two row tiles, too few blocks to split
    (3, 4, 4, 1000),     # a long table
])
def test_decode_plan_covers_every_block_once(B, h, kv, nblk):
    n_rep = h // kv
    for resident in (1, 2, 3):                  # CTAs per SM (occupancy)
        splits = cp.kv_splits(B, kv, n_rep, nblk, SMS, resident)
        ranges = cp.kv_ranges(nblk, splits)
        covered = [blk for lo, hi in ranges for blk in range(lo, hi)]
        assert covered == list(range(nblk))     # each block exactly once
        if splits > 1:
            assert all(hi - lo >= 2 for lo, hi in ranges)
        ctas = B * kv * cp.row_tiles(n_rep)
        assert splits == 1 or ctas * splits <= resident * SMS


def test_decode_plan_reads_shapes_only():
    """The plan takes shapes, never lengths or the tables: ``kv_splits``
    takes integers and ``walk_plan`` the operands whose shapes it reads.
    Rows are the n_rep heads of a kv group: 128 CTAs x 3 key ranges at the
    serving shape with 3 resident CTAs per SM, 64 x 4 at qwen2-72b's GQA 8
    with 2."""
    # (the column groups of the general walk are a shape too: fault F)
    assert list(inspect.signature(cp.kv_splits).parameters) == \
        ["B", "kv", "rows", "nblk", "sms", "resident", "groups"]
    assert list(inspect.signature(cp.walk_plan).parameters) == \
        ["kernel", "q", "k_pool", "block_tables"]
    assert cp.kv_splits(8, 16, 1, 32, SMS, 3) == 3
    assert 8 * 16 * cp.row_tiles(1) == 128
    assert cp.kv_splits(8, 8, 8, 32, SMS, 2) == 4
    assert 8 * 8 * cp.row_tiles(8) == 64


@pytest.mark.parametrize("pattern", ["first position", "mixed", "full"])
def test_one_plan_serves_any_lengths(pattern):
    """One plan, made from the shapes, is right whatever the lengths: the
    split partials merged equal the plain version for short, mixed and
    full sequences."""
    h, kv, hd, bs, nblk = 8, 2, 16, 8, 8
    lengths = {"first position": [1, 1, 1], "mixed": [1, 20, 64],
               "full": [64, 64, 64]}[pattern]
    splits = cp.kv_splits(len(lengths), kv, h // kv, nblk, 24, 1)
    assert splits == 4
    arrays = _case(11, lengths, h, kv, hd, bs, nblk)
    q, kp, vp, bt, ln, sc = _torch_case(*arrays, "f32")
    got, _, _ = _split_merge(q, kp, vp, bt, ln, splits, sc)
    want = pa.paged_decode_attention_plain(q, kp, vp, bt, ln)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=F32_TOL)


# ---------------------------------------------------------------------------
# plain partials + merge against the plain version and the reference
# ---------------------------------------------------------------------------
DECODE_CASES = [  # (h, kv, hd, bs, nblk)
    (4, 2, 16, 8, 5),        # the reduced test model's head dim, GQA 2
    (4, 4, 96, 8, 4),        # phi3-mini's head dim
    (16, 2, 128, 8, 4),      # qwen2-72b's GQA 8 x hd 128
]


@pytest.mark.parametrize("splits", [2, 3])
@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("h,kv,hd,bs,nblk", DECODE_CASES)
def test_split_partials_match_plain_and_reference(ref, h, kv, hd, bs, nblk,
                                                  pool, splits):
    # lengths 1, bs, bs + 1 and the whole table
    lengths = [1, bs, bs + 1, nblk * bs]
    arrays = _case(hd + splits, lengths, h, kv, hd, bs, nblk, pool)
    q, kp, vp, bt, ln, sc = _torch_case(*arrays, pool)
    plain = pa.paged_decode_attention_plain(q, kp, vp, bt, ln, **sc)
    got, m, l = _split_merge(q, kp, vp, bt, ln, splits, sc)
    assert got.shape == plain.shape == (len(lengths), h, hd)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=F32_TOL)
    # the sequence of length 1 sees only range 0: m = NEG_INF, l = 0 past it
    assert bool((m[1:, 0] == NEG_INF).all())
    assert torch.equal(l[1:, 0], torch.zeros_like(l[1:, 0]))
    jnp = ref.jnp
    qa, kpa, vpa, bta, lna, ks, vs = arrays
    jsc = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                     v_scale=jnp.asarray(vs))
    want = np.asarray(ref.decode(jnp.asarray(qa), jnp.asarray(kpa),
                                 jnp.asarray(vpa), jnp.asarray(bta),
                                 jnp.asarray(lna), interpret=True, **jsc))
    np.testing.assert_allclose(got.numpy(), want, atol=REF_TOL,
                               rtol=REF_TOL)
    np.testing.assert_allclose(plain.numpy(), want, atol=REF_TOL,
                               rtol=REF_TOL)


def test_bf16_pool_split_within_the_card_gate():
    """f32 q over a bf16 pool: p is rounded to bf16 against each range's
    own running max, so a split moves the output by at most a bf16 step of
    p, 2^-8 x max|V| (the card's gate for this pair)."""
    arrays = _case(7, [1, 8, 9, 40], 8, 2, 16, 8, 5, "bf16")
    q, kp, vp, bt, ln, sc = _torch_case(*arrays, "bf16")
    want = pa.paged_decode_attention_plain(q, kp, vp, bt, ln)
    got, _, _ = _split_merge(q, kp, vp, bt, ln, 2, sc)
    assert float((got - want).abs().max()) <= \
        2 ** -8 * float(vp.float().abs().max())


def test_a_range_past_the_last_position_is_skipped():
    """A range that begins past a sequence's last position leaves m =
    NEG_INF and l = 0; the kernel never writes its accumulator, and the
    merge must not read it (NaN there changes nothing)."""
    arrays = _case(3, [1, 7, 30, 48], 4, 2, 16, 8, 6)
    q, kp, vp, bt, ln, sc = _torch_case(*arrays, "f32")
    acc, m, l = _partials(q, kp, vp, bt, ln, 3, sc)
    past = m == NEG_INF
    assert bool(past[1:, 0].all()) and bool(past[2, 1].all())
    assert torch.equal(l[past], torch.zeros_like(l[past]))
    acc = torch.where(past[..., None], float("nan"), acc)
    got = cp.merge_partials_plain(acc, m, l, torch.float32)[:, 0]
    want = pa.paged_decode_attention_plain(q, kp, vp, bt, ln)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=F32_TOL)


def test_zero_length_gives_zeros():
    """A sequence of length 0 sees nothing: O = 0 / max(0, 1e-30) = 0."""
    arrays = _case(5, [1, 9], 4, 2, 16, 8, 3)
    q, kp, vp, bt, ln, sc = _torch_case(*arrays, "f32")
    ln[0] = 0
    out = pa.paged_decode_attention_plain(q, kp, vp, bt, ln)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    got, _, _ = _split_merge(q, kp, vp, bt, ln, 2, sc)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_unseen_pool_rows_never_reach_decode_partials(pool):
    """NaN in the null block and in the unseen tail of each sequence's
    last live block (an int8 pool: in its scales) leaks into no partial
    and no merged output; the result equals the NaN-free pool's."""
    shape = ([1, 8, 9, 19], 4, 2, 16, 8, 4)
    outs = []
    for nan in (False, True):
        arrays = _case(8, *shape, pool=pool, nan=nan)
        q, kp, vp, bt, ln, sc = _torch_case(*arrays, pool)
        for splits in (1, 2):
            got, _, l = _split_merge(q, kp, vp, bt, ln, splits, sc)
            assert torch.isfinite(got).all() and torch.isfinite(l).all()
            outs.append(got)
        outs.append(pa.paged_decode_attention(q, kp, vp, bt, ln, **sc))
    for a, b in zip(outs[:3], outs[3:]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the wrapper's contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd", list(range(16, 129, 16)))
def test_decode_takes_every_multiple_of_16_up_to_128(hd):
    assert hd in pa.HEAD_DIMS
    cp.check_head_dim(hd, "paged_decode_attention")


@pytest.mark.parametrize("hd", [8, 36, 100, 144, 256])
def test_other_decode_head_dims_name_fault_a(hd):
    """These head dims named fault A while the walk stopped at multiples of
    16 up to 128 (ROADMAP Queue 3 fault F); decode takes them in every
    (q, pool) dtype pair now, through the general walk."""
    assert hd in pa.HEAD_DIMS and cp.general_hd(hd)
    for q_dt, kv_dt in cp.DTYPE_PAIRS:
        cp.check_head_dim(hd, "paged_decode_attention", q_dt, kv_dt, 32)


FAULT_F_CASES = [  # (h, kv, hd, bs, nblk)
    (4, 2, 144, 8, 4),       # two column groups of 96
    (10, 1, 256, 8, 4),      # recurrentgemma-2b: MQA 10 over 1, hd 256
    (4, 2, 72, 8, 4),        # ragged, 16-byte rows in bf16
    (4, 4, 66, 8, 4),        # ragged, 4-byte rows in bf16
]


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("h,kv,hd,bs,nblk", FAULT_F_CASES)
def test_fault_f_decode_matches_pallas(ref, h, kv, hd, bs, nblk, pool):
    """The plain decode at one key range and at a split of 3 against the
    reference Pallas kernel in interpret mode (atol / rtol 1e-5)."""
    lengths = [1, bs + 1, nblk * bs - 3]
    arrays = _case(hd, lengths, h, kv, hd, bs, nblk, pool)
    q, kp, vp, bt, ln, sc = _torch_case(*arrays, pool)
    jnp = ref.jnp
    qa, kpa, vpa, bta, lna, ks, vs = arrays
    jsc = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                     v_scale=jnp.asarray(vs))
    want = np.asarray(ref.decode(jnp.asarray(qa), jnp.asarray(kpa),
                                 jnp.asarray(vpa), jnp.asarray(bta),
                                 jnp.asarray(lna), interpret=True, **jsc))
    got = pa.paged_decode_attention(q, kp, vp, bt, ln, **sc)
    np.testing.assert_allclose(got.numpy(), want, atol=REF_TOL,
                               rtol=REF_TOL)
    split, _, _ = _split_merge(q, kp, vp, bt, ln, 3, sc)
    np.testing.assert_allclose(split.numpy(), want, atol=REF_TOL,
                               rtol=REF_TOL)


def test_host_tensors_run_the_plain_version_and_launch_nothing():
    arrays = _case(1, [3, 17], 4, 2, 16, 8, 3)
    q, kp, vp, bt, ln, sc = _torch_case(*arrays, "f32")
    before = (pa.paged_decode_attention.launches,
              pa.paged_decode_attention.last_grid)
    got = pa.paged_decode_attention(q, kp, vp, bt, ln)
    assert torch.equal(got, pa.paged_decode_attention_plain(q, kp, vp, bt,
                                                            ln))
    assert (pa.paged_decode_attention.launches,
            pa.paged_decode_attention.last_grid) == before


# ---------------------------------------------------------------------------
# the kernel on the card (run where a CUDA device is present)
# ---------------------------------------------------------------------------
CUDA_CASES = [  # (lengths, h, kv, hd, bs, nblk)
    ([1, 16, 100, 255, 256, 300, 511, 512], 16, 16, 64, 16, 32),  # serving
    ([1, 16, 100, 255, 256, 300, 511, 512], 16, 4, 64, 16, 32),   # GQA 4
    ([1, 17, 200, 512], 32, 32, 96, 16, 32),      # phi3-mini hd 96
    ([1, 17, 200, 512], 64, 8, 128, 16, 32),      # qwen2-72b GQA 8 x hd 128
    ([1, 8, 9, 48], 8, 2, 16, 8, 6),              # the reduced model's hd
    ([0, 1, 9, 48], 8, 2, 16, 8, 6),              # a length of 0: zeros
    # fault F: recurrentgemma-2b's MQA 10 x hd 256, hd 192, the ragged 72
    # and 66, hd 512 (four column groups)
    ([1, 17, 200, 512], 10, 1, 256, 16, 32),
    ([0, 1, 17, 200, 512], 8, 2, 192, 16, 32),
    ([1, 9, 40], 4, 2, 72, 8, 6),
    ([1, 9, 40], 4, 4, 66, 8, 6),
    ([3, 100], 4, 1, 512, 16, 8),
]
PAIRS = [("f32", "f32"), ("f32", "bf16"), ("bf16", "bf16"), ("f32", "int8"),
         ("bf16", "int8")]


@pytest.mark.cuda
def test_cuda_decode_matches_plain_version():
    """Every (q, pool) dtype pair at decode shapes, NaN in the null block
    and in the unseen tails, under ``chip_smoke.py``'s gates: bf16 out one
    bf16 step of each output, 2^-7 x max(|out|, 1); f32 out over a bf16
    pool a bf16 step of p, 2^-8 x max|V|; otherwise the order of f32 sums,
    2e-5.  Each call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    runtime.build()
    for i, (lengths, h, kv, hd, bs, nblk) in enumerate(CUDA_CASES):
        for q_dt, pool in PAIRS:
            arrays = _case(i, lengths, h, kv, hd, bs, nblk,
                           "int8" if pool == "int8" else "f32", nan=True)
            q, kp, vp, bt, ln, sc = _torch_case(*arrays, pool)
            q = q.to(dev, torch.bfloat16 if q_dt == "bf16" else torch.float32)
            kp, vp, bt, ln = (t.to(dev) for t in (kp, vp, bt, ln))
            sc = {k: v.to(dev) for k, v in sc.items()}
            n = pa.paged_decode_attention.launches
            got = pa.paged_decode_attention(q, kp, vp, bt, ln, **sc)
            assert pa.paged_decode_attention.launches == n + 1
            want = pa.paged_decode_attention_plain(q, kp, vp, bt, ln, **sc)
            d = (got.float() - want.float()).abs()
            if q_dt == "bf16":
                d = d / (2 ** -7 * want.float().abs().clamp_min(1))
                tol = 1.0
            else:
                tol = 2 ** -8 * float(vp.float().nan_to_num().abs().max()) \
                    if pool == "bf16" else 2e-5
            err = float(d.max())
            assert err <= tol, (i, q_dt, pool, err, tol,
                                pa.paged_decode_attention.last_grid)
