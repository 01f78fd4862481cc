"""Split-KV chunked-prefill attention: the key-range plan, the plain
partial and the plain merge of ``repro_torch.kernels.chunked_prefill``,
and the head dims and GQA widths of ROADMAP Queue 3 fault A.

The CUDA kernel cuts each sequence's block table into ranges of whole
logical blocks (``kv_splits`` / ``kv_ranges``, from the shapes alone),
writes each range's unnormalised accumulator and running (max, sum), and a
merge kernel combines them.  These tests run the same steps in plain
PyTorch on the CPU (``chunked_prefill_partial_plain`` per range,
``merge_partials_plain``) and hold them against
``chunked_prefill_attention_plain`` (float32 pools within 2e-6: the merge
only reorders float32 sums; a bf16 pool within the card's gate, since p
is rounded against another running max), and hold the plain path against
the reference Pallas kernel in interpret mode at hd 96 and at GQA 8 x hd
128 (float32 at 2e-6, the reference kernels' own tolerance), and at the
head dims of ROADMAP Queue 3 fault F (hd 144, recurrentgemma-2b's MQA 10
over 1 at hd 256, the ragged hd 72 and 66; the same tolerance, at one key
range and at a split): every hd the reference takes, the general walk's
column groups (each output column in exactly one) and its shared-memory
plan (every hd up to 512 in every dtype pair).

The kernel itself runs only on a CUDA card (``cuda`` marker):
``python -m pytest -q --noconftest -m cuda tests/test_torch_chunked.py``.
"""
import inspect
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunked_prefill as cp
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import runtime

F32_TOL = 2e-6
SMS = 132                       # the H100 SXM's SM count
NEG_INF = cp.NEG_INF


@pytest.fixture(scope="module")
def ref():
    """The reference's Pallas kernel (interpret mode on the CPU)."""
    import jax.numpy as jnp

    from repro.kernels.chunked_prefill import chunked_prefill_attention
    return types.SimpleNamespace(jnp=jnp, chunk=chunked_prefill_attention)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(seed, B, W, h, kv, hd, bs, nblk, start, pool="f32", nan=False):
    """q, pools in random block order, tables whose entries past each
    sequence's last lane point at the null block, and for an int8 pool
    per-row scales.  ``nan`` fills the null block (values and scales) and
    the unseen tail of each sequence's last live block with NaN."""
    rs = np.random.RandomState(seed)
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
    bt = (rs.permutation(nb - 1) + 1)[:B * nblk].reshape(B, nblk)
    start = np.asarray(start, np.int32)
    reach = np.minimum(start + W, nblk * bs)
    for b, r in enumerate(reach):
        bt[b, -(-r // bs):] = 0
    bt = bt.astype(np.int32)
    q = rs.randn(B, W, h, hd).astype(np.float32)
    if nan:
        vals = (ks, vs) if pool == "int8" else (kp, vp)
        for a in vals:
            a[0] = np.nan
        for b, r in enumerate(reach):
            blk, off = bt[b, (r - 1) // bs], (r - 1) % bs
            for a in vals:
                a[blk, off + 1:] = np.nan
    return q, kp, vp, bt, start, ks, vs


def _torch_case(q, kp, vp, bt, start, ks, vs, pool):
    tk, tv = _t(kp), _t(vp)
    if pool == "bf16":
        tk, tv = tk.bfloat16(), tv.bfloat16()
    sc = {} if ks is None else dict(k_scale=_t(ks), v_scale=_t(vs))
    return _t(q), tk, tv, _t(bt), _t(start), sc


def _split_merge(q, kp, vp, bt, start, splits, sc):
    parts = [cp.chunked_prefill_partial_plain(q, kp, vp, bt, start, lo, hi,
                                              **sc)
             for lo, hi in cp.kv_ranges(bt.shape[1], splits)]
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    return cp.merge_partials_plain(acc, m, l, q.dtype), m, l


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,kv,rows,nblk", [
    (8, 16, 16, 32),     # the serving shape: qwen1.5-0.5b, W 16, 32 blocks
    (8, 16, 1, 32),      # one lane per slot
    (1, 2, 16, 7),       # an odd block count
    (2, 8, 128, 32),     # GQA 8 x W 16: 8 row tiles
    (8, 8, 256, 32),     # GQA 8 x W 32: enough CTAs, no split
    (1, 1, 16, 3),       # too few blocks for two per range
    (3, 4, 40, 1000),    # a long table
])
def test_split_plan_covers_every_block_once(B, kv, rows, nblk):
    for resident in (1, 3):                     # CTAs per SM (occupancy)
        splits = cp.kv_splits(B, kv, rows, nblk, SMS, resident)
        ranges = cp.kv_ranges(nblk, splits)
        assert 1 <= splits <= max(1, nblk // 2)
        assert len(ranges) == splits and ranges[0][0] == 0
        assert ranges[-1][1] == nblk
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2                        # contiguous, no overlap
        if splits > 1:
            assert all(hi - lo >= 2 for lo, hi in ranges)
        ctas = B * kv * cp.row_tiles(rows)
        # about one wave: never more than a wave of CTAs from the split
        assert splits == 1 or ctas * splits <= resident * SMS


def test_split_plan_reads_shapes_only():
    """The plan takes no tensor: no host ever reads start or the tables.
    At the serving shape (128 CTAs) it fills the wave the walk's occupancy
    allows: 3 ranges at 3 resident CTAs per SM, none at 1."""
    # (the column groups of the general walk are a shape too: fault F)
    assert list(inspect.signature(cp.kv_splits).parameters) == \
        ["B", "kv", "rows", "nblk", "sms", "resident", "groups"]
    assert cp.kv_splits(8, 16, 16, 32, SMS, 3) == 3
    assert cp.kv_splits(8, 16, 16, 32, SMS, 1) == 1
    assert cp.row_tiles(16) == 1 and cp.row_tiles(17) == 2


# ---------------------------------------------------------------------------
# plain partials + merge against the unsplit plain version
# ---------------------------------------------------------------------------
SPLIT_CASES = [  # (B, W, h, kv, hd, bs, nblk, start)
    (3, 5, 8, 2, 16, 8, 6, [0, 9, 30]),        # GQA 4, bs 8
    (2, 16, 4, 4, 32, 16, 8, [0, 100]),        # a W 16 chunk; slot 0 early
    (2, 3, 16, 2, 96, 4, 10, [1, 25]),         # hd 96, GQA 8
]


@pytest.mark.parametrize("splits", [2, 3, 5])
@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("B,W,h,kv,hd,bs,nblk,start", SPLIT_CASES)
def test_split_merge_matches_plain(B, W, h, kv, hd, bs, nblk, start, pool,
                                   splits):
    arrays = _case(B + hd + splits, B, W, h, kv, hd, bs, nblk, start, pool)
    q, kp, vp, bt, st, sc = _torch_case(*arrays, pool)
    want = cp.chunked_prefill_attention_plain(q, kp, vp, bt, st, **sc)
    got, m, l = _split_merge(q, kp, vp, bt, st, splits, sc)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=F32_TOL)
    # a range a row cannot see leaves m = NEG_INF, l = 0 (weight 0)
    unseen = m == NEG_INF
    assert torch.equal(l[unseen], torch.zeros_like(l[unseen]))
    assert bool(unseen.any())                   # slot 0 sees range 0 only


@pytest.mark.parametrize("B,W,h,kv,hd,bs,nblk,start", SPLIT_CASES)
def test_bf16_pool_split_within_the_card_gate(B, W, h, kv, hd, bs, nblk,
                                              start):
    """f32 q over a bf16 pool: p is rounded to bf16 against each range's
    own running max, so a split moves the output by at most a bf16 step of
    p, 2^-8 x max|V| (the card's gate for this pair)."""
    arrays = _case(7, B, W, h, kv, hd, bs, nblk, start, "bf16")
    q, kp, vp, bt, st, sc = _torch_case(*arrays, "bf16")
    want = cp.chunked_prefill_attention_plain(q, kp, vp, bt, st)
    got, _, _ = _split_merge(q, kp, vp, bt, st, 3, sc)
    tol = 2 ** -8 * float(vp.float().abs().max())
    assert float((got - want).abs().max()) <= tol


def test_merge_ignores_the_accumulator_of_an_empty_range():
    """The kernel writes only m = NEG_INF, l = 0 for a range past a row's
    last position; whatever its accumulator holds must not be read."""
    arrays = _case(3, 3, 5, 8, 2, 16, 8, 6, [0, 9, 30])
    q, kp, vp, bt, st, sc = _torch_case(*arrays, "f32")
    parts = [cp.chunked_prefill_partial_plain(q, kp, vp, bt, st, lo, hi)
             for lo, hi in cp.kv_ranges(6, 3)]
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    acc = torch.where((m == NEG_INF)[..., None], float("nan"), acc)
    got = cp.merge_partials_plain(acc, m, l, torch.float32)
    want = cp.chunked_prefill_attention_plain(q, kp, vp, bt, st)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_unseen_pool_rows_never_reach_split_partials(pool):
    """NaN in the null block and in the unseen tail of each sequence's
    last live block (an int8 pool: in its scales) leaks into no partial
    and no merged output; the result equals the NaN-free pool's."""
    shape = (2, 3, 4, 4, 16, 8, 4, [2, 10])
    clean = _case(8, *shape, pool=pool)
    dirty = _case(8, *shape, pool=pool, nan=True)
    outs = []
    for arrays in (clean, dirty):
        q, kp, vp, bt, st, sc = _torch_case(*arrays, pool)
        for splits in (1, 2):
            got, m, l = _split_merge(q, kp, vp, bt, st, splits, sc)
            assert torch.isfinite(got).all() and torch.isfinite(l).all()
            outs.append(got)
    for a, b in zip(outs[:2], outs[2:]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# fault A's shapes: the plain path against the reference Pallas kernel
# ---------------------------------------------------------------------------
FAULT_A_CASES = [  # (B, W, h, kv, hd, bs, nblk, start)
    (2, 4, 4, 2, 96, 8, 3, [0, 13]),           # phi3-mini's head dim
    (1, 16, 16, 2, 128, 8, 4, [9]),            # GQA 8 x hd 128, W 16
    (1, 32, 16, 2, 128, 16, 3, [5]),           # GQA 8 x hd 128, W 32
]


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("B,W,h,kv,hd,bs,nblk,start", FAULT_A_CASES)
def test_fault_a_shapes_match_pallas(ref, B, W, h, kv, hd, bs, nblk, start,
                                     pool):
    q, kp, vp, bt, st, ks, vs = _case(hd + W, B, W, h, kv, hd, bs, nblk,
                                      start, pool)
    jnp = ref.jnp
    jsc = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                     v_scale=jnp.asarray(vs))
    want = np.asarray(ref.chunk(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(bt),
                                jnp.asarray(st), interpret=True, **jsc))
    tq, tk, tv, tbt, tst, sc = _torch_case(q, kp, vp, bt, st, ks, vs, pool)
    got = cp.chunked_prefill_attention(tq, tk, tv, tbt, tst, **sc).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    # and the split the kernel would take at a small card
    splits = max(2, cp.kv_splits(B, kv, W * h // kv, nblk, 4, 1))
    split, _, _ = _split_merge(tq, tk, tv, tbt, tst, splits, sc)
    np.testing.assert_allclose(split.numpy(), want, atol=F32_TOL,
                               rtol=F32_TOL)


def test_launch_checks_refuse_host_tensors():
    """Both paged wrappers launch only on CUDA tensors (a CPU tensor takes
    the plain path before the checks)."""
    q, kp, vp, bt, st, _, _ = _case(0, 1, 2, 2, 2, 16, 4, 2, [0])
    with pytest.raises(ValueError, match="runs on CUDA"):
        cp.launch_checks("chunked_prefill_attention", *map(_t, (q, kp, vp,
                                                                bt, st)))


@pytest.mark.parametrize("hd", [16, 48, 96, 112, 128])
def test_kernel_head_dims(hd):
    cp.check_head_dim(hd)


@pytest.mark.parametrize("hd", [8, 36, 100, 144, 256])
def test_other_head_dims_name_fault_a(hd):
    """These head dims named fault A while the walk stopped at multiples of
    16 up to 128 (ROADMAP Queue 3 fault F); the general walk takes them in
    every (q, pool) dtype pair now."""
    assert cp.general_hd(hd)
    for q_dt, kv_dt in cp.DTYPE_PAIRS:
        cp.check_head_dim(hd, "chunked_prefill_attention", q_dt, kv_dt, 32)


# ---------------------------------------------------------------------------
# fault F: every head dim, the general walk's columns and shared memory
# ---------------------------------------------------------------------------
FAULT_F_CASES = [  # (B, W, h, kv, hd, bs, nblk, start)
    (2, 4, 4, 2, 144, 8, 3, [0, 13]),        # two column groups of 96
    (2, 4, 10, 1, 256, 8, 3, [2, 17]),       # recurrentgemma-2b: MQA 10/1
    (2, 4, 4, 2, 72, 8, 3, [0, 13]),         # ragged, 16-byte rows in bf16
    (2, 5, 4, 2, 66, 8, 3, [5, 12]),         # ragged, 4-byte rows in bf16
]


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("B,W,h,kv,hd,bs,nblk,start", FAULT_F_CASES)
def test_fault_f_shapes_match_pallas(ref, B, W, h, kv, hd, bs, nblk, start,
                                     pool):
    """The plain walk at one key range and at the split the kernel takes
    on a small card against the reference Pallas kernel, which pads hd to
    128 lanes, in interpret mode (float32 at 2e-6)."""
    q, kp, vp, bt, st, ks, vs = _case(hd + W, B, W, h, kv, hd, bs, nblk,
                                      start, pool)
    jnp = ref.jnp
    jsc = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                     v_scale=jnp.asarray(vs))
    want = np.asarray(ref.chunk(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(bt),
                                jnp.asarray(st), interpret=True, **jsc))
    tq, tk, tv, tbt, tst, sc = _torch_case(q, kp, vp, bt, st, ks, vs, pool)
    got = cp.chunked_prefill_attention(tq, tk, tv, tbt, tst, **sc).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    groups = cp.col_groups(hd)[2]
    splits = max(2, cp.kv_splits(B, kv, W * h // kv, nblk, 4, 1, groups))
    split, _, _ = _split_merge(tq, tk, tv, tbt, tst, splits, sc)
    np.testing.assert_allclose(split.numpy(), want, atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("hd", [1, 8, 16, 66, 72, 100, 128, 136, 144, 192,
                                200, 256, 384, 400, 512, 1000])
def test_column_groups_write_every_column_once(hd):
    """The general walk's CTAs of one row tile own the columns [g * GW,
    min((g + 1) * GW, hd)): each column of the head in exactly one group,
    none empty, GW = 128 and KP the staged width (hd up to 15 columns of
    zeros)."""
    kp, gw, groups = cp.col_groups(hd)
    if not cp.general_hd(hd):
        assert (kp, gw, groups) == (hd, hd, 1)
        return
    assert kp % 16 == 0 and hd <= kp < hd + 16
    assert gw == 128
    cols = [c for g in range(groups) for c in range(g * gw,
                                                    min((g + 1) * gw, hd))]
    assert cols == list(range(hd))
    assert (groups - 1) * gw < hd            # no group without a column


@pytest.mark.parametrize("q_dt,kv_dt", cp.DTYPE_PAIRS,
                         ids=lambda d: str(d)[6:])
def test_walk_takes_every_head_dim_up_to_512(q_dt, kv_dt):
    """One CTA of the general walk fits in shared memory at every hd up to
    512 with a 32-entry table (the serving tables), with 3 ring stages (2
    over an f32 pool) where they fit and never fewer than 1; the hd <= 128
    walk (multiples of 16) is untouched."""
    for hd in range(1, cp.MAX_HEAD_DIM + 1):
        cp.check_head_dim(hd, "chunked_prefill_attention", q_dt, kv_dt, 32)
        if cp.general_hd(hd):
            s = cp.walk_stages(hd, 32, q_dt, kv_dt)
            assert 1 <= s <= (2 if kv_dt == torch.float32 else 3)
            assert cp.walk_smem(hd, 32, q_dt, kv_dt, s) <= cp.CTA_SMEM
    # recurrentgemma-2b's hd 256 keeps the full ring
    assert cp.walk_stages(256, 32, q_dt, kv_dt) == \
        (2 if kv_dt == torch.float32 else 3)


def test_head_dim_refusal_names_what_a_cta_cannot_hold():
    """Past 512 an f32 pool runs out of shared memory first: the refusal
    names the bytes one CTA would need, and nothing refuses by fault."""
    cp.check_head_dim(560, "chunked_prefill_attention", torch.float32,
                      torch.float32, 32)
    need = cp.walk_smem(600, 32, torch.float32, torch.float32, 1)
    assert need > cp.CTA_SMEM
    with pytest.raises(ValueError, match=f"one CTA's shared memory would "
                                         f"need {need} B"):
        cp.check_head_dim(600, "chunked_prefill_attention", torch.float32,
                          torch.float32, 32)
    with pytest.raises(ValueError, match="head_dim must be positive"):
        cp.check_head_dim(0)


def test_split_plan_counts_the_column_groups():
    """The grid's CTAs are row tiles x column groups: recurrentgemma-2b's
    decode (8 slots, one kv head, hd 256 in 2 groups) fills half the wave
    the ungrouped walk would, so it takes half the key ranges."""
    groups = cp.col_groups(256)[2]
    assert groups == 2
    assert cp.kv_splits(8, 1, 10, 256, SMS, 1, groups) == SMS // 16
    assert cp.kv_splits(8, 1, 10, 256, SMS, 1) == SMS // 8


def test_decode_takes_head_dim_96():
    assert 96 in pa.HEAD_DIMS
    B, h, kv, hd, bs, nblk = 2, 4, 2, 96, 8, 3
    q, kp, vp, bt, st, _, _ = _case(4, B, 1, h, kv, hd, bs, nblk, [3, 17])
    got = pa.paged_decode_attention(_t(q[:, 0]), _t(kp), _t(vp), _t(bt),
                                    _t(st) + 1)
    want = cp.chunked_prefill_attention_plain(_t(q), _t(kp), _t(vp), _t(bt),
                                              _t(st))[:, 0]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the kernel on the card (run where a CUDA device is present)
# ---------------------------------------------------------------------------
CUDA_CASES = [  # (B, W, h, kv, hd, bs, nblk, start)
    (8, 16, 16, 16, 64, 16, 32, [0, 16, 48, 100, 203, 300, 400, 496]),
    (3, 5, 8, 2, 16, 8, 6, [0, 9, 30]),
    (2, 16, 16, 2, 96, 16, 8, [0, 100]),
    (2, 32, 64, 8, 128, 16, 8, [3, 90]),
]
PAIRS = [("f32", "f32"), ("f32", "bf16"), ("bf16", "bf16"), ("f32", "int8"),
         ("bf16", "int8")]


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    runtime.build()
    for i, (B, W, h, kv, hd, bs, nblk, start) in enumerate(CUDA_CASES):
        for q_dt, pool in PAIRS:
            arrays = _case(i, B, W, h, kv, hd, bs, nblk, start,
                           "int8" if pool == "int8" else "f32", nan=True)
            q, kp, vp, bt, st, sc = _torch_case(*arrays, pool)
            q = q.to(dev, torch.bfloat16 if q_dt == "bf16" else torch.float32)
            kp, vp, bt, st = (t.to(dev) for t in (kp, vp, bt, st))
            sc = {k: v.to(dev) for k, v in sc.items()}
            got = cp.chunked_prefill_attention(q, kp, vp, bt, st, **sc)
            want = cp.chunked_prefill_attention_plain(q, kp, vp, bt, st,
                                                      **sc)
            # bf16 out: one bf16 step of each output, 2^-7 x max(|out|, 1);
            # f32 over a bf16 pool: a bf16 step of p; otherwise the order
            # of f32 sums
            d = (got.float() - want.float()).abs()
            if q_dt == "bf16":
                d = d / (2 ** -7 * want.float().abs().clamp_min(1))
                tol = 1.0
            else:
                tol = 2 ** -8 * float(vp.float().nan_to_num().abs().max()) \
                    if pool == "bf16" else 2e-5
            err = float(d.max())
            assert err <= tol, (i, q_dt, pool, err, tol,
                                cp.chunked_prefill_attention.last_grid)


CUDA_F_CASES = [  # (B, W, h, kv, hd, bs, nblk, start): fault F's shapes
    (4, 16, 10, 1, 256, 16, 32, [0, 100, 300, 496]),   # recurrentgemma W 16
    (4, 1, 10, 1, 256, 16, 32, [0, 99, 300, 511]),     # ... and W 1
    (3, 16, 8, 2, 192, 16, 8, [0, 40, 100]),           # hd 192
    (3, 8, 4, 2, 72, 8, 6, [0, 9, 40]),                # ragged, aligned
    (3, 8, 4, 2, 66, 8, 6, [3, 9, 40]),                # ragged, unaligned
    (2, 4, 4, 1, 512, 16, 8, [5, 100]),                # hd 512: 4 groups
]


@pytest.mark.cuda
def test_cuda_fault_f_matches_plain_version():
    """The general walk at fault F's head dims in every (q, pool) dtype
    pair, NaN in the null block and the unseen tails, at the planned key
    ranges and at 1 and 3, under the gates of the test above."""
    from unittest import mock
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    runtime.build()
    for i, (B, W, h, kv, hd, bs, nblk, start) in enumerate(CUDA_F_CASES):
        for q_dt, pool in PAIRS:
            arrays = _case(i, B, W, h, kv, hd, bs, nblk, start,
                           "int8" if pool == "int8" else "f32", nan=True)
            q, kp, vp, bt, st, sc = _torch_case(*arrays, pool)
            q = q.to(dev, torch.bfloat16 if q_dt == "bf16" else torch.float32)
            kp, vp, bt, st = (t.to(dev) for t in (kp, vp, bt, st))
            sc = {k: v.to(dev) for k, v in sc.items()}
            want = cp.chunked_prefill_attention_plain(q, kp, vp, bt, st,
                                                      **sc)
            for splits in (None, 1, 3):
                with mock.patch.object(cp, "kv_splits",
                                       (lambda *a, s=splits: s) if splits
                                       else cp.kv_splits):
                    got = cp.chunked_prefill_attention(q, kp, vp, bt, st,
                                                       **sc)
                d = (got.float() - want.float()).abs()
                if q_dt == "bf16":
                    d = d / (2 ** -7 * want.float().abs().clamp_min(1))
                    tol = 1.0
                else:
                    tol = 2 ** -8 * float(vp.float().nan_to_num().abs()
                                          .max()) if pool == "bf16" else 2e-5
                err = float(d.max())
                assert err <= tol, (i, hd, q_dt, pool, splits, err, tol,
                                    cp.chunked_prefill_attention.last_grid)
