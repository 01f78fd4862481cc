"""The K split of the bf16 matmul loop shared by ``tiled_matmul``, ``ffn1``,
``ffn1_gated`` and ``qkv_proj`` (``csrc/mma_tile.cuh``).

The kernel cuts K into ranges of whole 16-wide slices (``k_splits``,
``k_ranges`` in ``repro_torch.kernels.tiled_matmul``), writes each range's
float32 partial sums to a workspace, and a reduce pass adds the ranges in
order 0..S-1 before the epilogue.  These tests hold the plan itself (from
M and K alone, whatever the widths and the number of weights; ranges that
tile K exactly) and run the same steps in plain PyTorch on the CPU
(``matmul_partials_plain`` per range, ``reduce_partials_plain``, the
plain versions' ``splits``) against the unsplit plain versions and the JAX
reference in interpret mode.

Tolerance: float32 at 2e-6 x max|reference|, as ``tests/test_torch_kernels.py``
holds the plain matmul to the reference: the split adds the same products
in another order, which moves a sum of K <= 1000 terms of order 1 by a few
float32 rounding steps of its largest partial sums.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ffn as ffn_mod
from repro_torch.kernels import qkv_proj as qkv_mod
from repro_torch.kernels import tiled_matmul as tm
from test_torch_threads import one_thread  # noqa: F401 (autouse)

F32_TOL = 2e-6


@pytest.fixture(scope="module")
def ref():
    """The reference's Pallas matmul (interpret mode) and its plain FFN
    references."""
    import jax.numpy as jnp

    from repro.kernels import ref as j_ref
    from repro.kernels.tiled_matmul import tiled_matmul
    return types.SimpleNamespace(jnp=jnp, matmul=tiled_matmul, ref=j_ref)


def _rnd(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=F32_TOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
WIDTHS = [(1024,), (2816,), (67,), (2816, 2816), (1024, 1024, 1024),
          (8192, 1024, 1024), (199, 67, 67)]


@pytest.mark.parametrize("M", [1, 8, 16, 17, 77, 128, 129, 256, 300, 512])
def test_k_splits_depends_on_m_and_k_only(M):
    """Whatever the widths and the number of weights of a launch, a bf16
    call takes k_splits(M, K) ranges (so qkv_proj sums each product as
    tiled_matmul does), with a workspace of splits * M * sum(widths)
    floats; a float32 call takes one range and no workspace."""
    for K in (8, 15, 16, 100, 255, 256, 768, 1024, 2816, 8192):
        want = tm.k_splits(M, K)
        assert 1 <= want <= -(-K // tm.K_SLICE)
        assert want <= (8 if M <= 16 else 4)
        for widths in WIDTHS:
            x = torch.empty(M, K, dtype=torch.bfloat16, device="meta")
            splits, ws = tm.split_plan(x, widths)
            assert splits == want
            if splits == 1:
                assert ws is None
            else:
                assert ws.dtype == torch.float32
                assert ws.numel() == splits * M * sum(widths)
            assert tm.split_plan(x.float(), widths) == (1, None)


def test_k_splits_at_the_serving_shapes():
    """The plan at the serving path's projections: a decode step (M = 8)
    and a mixed step (M = 128) against K = 1024 (wq/wk/wv/wo, w1/wg) and
    K = 2816 (w2), the library rows' K = 768 (adaptor_bert, M = 512) and
    K = 8192 (qwen2-72b)."""
    assert [tm.k_splits(8, k) for k in (1024, 2816)] == [4, 8]
    assert [tm.k_splits(128, k) for k in (1024, 2816, 8192)] == [4, 4, 4]
    assert tm.k_splits(512, 768) == 1


@pytest.mark.parametrize("K", [1, 8, 15, 16, 17, 100, 255, 256, 300, 1000,
                               1024, 2816, 8192])
def test_k_ranges_tile_k(K):
    """Every split count up to the slice count cuts [0, K) into contiguous,
    non-empty ranges of whole 16-wide slices (the last may end ragged at
    K), whose slice counts differ by at most one."""
    slices = -(-K // tm.K_SLICE)
    for splits in range(1, min(slices, 12) + 1):
        r = tm.k_ranges(K, splits)
        assert len(r) == splits and r[0][0] == 0 and r[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
        assert all(lo % tm.K_SLICE == 0 and hi > lo for lo, hi in r)
        n = [-(-(hi - lo) // tm.K_SLICE) for lo, hi in r]
        assert sum(n) == slices and max(n) - min(n) <= 1
    if K < tm.K_SLICE:
        assert tm.k_splits(8, K) == 1 and tm.k_ranges(K, 1) == [(0, K)]


# ---------------------------------------------------------------------------
# partials + ordered reduce in plain PyTorch
# ---------------------------------------------------------------------------
SPLIT_CASES = [
    (77, 300, 199, 1),     # divides no tile, one range
    (77, 300, 199, 7),     # ragged K: 19 slices in 7 ranges, last ends at 300
    (5, 1000, 67, 3),      # decode-like skinny M
    (8, 1024, 96, None),   # a decode step's plan: 4 ranges
    (128, 2816, 40, None),  # a mixed step's w2: 4 ranges of 44 slices
    (3, 12, 10, 1),        # K < 16: one ragged slice
]


def _splits(M, K, splits):
    return tm.k_splits(M, K) if splits is None else splits


@pytest.mark.parametrize("M,K,N,splits", SPLIT_CASES)
def test_split_partials_match_plain(M, K, N, splits):
    splits = _splits(M, K, splits)
    a, b = torch.from_numpy(_rnd(M, M, K)), torch.from_numpy(_rnd(N, K, N))
    parts = tm.matmul_partials_plain(a, b, splits)
    assert len(parts) == splits
    assert all(p.shape == (M, N) and p.dtype == torch.float32 for p in parts)
    got = tm.reduce_partials_plain(parts)
    assert torch.equal(got, tm.tiled_matmul_plain(a, b, splits))
    _close(got.numpy(), tm.tiled_matmul_plain(a, b).numpy())


@pytest.mark.parametrize("M,K,N,splits", SPLIT_CASES[:4])
def test_split_partials_match_pallas(ref, M, K, N, splits):
    """The reduced partials against the reference's Pallas matmul at
    ragged shapes (zero-padded blocks in HBM there)."""
    splits = _splits(M, K, splits)
    a, b = _rnd(M + 1, M, K), _rnd(N + 1, K, N)
    jnp = ref.jnp
    want = np.asarray(ref.matmul(jnp.asarray(a), jnp.asarray(b), bm=32,
                                 bk=128, bn=64, interpret=True))
    got = tm.reduce_partials_plain(tm.matmul_partials_plain(
        torch.from_numpy(a), torch.from_numpy(b), splits))
    _close(got.numpy(), want)


def test_split_is_the_same_for_every_product_of_qkv():
    """qkv_proj's plain version with a split is three split matmuls, bit for
    bit, as the kernel's products are at MHA and at GQA widths."""
    x = torch.from_numpy(_rnd(0, 24, 300)).bfloat16()
    for nq, nkv in ((64, 64), (96, 32)):
        ws = [torch.from_numpy(_rnd(n + i, 300, n)).bfloat16()
              for i, n in enumerate((nq, nkv, nkv))]
        for o, w in zip(qkv_mod.qkv_proj_plain(x, *ws, splits=3), ws,
                        strict=True):
            assert torch.equal(o, tm.tiled_matmul_plain(x, w, 3))


@pytest.mark.parametrize("M,K,N,splits", SPLIT_CASES[1:4])
@pytest.mark.parametrize("activation", ["relu", "gelu", "silu"])
def test_ffn1_epilogue_after_reduce_matches_ref(ref, M, K, N, splits,
                                                activation):
    """Bias and activation see the full ordered sum of the ranges, as
    ``repro.kernels.ref.ffn1_ref`` sees the whole product."""
    splits = _splits(M, K, splits)
    x, w1, b1 = _rnd(1, M, K), _rnd(2, K, N) / np.sqrt(K), _rnd(3, N)
    jnp = ref.jnp
    want = ref.ref.ffn1_ref(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                            activation)
    got = ffn_mod.ffn1_plain(*(torch.from_numpy(t) for t in (x, w1, b1)),
                             activation, splits=splits)
    _close(got.numpy(), want)


@pytest.mark.parametrize("M,K,N,splits", SPLIT_CASES[1:4])
@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_ffn1_gated_epilogue_after_reduce_matches_ref(ref, M, K, N, splits,
                                                      activation):
    """The gate multiplies the two full ordered sums, as
    ``repro.kernels.ref.ffn1_gated_ref`` multiplies the whole products."""
    splits = _splits(M, K, splits)
    x = _rnd(4, M, K)
    w1, wg = _rnd(5, K, N) / np.sqrt(K), _rnd(6, K, N) / np.sqrt(K)
    jnp = ref.jnp
    want = ref.ref.ffn1_gated_ref(jnp.asarray(x), jnp.asarray(w1),
                                  jnp.asarray(wg), activation)
    got = ffn_mod.ffn1_gated_plain(*(torch.from_numpy(t) for t in (x, w1, wg)),
                                   activation, splits=splits)
    _close(got.numpy(), want)
