"""Split-KV flash attention: the key-range plan, the plain partial and the
plain merge of ``repro_torch.kernels.flash_attention``.

Where the grid of 64-row query tiles leaves the card's SMs idle, the CUDA
kernel cuts the keys into ranges of whole 64-key tiles (``kv_splits`` /
``kv_ranges``), writes each range's unnormalised accumulator and running
(max, sum), and a merge kernel combines them.  These tests run the same
steps in plain PyTorch on the CPU (``flash_attention_partial_plain`` per
range, ``merge_partials_plain``) and hold them against
``flash_attention_plain`` at float32 within 1e-6 * max|V| (the merge only
reorders float32 sums), at bfloat16 within the card kernel's gate, and
against the JAX reference
(``repro.kernels.ops.flash_attention`` in interpret mode) at the
tolerances of ``tests/test_torch_ops.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

SMS = 132                       # the H100 SXM's SM count
NEG_INF = fa.NEG_INF


@pytest.fixture(scope="module")
def ref():
    """The reference's public kernel API (interpret mode on the CPU)."""
    import jax.numpy as jnp

    from repro.kernels import ops as j_ops
    return types.SimpleNamespace(jnp=jnp, ops=j_ops)


def _qkv(B, Sq, Skv, H, hd, seed=0):
    r = np.random.RandomState(seed)
    return tuple(r.randn(B, s, H, hd).astype(np.float32)
                 for s in (Sq, Skv, Skv))


def _split_merge(q, k, v, causal, splits):
    parts = [fa.flash_attention_partial_plain(q, k, v, lo, hi, causal=causal)
             for lo, hi in fa.kv_ranges(q.shape[1], k.shape[1], causal,
                                        splits)]
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    return fa.merge_partials_plain(acc, m, l, q.dtype), m, l


# (B, Sq, Skv, H, hd, causal); every case splits at 132 SMs
SPLIT_CASES = [
    (1, 64, 1500, 2, 16, False),    # whisper-like cross attention
    (2, 40, 700, 2, 16, False),     # Sq != Skv, Skv not a multiple of 64
    (1, 8, 600, 2, 32, False),      # a short query over a ragged last tile
    (1, 300, 300, 1, 16, True),     # causal: rows < 128 see nothing of range 2
    (1, 400, 260, 1, 16, True),     # causal with Sq > Skv
    (1, 200, 700, 1, 16, True),     # causal with Sq < Skv: keys past Sq unseen
]


@pytest.mark.parametrize("B,Sq,Skv,H,hd,causal", SPLIT_CASES)
def test_split_merge_matches_plain(B, Sq, Skv, H, hd, causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, Sq, Skv, H, hd))
    splits = fa.kv_splits(B, H, Sq, Skv, causal, SMS)
    assert splits > 1
    got, m, l = _split_merge(q, k, v, causal, splits)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(v.abs().max()))
    # a range a row cannot see leaves m = NEG_INF, l = 0 (weight 0)
    unseen = m == NEG_INF
    assert torch.equal(l[unseen], torch.zeros_like(l[unseen]))
    if causal and Sq >= 128:
        assert bool(unseen.any())


@pytest.mark.parametrize("B,Sq,Skv,H,hd,causal", SPLIT_CASES)
def test_bf16_split_merge_within_the_card_gate(B, Sq, Skv, H, hd, causal):
    """At bf16 each range rounds p against its own running max, as the
    card's split kernel does; the merged output still lies within the gate
    the card's kernel is held to: 2^-7 x max|V| and 2^-6 x max|output|."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(B, Sq, Skv, H, hd, seed=7))
    got, _, _ = _split_merge(q, k, v, causal,
                             fa.kv_splits(B, H, Sq, Skv, causal, SMS))
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16
    lim = min(2 ** -7 * float(v.float().abs().max()),
              2 ** -6 * float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= lim


@pytest.mark.parametrize("B,Sq,Skv,H,hd", [
    (1, 64, 1500, 16, 64),          # whisper-medium cross attention
    (1, 64, 1000, 8, 80),           # the card's ragged-hd case
])
def test_bf16_gate_catches_log2_domain_m(B, Sq, Skv, H, hd):
    """The card's bf16 gate is tight enough to see a fault in the ranges'
    merge weights: partials whose m is written in the log2 domain (weights
    e^(1.44 dm) instead of e^dm) fail it, while the correct split passes."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(B, Sq, Skv, H, hd, seed=11))
    want = fa.flash_attention_plain(q, k, v, causal=False)
    parts = [fa.flash_attention_partial_plain(q, k, v, lo, hi, causal=False)
             for lo, hi in fa.kv_ranges(
                 Sq, Skv, False, fa.kv_splits(B, H, Sq, Skv, False, SMS))]
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    lim = min(2 ** -7 * float(v.float().abs().max()),
              2 ** -6 * float(want.float().abs().max()))

    def err(m_used):
        got = fa.merge_partials_plain(acc, m_used, l, torch.bfloat16)
        return float((got.float() - want.float()).abs().max())
    assert err(m) <= lim < err(m * np.log2(np.e))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_one_range_partial_is_the_plain_version(causal, dt):
    """One range over all keys, merged, is ``flash_attention_plain`` bit
    for bit: the partial runs the same block loop."""
    q, k, v = (torch.from_numpy(a).to(dt) for a in _qkv(2, 70, 90, 2, 16, 3))
    acc, m, l = fa.flash_attention_partial_plain(q, k, v, 0, 90,
                                                 causal=causal)
    got = fa.merge_partials_plain(acc[None], m[None], l[None], dt)
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.parametrize("B,Sq,Skv,H,causal,splits", [
    (1, 512, 512, 16, True, 1),     # qwen1.5-0.5b prompt: 128 CTAs
    (8, 64, 64, 12, False, 1),      # adaptor_bert: 96 CTAs, one key tile
    (1, 64, 1500, 16, False, 8),    # whisper-medium cross: 16 -> 128 CTAs
    (1, 512, 512, 64, True, 1),     # qwen2-72b-width prompt: 512 CTAs
])
def test_kv_splits_at_model_shapes(B, Sq, Skv, H, causal, splits):
    assert fa.kv_splits(B, H, Sq, Skv, causal, SMS) == splits


@pytest.mark.parametrize("B,Sq,Skv,H,causal", [
    (1, 64, 1500, 16, False), (1, 1, 4096, 1, False), (1, 64, 130, 1, False),
    (2, 40, 700, 2, False), (1, 300, 300, 1, True), (1, 400, 260, 1, True),
    (1, 200, 700, 1, True), (1, 64, 64, 1, False), (3, 1, 1000, 5, False),
])
@pytest.mark.parametrize("sms", [16, 132])
def test_kv_ranges_cover_the_keys_in_whole_tiles(B, Sq, Skv, H, causal, sms):
    splits = fa.kv_splits(B, H, Sq, Skv, causal, sms)
    ranges = fa.kv_ranges(Sq, Skv, causal, splits)
    kv = min(Skv, Sq) if causal else Skv
    assert len(ranges) == splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == kv
    tiles = []
    for (lo, hi), nxt in zip(ranges, ranges[1:] + [(kv, kv)]):
        assert lo % fa.TILE == 0 and hi == nxt[0] and hi > lo
        tiles.append(-(-(hi - lo) // fa.TILE))
    if splits > 1:
        assert min(tiles) >= 2
        # about one wave: never more CTAs than SMs
        assert splits * -(-Sq // fa.TILE) * B * H <= sms


@pytest.mark.parametrize("B,Sq,Skv,H,hd,causal", [
    (1, 64, 700, 2, 16, False),
    (1, 300, 300, 1, 16, True),
])
def test_split_merge_matches_reference(ref, B, Sq, Skv, H, hd, causal):
    arrays = _qkv(B, Sq, Skv, H, hd, seed=5)
    want = np.asarray(ref.ops.flash_attention(
        *(ref.jnp.asarray(a) for a in arrays), causal=causal), np.float32)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got, _, _ = _split_merge(q, k, v, causal,
                             fa.kv_splits(B, H, Sq, Skv, causal, SMS))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
