"""The port's kernel library entry point against the JAX reference's.

``repro_torch.kernels.ops`` on CPU tensors (every wrapper runs its
kernel's plain PyTorch version) against ``repro.kernels.ops`` in interpret
mode, as ``tests/test_kernels.py`` runs it, on the same numpy inputs made
from a seed.  The shapes are the reference suite's (ragged edges, GQA
Nkv < Nq, Sq != Skv, every activation) plus leading batch dims and a kv
length past one 512-key block.

Tolerances, relative to max|reference|: float32 at 1e-5, where the two
differ by the order of sums only.  bfloat16 at the reference suite's own
tolerances: 2e-2 for qkv_proj and ffn1, 3e-2 for ffn1_gated and flash
attention (each output is one rounding of a float32 value, and a value
near a bf16 rounding boundary may round the other way after a sum in
another order; the gated product and attention's p carry two such
roundings), and 2^-7 for the norms (one rounding of the output).

The kernels themselves run only on a CUDA card (``cuda`` marker).  This
module imports the JAX reference only inside its fixture, so the card
tests also run where JAX is absent:
``python -m pytest -q --noconftest -m cuda tests/test_torch_ops.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ffn as ffn_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import layernorm as ln_mod
from repro_torch.kernels import ops
from repro_torch.kernels import qkv_proj as qkv_mod
from repro_torch.kernels import runtime
from repro_torch.kernels.tiled_matmul import tiled_matmul

F32_TOL = 1e-5
NEW_KERNELS = (ffn_mod.ffn1, ffn_mod.ffn1_gated, qkv_mod.qkv_proj,
               ln_mod.layernorm, ln_mod.rmsnorm, fa_mod.flash_attention)


@pytest.fixture(scope="module")
def ref():
    """The reference's public kernel API (interpret mode on the CPU)."""
    import jax.numpy as jnp

    from repro.kernels import ops as j_ops
    return types.SimpleNamespace(jnp=jnp, ops=j_ops)


def _rnd(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(ref, a, dt):
    """The same numpy array as a JAX and a torch array of dtype ``dt``."""
    jdt = ref.jnp.bfloat16 if dt == torch.bfloat16 else ref.jnp.float32
    return ref.jnp.asarray(a, jdt), torch.from_numpy(a).to(dt)


def _close(got: torch.Tensor, want, tol: float, dt) -> None:
    assert got.dtype == dt
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _tol(dt, bf16_tol: float) -> float:
    return F32_TOL if dt == torch.float32 else bf16_tol


DTYPES = [torch.float32, torch.bfloat16]


# ---------------------------------------------------------------------------
# qkv_proj
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lead,D,Nq,Nkv", [
    ((96,), 256, 512, 128),        # GQA: K/V a quarter of Q
    ((64,), 200, 198, 66),         # ragged everywhere
    ((32,), 128, 256, 256),        # MHA
    ((2, 3, 7), 48, 64, 16),       # leading batch dims
])
@pytest.mark.parametrize("dt", DTYPES)
def test_qkv_proj_matches_reference(ref, lead, D, Nq, Nkv, dt):
    s = sum(lead) + D + Nq + Nkv
    arrays = [_rnd(s, *lead, D), _rnd(s + 1, D, Nq), _rnd(s + 2, D, Nkv),
              _rnd(s + 3, D, Nkv)]
    j, t = zip(*(_pair(ref, a, dt) for a in arrays))
    want = ref.ops.qkv_proj(*j)
    got = ops.qkv_proj(*t)
    for g, w, n in zip(got, want, (Nq, Nkv, Nkv)):
        assert g.shape == (*lead, n)
        _close(g, w, _tol(dt, 2e-2), dt)


# ---------------------------------------------------------------------------
# ffn1 / ffn1_gated
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ["relu", "gelu", "silu", "swiglu", "geglu"])
@pytest.mark.parametrize("dt", DTYPES)
def test_ffn1_matches_reference(ref, act, dt):
    x, w1, b1 = _rnd(30, 4, 16, 96), _rnd(31, 96, 200), _rnd(32, 200)
    (jx, tx), (jw, tw) = _pair(ref, x, dt), _pair(ref, w1, dt)
    want = ref.ops.ffn1(jx, jw, ref.jnp.asarray(b1), act)
    got = ops.ffn1(tx, tw, torch.from_numpy(b1), act)
    assert got.shape == (4, 16, 200)
    _close(got, want, _tol(dt, 2e-2), dt)


def test_ffn1_bias_in_x_dtype_matches_reference(ref):
    x, w1, b1 = _rnd(33, 37, 64), _rnd(34, 64, 50), _rnd(35, 50)
    j, t = zip(*(_pair(ref, a, torch.bfloat16) for a in (x, w1, b1)))
    _close(ops.ffn1(*t, "gelu"), ref.ops.ffn1(*j, "gelu"), 2e-2,
           torch.bfloat16)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu"])
@pytest.mark.parametrize("dt", DTYPES)
def test_ffn1_gated_matches_reference(ref, act, dt):
    arrays = [_rnd(36, 2, 32, 96), _rnd(37, 96, 200), _rnd(38, 96, 200)]
    j, t = zip(*(_pair(ref, a, dt) for a in arrays))
    want = ref.ops.ffn1_gated(*j, act)
    got = ops.ffn1_gated(*t, act)
    assert got.shape == (2, 32, 200)
    _close(got, want, _tol(dt, 3e-2), dt)


# ---------------------------------------------------------------------------
# layernorm / rmsnorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(50, 200), (8, 1024), (3, 65),
                                   (2, 5, 3, 96)])
@pytest.mark.parametrize("dt", DTYPES)
def test_norms_match_reference(ref, shape, dt):
    D = shape[-1]
    x = 2 * _rnd(40, *shape) + 0.5
    g, b = 1 + 0.1 * _rnd(41, D), 0.1 * _rnd(42, D)
    jx, tx = _pair(ref, x, dt)
    jg, jb = ref.jnp.asarray(g), ref.jnp.asarray(b)
    tg, tb = torch.from_numpy(g), torch.from_numpy(b)
    _close(ops.layernorm(tx, tg, tb), ref.ops.layernorm(jx, jg, jb),
           _tol(dt, 2 ** -7), dt)
    _close(ops.rmsnorm(tx, tg), ref.ops.rmsnorm(jx, jg), _tol(dt, 2 ** -7),
           dt)


def test_norm_parameters_in_x_dtype_match_reference(ref):
    x, g, b = _rnd(43, 6, 80), 1 + 0.1 * _rnd(44, 80), 0.1 * _rnd(45, 80)
    j, t = zip(*(_pair(ref, a, torch.bfloat16) for a in (x, g, b)))
    _close(ops.layernorm(*t), ref.ops.layernorm(*j), 2 ** -7, torch.bfloat16)
    _close(ops.rmsnorm(*t[:2]), ref.ops.rmsnorm(*j[:2]), 2 ** -7,
           torch.bfloat16)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,Sq,Skv,H,hd,causal", [
    (1, 100, 100, 3, 32, True),     # the reference suite's shapes, BH = 3
    (1, 100, 100, 3, 32, False),
    (1, 64, 64, 3, 64, True),
    (1, 130, 130, 3, 16, True),
    (2, 40, 70, 2, 16, False),      # cross attention, Sq != Skv
    (2, 70, 40, 2, 16, True),       # causal with Sq > Skv
    (1, 8, 600, 2, 16, False),      # two kv blocks, the second ragged
    (1, 520, 520, 1, 16, True),     # causal across a block boundary
])
@pytest.mark.parametrize("dt", DTYPES)
def test_flash_attention_matches_reference(ref, B, Sq, Skv, H, hd, causal,
                                           dt):
    arrays = [_rnd(9, B, Sq, H, hd), _rnd(10, B, Skv, H, hd),
              _rnd(11, B, Skv, H, hd)]
    j, t = zip(*(_pair(ref, a, dt) for a in arrays))
    want = ref.ops.flash_attention(*j, causal=causal)
    got = ops.flash_attention(*t, causal=causal)
    _close(got, want, _tol(dt, 3e-2), dt)


# ---------------------------------------------------------------------------
# argument checks and launch counts
# ---------------------------------------------------------------------------
def test_wrappers_reject_bad_arguments():
    x, w = torch.zeros(4, 8), torch.zeros(8, 6)
    for fn in (lambda a: ops.ffn1(x, w, torch.zeros(6), a),
               lambda a: ops.ffn1_gated(x, w, w, a)):
        with pytest.raises(ValueError, match="tanh"):
            fn("tanh")
    with pytest.raises(ValueError, match="dtypes"):
        ops.ffn1(x.double(), w.double(), torch.zeros(6))
    with pytest.raises(ValueError, match="dtypes"):
        ops.ffn1_gated(x, w, w.bfloat16())
    with pytest.raises(ValueError, match="bias"):
        ops.ffn1(x, w, torch.zeros(6, dtype=torch.float64))
    with pytest.raises(ValueError, match="do not form a matmul"):
        ops.ffn1_gated(x, w, torch.zeros(8, 5))
    with pytest.raises(ValueError, match="Nkv <= Nq"):
        ops.qkv_proj(x, torch.zeros(8, 4), w, w)
    with pytest.raises(ValueError, match="dtypes"):
        ops.qkv_proj(x.bfloat16(), w.bfloat16(), w, w.bfloat16())
    with pytest.raises(ValueError, match="parameter dtypes"):
        ops.layernorm(x, torch.ones(8), torch.zeros(8).bfloat16())
    with pytest.raises(ValueError, match=r"\[D=8\]"):
        ops.rmsnorm(x, torch.ones(7))
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match=r"\[B, Sq, H, hd\]"):
        ops.flash_attention(q, torch.zeros(1, 5, 2, 8), torch.zeros(1, 5, 2, 8))
    with pytest.raises(ValueError, match="dtypes"):
        ops.flash_attention(q, q.bfloat16(), q)
    # no silent fallback: a tensor on neither the CPU nor CUDA raises, and
    # so does a mix of devices
    m = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rmsnorm(m, torch.ones(8, device="meta"))
    with pytest.raises(ValueError, match="operands on"):
        ops.ffn1(m, w, torch.zeros(6))
    with pytest.raises(ValueError, match="operands on"):
        ops.qkv_proj(x, w, w, w.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


def test_cpu_calls_count_no_launch():
    before = [fn.launches for fn in NEW_KERNELS]
    x, w = torch.ones(3, 8), torch.ones(8, 4)
    ops.ffn1(x, w, torch.zeros(4))
    ops.ffn1_gated(x, w, w)
    ops.qkv_proj(x, w, w, w)
    ops.layernorm(x, torch.ones(8), torch.zeros(8))
    ops.rmsnorm(x, torch.ones(8))
    ops.flash_attention(torch.ones(1, 3, 2, 4), torch.ones(1, 5, 2, 4),
                        torch.ones(1, 5, 2, 4))
    assert [fn.launches for fn in NEW_KERNELS] == before


def test_ops_reexports_the_serving_wrappers():
    from repro_torch.kernels import int8_matmul, tiled_matmul as tm
    assert ops.tiled_matmul is tm.matmul
    assert ops.quantized_dense is int8_matmul.quantized_dense


# ---------------------------------------------------------------------------
# the kernels on the card (run where a CUDA device is present)
# ---------------------------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    runtime.build()
    return torch.device("cuda")


def _near(got, want, tol):
    """|got - want| <= tol * max|want| on the card."""
    assert got.dtype == want.dtype and got.shape == want.shape
    want = want.float()
    assert float((got.float() - want).abs().max()) <= \
        tol * float(want.abs().max())


def _dev(a, dev, dt):
    return torch.from_numpy(a).to(dev, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_cuda_kernels_match_plain_versions(dt):
    """Each kernel against its plain version on the card: f32 by the order
    of sums (1e-5), bf16 by one rounding of the output (2^-7; flash 2^-7
    of max|V|, p rounded against another running max, and at most 2^-6 of
    max|plain output|, far below max|V| over long rows)."""
    dev = _cuda()
    tol = 1e-5 if dt == torch.float32 else 2 ** -7
    x, w = _dev(_rnd(1, 77, 300), dev, dt), _dev(_rnd(2, 300, 199), dev, dt)
    wg, b = _dev(_rnd(3, 300, 199), dev, dt), _dev(_rnd(4, 199), dev,
                                                    torch.float32)
    for act in ("relu", "gelu", "silu"):
        _near(ffn_mod.ffn1(x, w, b, act), ffn_mod.ffn1_plain(x, w, b, act),
              tol)
        _near(ffn_mod.ffn1_gated(x, w, wg, act),
              ffn_mod.ffn1_gated_plain(x, w, wg, act), tol)
    for M, D, Nq, Nkv in ((77, 300, 199, 67), (8, 256, 512, 128)):
        xs = _dev(_rnd(5, M, D), dev, dt)
        ws = [_dev(_rnd(6 + i, D, n), dev, dt) for i, n in
              enumerate((Nq, Nkv, Nkv))]
        got = qkv_mod.qkv_proj(xs, *ws)
        for g, wt, p in zip(got, ws, qkv_mod.qkv_proj_plain(xs, *ws)):
            assert torch.equal(g, tiled_matmul(xs, wt))   # bit for bit
            _near(g, p, tol)
    # the norms: every layout of norm_plan (a warp a row, warps a row,
    # streaming; in 16-byte units or element by element), R 1 and a 16K
    # prefill, starts one element past 16 bytes, both parameter dtypes
    for R, D, off in ((33, 65, 0), (33, 1024, 0), (33, 3000, 0),
                      (33, 8192, 0), (5, 65536, 0), (1, 1024, 0),
                      (16384, 1024, 0), (33, 1024, 1), (3, 65536, 1)):
        xs = _dev(2 * _rnd(9, R * D + off) + 0.5, dev, dt)[off:].view(R, D)
        for pdt in (torch.float32, torch.bfloat16):
            g = _dev(1 + 0.1 * _rnd(10, D), dev, pdt)
            bt = _dev(0.1 * _rnd(11, D), dev, pdt)
            _near(ln_mod.layernorm(xs, g, bt),
                  ln_mod.layernorm_plain(xs, g, bt), tol)
            _near(ln_mod.rmsnorm(xs, g), ln_mod.rmsnorm_plain(xs, g), tol)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, Sq, Skv, H, hd, causal in ((2, 100, 100, 3, 64, True),
                                      (1, 40, 700, 2, 80, False),
                                      (1, 130, 60, 2, 128, True),
                                      (1, 64, 1500, 4, 64, False),   # split
                                      (1, 512, 512, 2, 128, True),   # split
                                      (1, 64, 1000, 2, 36, False)):  # ragged
        if Skv >= 1000:
            assert fa_mod.kv_splits(B, H, Sq, Skv, causal, sms) > 1
        q, k, v = (_dev(_rnd(12 + i, B, s, H, hd), dev, dt)
                   for i, s in enumerate((Sq, Skv, Skv)))
        got = fa_mod.flash_attention(q, k, v, causal=causal)
        want = fa_mod.flash_attention_plain(q, k, v, causal=causal)
        lim = (2e-5 if dt == torch.float32 else 2 ** -7) \
            * float(v.float().abs().max())
        if dt != torch.float32:     # and within the output's own scale
            lim = min(lim, 2 ** -6 * float(want.float().abs().max()))
        assert float((got.float() - want.float()).abs().max()) <= lim


@pytest.mark.cuda
def test_cuda_ops_entry_point_launches_every_kernel():
    dev = _cuda()
    before = [fn.launches for fn in NEW_KERNELS]
    dt = torch.bfloat16
    x = _dev(_rnd(20, 2, 9, 64), dev, dt)
    w, b = _dev(_rnd(21, 64, 96), dev, dt), _dev(_rnd(22, 96), dev, dt)
    assert ops.ffn1(x, w, b, "gelu").shape == (2, 9, 96)
    assert ops.ffn1_gated(x, w, w).shape == (2, 9, 96)
    q, k, v = ops.qkv_proj(x, w, w[:, :32].contiguous(),
                           w[:, 32:64].contiguous())
    assert (q.shape, k.shape, v.shape) == ((2, 9, 96), (2, 9, 32), (2, 9, 32))
    g = torch.ones(64, device=dev)
    assert ops.layernorm(x, g, g).shape == x.shape
    assert ops.rmsnorm(x, g).shape == x.shape
    qa = q.reshape(2, 9, 3, 32)
    assert ops.flash_attention(qa, qa, qa).shape == qa.shape
    assert all(fn.launches > n for fn, n in zip(NEW_KERNELS, before))
