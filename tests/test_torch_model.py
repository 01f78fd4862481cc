"""The port's dense model against the JAX reference, on the paged pool.

Weights come from the reference's ``Model(cfg).init(PRNGKey)``, go
through numpy and ``repro_torch.bridge``, and both packages run
``mixed_step`` then ``decode_step`` on the same tokens, positions and
block tables, with every ``matmul_backend`` x ``paged_attn_impl``
combination (the reference's Pallas kernels in interpret mode, the port's
kernels as their plain versions).  Logits and the written pool blocks
are compared:

* float32 compute over a float32 pool (both packages take a pool of any
  float dtype): logits within 1e-4 * max|logits| and pool rows within
  1e-5 (summation order and transcendental rounding only).  Over the
  serving layout's bf16 pool a last-bit float32 difference can round a
  K/V element to a neighbouring bf16 value in one package only, so that
  layout is held at the bf16 tolerance;
* bf16 compute (bf16 pool): logits within 2e-2 * max|logits|, the
  reference's own tolerance (tests/test_decode_equivalence.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_cfg
from repro.core.paging import PagingConfig as JPagingConfig
from repro.models.model import Model as JModel
from repro.models.model import ModelOptions
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.paging import PagingConfig
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec)
from repro_torch.models.attention import KVCache
from repro_torch.models.model import Model

J_CFG = reduced_cfg("qwen1.5-0.5b")
CFG = reduced(get_config("qwen1.5-0.5b"))
# GQA with n_rep = 4 at the reduced width
J_CFG_GQA = dataclasses.replace(J_CFG, num_kv_heads=1)
CFG_GQA = dataclasses.replace(CFG, num_kv_heads=1)

BS, NBLK, NUM_BLOCKS = 8, 4, 12
# slot 2 has a single block; its later table entries are the null block
TABLES = np.array([[3, 1, 7, 0], [2, 9, 4, 11], [5, 0, 0, 0]], np.int32)
N_LIVE = np.array([8, 8, 5], np.int32)


def test_port_config_matches_reference():
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "head_dim", "activation", "norm",
                  "qkv_bias", "rope_theta", "tie_embeddings", "family"):
        assert getattr(CFG, field) == getattr(J_CFG, field), field
    from repro.configs import REGISTRY
    full, j_full = get_config("qwen1.5-0.5b"), REGISTRY["qwen1.5-0.5b"]
    assert dataclasses.asdict(full) == {
        k: v for k, v in dataclasses.asdict(j_full).items()
        if k in dataclasses.asdict(full)}


def _pair(j_cfg, cfg, compute, mm, impl):
    jdt = jnp.float32 if compute == "fp32" else jnp.bfloat16
    tdt = torch.float32 if compute == "fp32" else torch.bfloat16
    jm = JModel(j_cfg, ModelOptions(compute_dtype=jdt, matmul_backend=mm,
                                    paged_attn_impl=impl))
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(cfg, compute_dtype=tdt, matmul_backend=mm,
               paged_attn_impl=impl, device="cpu")
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                       cfg, "cpu"))
    return jm, params, tm


def _steps(jm, params, tm, cfg, seed=0, pool_f32=False):
    """mixed_step (a chunk with partial slots) then decode_step, in both
    packages; returns (jax, port) logits pairs and final pools."""
    rs = np.random.RandomState(seed)
    W = 8
    toks = rs.randint(0, cfg.vocab_size, (3, W)).astype(np.int32)
    start = np.zeros(3, np.int32)
    jc = jm.init_cache(3, NBLK * BS, paging=JPagingConfig(BS, NUM_BLOCKS))
    tc = tm.init_cache(PagingConfig(BS, NUM_BLOCKS))
    if pool_f32:
        jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
        tc = KVCache(tc.k.float(), tc.v.float())
    jl, jc = jm.mixed_step(params, jc, jnp.asarray(toks), jnp.asarray(start),
                           jnp.asarray(N_LIVE),
                           block_tables=jnp.asarray(TABLES))
    tl = tm.mixed_step(tc, torch.from_numpy(toks), torch.from_numpy(start),
                       torch.from_numpy(N_LIVE), torch.from_numpy(TABLES))
    live = np.arange(W)[None, :] < N_LIVE[:, None]
    mixed = (np.asarray(jl)[live], tl.numpy()[live])
    dtoks = rs.randint(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    jd, jc = jm.decode_step(params, jc, jnp.asarray(dtoks),
                            jnp.asarray(N_LIVE),
                            block_tables=jnp.asarray(TABLES))
    td = tm.decode_step(tc, torch.from_numpy(dtoks), torch.from_numpy(N_LIVE),
                        torch.from_numpy(TABLES))
    return mixed, (np.asarray(jd), td.numpy()), jc, tc


def _close(pair, rel):
    ref, got = pair
    assert np.isfinite(got).all()
    err, scale = np.abs(ref - got).max(), np.abs(ref).max()
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


@pytest.mark.parametrize("mm", ["xla", "pallas"])
@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_steps_match_reference_f32(mm, impl):
    jm, params, tm = _pair(J_CFG, CFG, "fp32", mm, impl)
    mixed, dec, jc, tc = _steps(jm, params, tm, CFG, pool_f32=True)
    _close(mixed, 1e-4)
    _close(dec, 1e-4)
    # the written pool blocks (row 0, the null block, holds dead-lane
    # garbage in both packages and is excluded)
    for jp, tp in ((jc.k, tc.k), (jc.v, tc.v)):
        ref = np.asarray(jp[:, 1:])
        np.testing.assert_allclose(tp[:, 1:].numpy(), ref, rtol=1e-5,
                                   atol=1e-5)
        assert np.abs(ref).max() > 0


@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_steps_match_reference_f32_bf16_pool(impl):
    """The serving layout: f32 compute over the bf16 pool."""
    jm, params, tm = _pair(J_CFG, CFG, "fp32", "xla", impl)
    mixed, dec, jc, tc = _steps(jm, params, tm, CFG, seed=5)
    _close(mixed, 2e-2)
    _close(dec, 2e-2)
    for jp, tp in ((jc.k, tc.k), (jc.v, tc.v)):
        assert tp.dtype == torch.bfloat16
        np.testing.assert_allclose(tp[:, 1:].float().numpy(),
                                   np.asarray(jp[:, 1:], np.float32),
                                   rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("mm,impl", [("xla", "gather"), ("pallas", "pallas")])
def test_steps_match_reference_bf16(mm, impl):
    jm, params, tm = _pair(J_CFG, CFG, "bf16", mm, impl)
    mixed, dec, _, _ = _steps(jm, params, tm, CFG, seed=1)
    _close(mixed, 2e-2)
    _close(dec, 2e-2)


@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_steps_match_reference_gqa(impl):
    jm, params, tm = _pair(J_CFG_GQA, CFG_GQA, "fp32", "xla", impl)
    mixed, dec, _, _ = _steps(jm, params, tm, CFG_GQA, seed=2, pool_f32=True)
    _close(mixed, 1e-4)
    _close(dec, 1e-4)


def test_layers_match_reference():
    """Norms, activations, RoPE and the embedding pair against the
    reference's ``models/layers.py`` (f32; transcendental rounding only)."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rs = np.random.RandomState(6)
    x, w, b = (rs.randn(*s).astype(np.float32) for s in ((3, 5, 16), (16,),
                                                         (16,)))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    cases = [(jl.rmsnorm(jx, jnp.asarray(w)), tl.rmsnorm(tx, torch.from_numpy(w))),
             (jl.layernorm(jx, jnp.asarray(w), jnp.asarray(b)),
              tl.layernorm(tx, torch.from_numpy(w), torch.from_numpy(b)))]
    for kind in ("relu", "gelu", "geglu", "swiglu", "silu"):
        cases.append((jl.activate(jx, kind), tl.activate(tx, kind)))
    q = rs.randn(2, 5, 4, 16).astype(np.float32)
    pos = rs.randint(0, 500, (2, 5)).astype(np.int32)
    cases.append((jl.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e6),
                  tl.apply_rope(torch.from_numpy(q), torch.from_numpy(pos),
                                1e6)))
    table = rs.randn(11, 16).astype(np.float32)
    toks = np.array([[3, 0, 10]], np.int32)
    cases.append((jl.embed(jnp.asarray(toks), {"table": jnp.asarray(table)},
                           jnp.float32),
                  tl.embed(torch.from_numpy(toks), torch.from_numpy(table),
                           torch.float32)))
    cases.append((jl.unembed(jx, {"table": jnp.asarray(table)}),
                  tl.unembed(tx, torch.from_numpy(table))))
    for want, got in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert tl.is_gated("swiglu") and not tl.is_gated("gelu")


def test_forward_matches_reference():
    jm, params, tm = _pair(J_CFG, CFG, "fp32", "xla", "gather")
    toks = np.random.RandomState(3).randint(0, CFG.vocab_size, (2, 11))
    ref = np.asarray(jm.forward(params, {"tokens": jnp.asarray(toks)}))
    got = tm(torch.from_numpy(toks).to(torch.int32)).numpy()
    _close((ref, got), 1e-4)


@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_chunked_prefill_then_decode_matches_forward(impl):
    """The serving gold invariant on the port alone: a prompt fed through
    mixed steps chunk by chunk, then token-by-token decode steps, gives
    the full-sequence forward's logits (bf16 compute, 2e-2 * max)."""
    tm = Model(CFG, matmul_backend="pallas", paged_attn_impl=impl,
               device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(4)
    P, steps, W = 13, 4, 8
    toks = torch.from_numpy(rs.randint(0, CFG.vocab_size, (2, P + steps))
                            .astype(np.int32))
    full = tm(toks)
    tol = 2e-2 * float(full.abs().max())
    tables = torch.tensor([[4, 2, 0, 0], [1, 3, 5, 0]], dtype=torch.int32)
    cache = tm.init_cache(PagingConfig(BS, 6))
    for s0 in range(0, P, W):
        n = min(W, P - s0)
        chunk = torch.zeros(2, W, dtype=torch.int32)
        chunk[:, :n] = toks[:, s0:s0 + n]
        lg = tm.mixed_step(cache, chunk, torch.full((2,), s0, dtype=torch.int32),
                           torch.full((2,), n, dtype=torch.int32), tables)
        assert float((lg[:, :n] - full[:, s0:s0 + n]).abs().max()) < tol
    for t in range(P, P + steps):
        lg = tm.decode_step(cache, toks[:, t:t + 1],
                            torch.full((2,), t, dtype=torch.int32), tables)
        assert float((lg[:, 0] - full[:, t]).abs().max()) < tol


def test_init_scales_and_state_dict_names():
    tm = Model(CFG, device="cpu").init(torch.Generator().manual_seed(1))
    names = set(tm.state_dict())
    jm = JModel(J_CFG)
    flat = jax.tree_util.tree_flatten_with_path(jm.abstract())[0]
    j_names = set()
    for path, leaf in flat:
        key = ".".join(p.key for p in path)
        if key.startswith("layers."):
            j_names |= {f"layers.{i}.{key[7:]}" for i in range(leaf.shape[0])}
        else:
            j_names.add(key)
    assert names == j_names
    sd = tm.state_dict()
    assert sd["embed.table"].dtype == torch.float32
    assert abs(float(sd["embed.table"].std()) - 0.02) < 2e-3
    w1 = sd["layers.0.ffn.w1.kernel"]
    assert w1.dtype == torch.bfloat16                     # compute dtype
    assert abs(float(w1.float().std()) * CFG.d_model ** 0.5 - 1) < 0.1
    assert float(sd["layers.1.attn.wq.bias"].abs().max()) == 0
    assert float((sd["final_norm.scale"] - 1).abs().max()) == 0


def test_entry_points_need_a_device_choice():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(CFG)


@pytest.mark.parametrize("kw,match", [
    (dict(arch=reduced(get_config("whisper-medium"))),
     "cache_layout='paged' is unsupported for family 'audio'"),
    (dict(arch=dataclasses.replace(CFG, family="audio"),
          memory=MemorySpec(cache_layout="dense")),
     "family 'audio' with no EncDecConfig"),
    (dict(mesh=object()), "ROADMAP.md Queue 1 item 13"),
    (dict(arch=dataclasses.replace(CFG, family="audio")),
     "family 'audio' with no EncDecConfig"),
])
def test_spec_rejects_what_is_not_ported(kw, match):
    """A mesh is not ported (item 13); the audio family is (its paged
    layout refused with the reference's message, tests/test_torch_audio.py),
    and an audio config without its EncDecConfig is refused."""
    base = dict(arch=CFG, memory=MemorySpec(cache_layout="paged"))
    base.update(kw)
    with pytest.raises(ValueError, match=match):
        RuntimeSpec(**base)


def test_spec_serves_the_fully_quantized_options():
    spec = RuntimeSpec(
        arch=CFG, execution=ExecutionSpec(matmul_backend="pallas",
                                          paged_attn_impl="pallas",
                                          quant="int8"),
        memory=MemorySpec(cache_layout="paged", kv_dtype="int8"))
    assert spec.execution.quant_min_size == 65_536   # the reference default
    tm = Model.from_spec(spec, device="cpu")
    assert tm.codec.quantized and tm.quant == "int8"
    # at the default floor no leaf of the reduced model is quantized (the
    # largest, a stacked FFN kernel, holds 2 x 64 x 128 = 16 384 elements)
    assert all(t.dtype != torch.int8 for t in tm.state_dict().values())


@pytest.mark.parametrize("size,ok", [(-1, False), (0, True), (1, True),
                                     (65_536, True)])
def test_spec_checks_quant_min_size(size, ok):
    if not ok:
        with pytest.raises(ValueError, match="quant_min_size=-1 must be >= 0"):
            ExecutionSpec(quant="int8", quant_min_size=size)
        return
    spec = RuntimeSpec(arch=CFG, execution=ExecutionSpec(
        quant="int8", quant_min_size=size),
        memory=MemorySpec(cache_layout="paged"))
    n_int8 = sum(t.dtype == torch.int8 for t in
                 Model.from_spec(spec, device="cpu").state_dict().values())
    assert n_int8 == (0 if size == 65_536 else 15)


def test_spec_keeps_reference_spellings_and_checks():
    spec = RuntimeSpec(arch=CFG, execution=ExecutionSpec(
        matmul_backend="pallas", paged_attn_impl="pallas",
        compute_dtype="fp32"), memory=MemorySpec(cache_layout="paged"))
    assert spec.execution.compute_dtype == torch.float32
    with pytest.raises(ValueError, match="matmul_backend"):
        ExecutionSpec(matmul_backend="cuda")
    # an explicit chunked policy (``"auto"`` falls back to bucketed here,
    # as the reference's engine does)
    with pytest.raises(ValueError, match="block-aligned"):
        RuntimeSpec(arch=CFG, memory=MemorySpec(cache_layout="paged",
                                                block_size=16),
                    scheduler=SchedulerSpec(policy="chunked", chunk_size=8))
    with pytest.raises(ValueError, match="must divide"):
        MemorySpec(cache_layout="paged", max_len=60, block_size=16)
