"""The dense cache layout and the bucketed scheduler in the port against the
JAX reference.

Weights come from the reference's ``Model(cfg).init(PRNGKey)`` through
numpy and ``repro_torch.bridge``.  Checked:

* ``blockwise_attention`` with a small ``query_block`` (causal and not,
  the MLA value width) against the reference's, and ``gqa_attention``'s
  switch to it at ``BLOCKWISE_THRESHOLD`` (patched down);
* ``gqa_prefill``, ``gqa_decode``, ``mla_prefill`` and ``mla_decode``, one
  layer at float32, over the float and the int8 codec: outputs and the
  written cache rows (the port's dense cache holds one spare row past the
  reference's, which takes the writes past the end);
* the counterpart of ``tests/test_decode_equivalence.py``: prefill plus
  token-by-token decode over the dense layout reproduces ``forward`` for
  qwen1.5-0.5b, granite-moe-1b-a400m, deepseek-v3-671b and
  phi-3-vision-4.2b (the reference's tolerances), and the prefill's
  logits are the reference's;
* the counterpart of ``tests/test_chunked_prefill.py``'s headline tests:
  greedy streams, lifecycle events, step counts and ``compilations()``
  equal the reference engine's for {bucketed, chunked} x {dense, paged},
  with int8 KV on the dense layout, int8 weights and a fleet, and the
  chunked streams equal the bucketed ones;
* ``memory_stats``'s refusal on the dense layout, the spec's ``"auto"``
  rule and its messages (the reference's, verbatim);
* ``harness.replay``'s ``deterministic_json()`` equal to the reference's
  on a bucketed engine over each layout;
* ``program_launches`` (``kernels/counts.py``) against the wrappers' calls
  on the kernels' plain versions, and ``serve --cache-layout dense``;
* on the card (``cuda``-marked): one CUDA graph per bucket, graphed =
  eager, and dense-layout decode through the kernels.
"""
import dataclasses
import functools
import types
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import harness
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.kv_quant import CacheCodec
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec, SpeculationSpec, maxima_for)
from repro_torch.harness.trace import dumps_trace
from repro_torch.kernels import counts
from repro_torch.kernels import layernorm as ln_mod
from repro_torch.kernels import tiled_matmul as tm_mod
from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine, _buckets
from test_torch_threads import one_thread  # noqa: F401 (autouse)

QWEN = "qwen1.5-0.5b"
FAMILIES = [QWEN, "granite-moe-1b-a400m", "deepseek-v3-671b",
            "phi-3-vision-4.2b"]
# absorbed-MLA decode is another (more accurate) contraction order than
# the naive prefill (tests/test_decode_equivalence.py)
DECODE_TOL = {"deepseek-v3-671b": 5e-2}
FN_TOL = 1e-5                         # x max|out|, one layer at float32
STEP_TOL = 1e-4
PROMPTS = [[1, 2, 3], list(range(1, 9)), [4], list(range(2, 40, 3)),
           [7, 7, 7, 7, 7], list(range(1, 20))]


def _lossless(c):
    if c.moe is None:
        return c
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=float(c.moe.num_experts)))


def _cfg(name):
    return _lossless(reduced(get_config(name)))


CFG = _cfg(QWEN)
CFG_B = dataclasses.replace(
    CFG, name="adaptor-bert-shaped", num_layers=1, d_model=48,
    num_heads=3, num_kv_heads=3, d_ff=96, vocab_size=96)


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from repro import harness as j_harness
    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import kv_quant as j_kv
    from repro.core import spec as j_spec
    from repro.harness import trace as j_trace
    from repro.models import attention as j_attn
    from repro.models.model import Model as JModel
    from repro.models.model import ModelOptions
    from repro.serving.engine import ServingEngine as JServingEngine

    @functools.cache
    def build(name, seed=0, member=None):
        j_cfg = _lossless(j_reduced(REGISTRY[name]))
        cfg = _cfg(name)
        if member == "b":
            j_cfg = dataclasses.replace(
                j_cfg, name="adaptor-bert-shaped", num_layers=1, d_model=48,
                num_heads=3, num_kv_heads=3, d_ff=96, vocab_size=96)
            cfg = CFG_B
        params = JModel(j_cfg).init(jax.random.PRNGKey(seed))
        sd = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
        return j_cfg, cfg, params, sd

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, attn=j_attn, kv=j_kv, model=JModel,
        options=ModelOptions, spec=j_spec, engine=JServingEngine,
        harness=j_harness, trace=j_trace, build=build)


def _close(want, got, rel):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    assert np.isfinite(got).all()
    err, scale = np.abs(want - got).max(), np.abs(want).max()
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


def _port_model(sd, cfg=CFG, **kw):
    tm = Model(cfg, compute_dtype=torch.float32, device="cpu", **kw)
    tm.load_state_dict(sd)
    return tm


# ---------------------------------------------------------------------------
# the attention functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("vd", [16, 24])
def test_blockwise_attention_matches_reference(ref, causal, vd):
    """Query blocks of 8 over 29 queries (a ragged last block); ``vd`` 24:
    MLA's value width differs from the query's."""
    rs = np.random.RandomState(0)
    q = rs.randn(2, 29, 4, 16).astype(np.float32)
    k = rs.randn(2, 29, 4, 16).astype(np.float32)
    v = rs.randn(2, 29, 4, vd).astype(np.float32)
    jnp = ref.jnp
    want = ref.attn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        query_block=8)
    got = attn.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   query_block=8)
    _close(want, got.numpy(), FN_TOL)
    full = attn.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal)
    _close(full.numpy(), got.numpy(), FN_TOL)


def test_forward_switches_to_blockwise_at_the_threshold(ref):
    """With the threshold patched to 8 (the port's query blocks of 4) a
    12-token forward runs ``blockwise_attention``; its logits are the
    reference's under the same threshold (one padded query block)."""
    _, _, params, sd = ref.build(QWEN)
    jnp = ref.jnp
    toks = np.random.RandomState(1).randint(0, CFG.vocab_size, (2, 12))
    jm = ref.model(ref.build(QWEN)[0], ref.options(compute_dtype=jnp.float32))
    tm = _port_model(sd)
    calls = []
    blockwise = attn.blockwise_attention

    def counting(*a, **k):
        calls.append(a[0].shape[1])
        return blockwise(*a, **k, query_block=4)

    with mock.patch.object(attn, "BLOCKWISE_THRESHOLD", 8), \
            mock.patch.object(attn, "blockwise_attention", counting), \
            mock.patch.object(ref.attn, "BLOCKWISE_THRESHOLD", 8):
        got = tm.forward(torch.from_numpy(toks.astype(np.int32)))
        want = jm.forward(params, {"tokens": jnp.asarray(toks, jnp.int32)})
    assert calls == [12] * CFG.num_layers
    _close(want, got.numpy(), STEP_TOL)


def _layer(ref, name):
    j_cfg, cfg, params, sd = ref.build(name)
    stack = params["layers"]
    jp = ref.jax.tree.map(lambda a: a[0], stack)["attn"]
    return j_cfg, cfg, jp, _port_model(sd, cfg).layers[0].attn


def _codec_pair(ref, kv):
    return ref.kv.CacheCodec(kv), CacheCodec(kv)


def _spare(a) -> torch.Tensor:
    """The reference's dense rows [B, S, ...] with the port's spare row, as
    a tensor of the same dtype (bf16 through float32)."""
    bf16 = a.dtype.name == "bfloat16"
    a = np.asarray(a, np.float32 if bf16 else a.dtype)
    t = torch.from_numpy(np.pad(a, [(0, 0), (0, 1)] + [(0, 0)] * (a.ndim - 2)))
    return t.to(torch.bfloat16) if bf16 else t


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_gqa_prefill_and_decode_match_reference(ref, kv):
    j_cfg, cfg, jp, tp = _layer(ref, QWEN)
    jc, tc = _codec_pair(ref, kv)
    jnp = ref.jnp
    rs = np.random.RandomState(2)
    x = rs.randn(3, 10, cfg.d_model).astype(np.float32)
    pos = np.tile(np.arange(10, dtype=np.int32), (3, 1))
    want, jcache = ref.attn.gqa_prefill(
        jnp.asarray(x), jp, j_cfg, positions=jnp.asarray(pos), max_len=16,
        codec=jc)
    got, tcache = attn.gqa_prefill(
        torch.from_numpy(x), tp, cfg, torch.from_numpy(pos), max_len=16,
        mm="xla", codec=tc)
    _close(want, got.numpy(), FN_TOL)
    for jt, tt in zip(jcache, tcache):
        if jt is None:
            assert tt is None
            continue
        assert tuple(tt.shape) == jt.shape
        _close(np.asarray(jt, np.float32), tt.float().numpy(), 2 ** -7)
    # decode over the prefilled rows, one slot past the end of the cache
    idx = np.array([10, 3, 16], np.int32)
    xd = rs.randn(3, 1, cfg.d_model).astype(np.float32)
    jcache = ref.jax.tree.map(lambda a: a, jcache)
    want, jnew = ref.attn.gqa_decode(jnp.asarray(xd), jp, j_cfg, jcache,
                                     jnp.asarray(idx), codec=jc)
    dense = KVCache(*(None if t is None else _spare(t) for t in jcache))
    got = attn.gqa_decode(torch.from_numpy(xd), tp, cfg, dense,
                          torch.from_numpy(idx), mm="xla", codec=tc)
    _close(want, got.float().numpy(), FN_TOL)
    for jt, tt in zip(jnew, dense):
        if jt is not None:
            _close(np.asarray(jt, np.float32), tt[:, :16].float().numpy(),
                   FN_TOL)


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_mla_prefill_and_decode_match_reference(ref, kv):
    j_cfg, cfg, jp, tp = _layer(ref, "deepseek-v3-671b")
    jc, tc = _codec_pair(ref, kv)
    jnp = ref.jnp
    rs = np.random.RandomState(3)
    x = rs.randn(3, 10, cfg.d_model).astype(np.float32)
    pos = np.tile(np.arange(10, dtype=np.int32), (3, 1))
    want, jcache = ref.attn.mla_prefill(
        jnp.asarray(x), jp, j_cfg, positions=jnp.asarray(pos), max_len=16,
        codec=jc)
    got, tcache = attn.mla_prefill(
        torch.from_numpy(x), tp, cfg, torch.from_numpy(pos), max_len=16,
        mm="xla", codec=tc)
    _close(want, got.numpy(), FN_TOL)
    for jt, tt in zip(jcache, tcache):
        if jt is not None:
            assert tuple(tt.shape) == jt.shape
            _close(np.asarray(jt, np.float32), tt.float().numpy(), 2 ** -7)
    idx = np.array([10, 3, 16], np.int32)
    xd = rs.randn(3, 1, cfg.d_model).astype(np.float32)
    want, jnew = ref.attn.mla_decode(jnp.asarray(xd), jp, j_cfg, jcache,
                                     jnp.asarray(idx), codec=jc)
    dense = MLACache(*(None if t is None else _spare(t) for t in jcache))
    got = attn.mla_decode(torch.from_numpy(xd), tp, cfg, dense,
                          torch.from_numpy(idx), mm="xla", codec=tc)
    _close(want, got.float().numpy(), FN_TOL)
    for jt, tt in zip(jnew, dense):
        if jt is not None:
            _close(np.asarray(jt, np.float32), tt[:, :16].float().numpy(),
                   FN_TOL)


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_dense_gqa_mixed_takes_the_codec(ref, kv):
    """The dense mixed step over an int8 cache (item 12b gave it the
    codec): outputs and rows against the reference's ``gqa_mixed``."""
    j_cfg, cfg, jp, tp = _layer(ref, QWEN)
    jc, tc = _codec_pair(ref, kv)
    jnp = ref.jnp
    rs = np.random.RandomState(4)
    S, W = 24, 8
    x = rs.randn(3, W, cfg.d_model).astype(np.float32)
    shape = (3, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    k0, ks0 = jc.encode(jnp.asarray(rs.randn(*shape).astype(np.float32))) \
        if kv == "int8" else (jnp.asarray(rs.randn(*shape), jnp.bfloat16),
                              None)
    v0, vs0 = jc.encode(jnp.asarray(rs.randn(*shape).astype(np.float32))) \
        if kv == "int8" else (jnp.asarray(rs.randn(*shape), jnp.bfloat16),
                              None)
    start = np.array([0, 12, 20], np.int32)
    n_live = np.array([8, 1, 8], np.int32)
    want, jnew = ref.attn.gqa_mixed(
        jnp.asarray(x), jp, j_cfg, ref.attn.KVCache(k0, v0, ks0, vs0),
        jnp.asarray(start), jnp.asarray(n_live), codec=jc)

    dense = KVCache(*(None if t is None else _spare(t)
                      for t in (k0, v0, ks0, vs0)))
    got = attn.gqa_mixed(torch.from_numpy(x), tp, cfg, dense,
                         torch.from_numpy(start), torch.from_numpy(n_live),
                         mm="xla", codec=tc)
    pos = start[:, None] + np.arange(W)[None, :]
    live = (np.arange(W)[None, :] < n_live[:, None]) & (pos < S)
    _close(np.asarray(want, np.float32)[live], got.float().numpy()[live],
           FN_TOL)
    for jt, tt in zip(jnew, dense):
        if jt is not None:
            _close(np.asarray(jt, np.float32), tt[:, :S].float().numpy(),
                   2 ** -7)


# ---------------------------------------------------------------------------
# prefill + decode = forward (tests/test_decode_equivalence.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_then_decode_matches_forward(ref, name):
    j_cfg, cfg, params, sd = ref.build(name)
    jnp = ref.jnp
    model = Model(cfg, device="cpu")
    model.load_state_dict(sd)
    B, P = 2, 5
    if cfg.frontend is not None:
        P = max(P, cfg.frontend.num_tokens)
    S = P + 3
    rs = np.random.RandomState(1)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, S))
                            .astype(np.int32))
    fe = None
    if cfg.frontend is not None:
        fe = torch.from_numpy(rs.randn(B, cfg.frontend.num_tokens,
                                       cfg.d_model).astype(np.float32)
                              ).to(torch.bfloat16)
    full = model.forward(toks, fe)
    tol = DECODE_TOL.get(name, 2e-2) * (float(full.abs().max()) + 1e-6)
    logits, cache = model.prefill(toks[:, :P], S, fe)
    assert tuple(cache[0].shape[:3]) == (cfg.num_layers, B, S + 1)
    assert float((logits - full[:, :P]).abs().max()) < tol
    for t in range(P, S):
        lg = model.decode_step(cache, toks[:, t:t + 1],
                               torch.full((B,), t, dtype=torch.int32))
        err = float((lg[:, 0] - full[:, t]).abs().max())
        assert err < tol, f"{name} step {t}: {err} vs {tol}"
    # the prefill's logits are the reference's (float32 compute)
    jm = ref.model(j_cfg, ref.options(compute_dtype=jnp.float32))
    batch = {"tokens": jnp.asarray(toks[:, :P].numpy())}
    if fe is not None:
        batch["frontend"] = jnp.asarray(fe.float().numpy(), jnp.bfloat16)
    want, _ = jm.prefill(params, batch, max_len=S)
    got, _ = _port_model(sd, cfg).prefill(toks[:, :P], S, fe)
    _close(want, got.numpy(), STEP_TOL)


# ---------------------------------------------------------------------------
# the engine against the reference's (tests/test_chunked_prefill.py)
# ---------------------------------------------------------------------------
def _engines(ref, policy, layout, kv="compute", quant="none", fleet=False,
             spec_k=0):
    j_cfg, cfg, params, sd = ref.build(QWEN)
    mem = dict(cache_layout=layout, max_batch=4, max_len=64, block_size=8,
               kv_dtype=kv)
    qkw = dict(quant="int8", quant_min_size=1) if quant == "int8" else {}
    j_max = t_max = None
    if fleet:
        jb, cb, pb, sb = ref.build(QWEN, 1, "b")
        j_max = ref.spec.maxima_for(j_cfg, jb, seq_max=64)
        t_max = maxima_for(cfg, cb, seq_max=64)
    s = ref.spec
    je = ref.engine(s.RuntimeSpec(
        arch=j_cfg, maxima=j_max,
        execution=s.ExecutionSpec(compute_dtype="fp32", **qkw),
        memory=s.MemorySpec(**mem),
        scheduler=s.SchedulerSpec(policy=policy, chunk_size=8),
        speculation=s.SpeculationSpec(draft_model=j_cfg, k=spec_k)
        if spec_k else None), **({"max_models": 2} if fleet else {}))
    te = ServingEngine(RuntimeSpec(
        arch=cfg, maxima=t_max,
        execution=ExecutionSpec(compute_dtype="fp32", **qkw),
        memory=MemorySpec(**mem),
        scheduler=SchedulerSpec(policy=policy, chunk_size=8),
        speculation=SpeculationSpec(draft_model=cfg, k=spec_k)
        if spec_k else None), max_models=2 if fleet else 4, device="cpu")
    if fleet:
        je.add_model(params, j_cfg)
        je.add_model(pb, jb)
        te.add_model(sd, cfg)
        te.add_model(sb, cb)
    else:
        je.load(params, draft=params if spec_k else None)
        te.load(sd, draft=sd if spec_k else None)
    return je, te


def _drain(eng, fleet=False):
    log = []
    eng.events.subscribe(log.append)
    uids = [eng.submit(p, max_new_tokens=5) for p in PROMPTS]
    if fleet:
        uids += [eng.submit(p, max_new_tokens=5, model=1)
                 for p in ([4, 5], [6, 7, 8], list(range(2, 30, 2)))]
    done = {r.uid: r.generated for r in eng.run_to_completion()}
    return [done[u] for u in uids], [(e.kind, e.uid, e.step, e.data)
                                     for e in log]


def _same(je, te, fleet=False):
    want, got = _drain(je, fleet), _drain(te, fleet)
    assert got == want
    for key in ("decode_steps", "prefill_tokens", "max_step_prefill_tokens",
                "device_gets", "harvest_elems"):
        assert te.stats[key] == je.stats[key], key
    assert dict(te.compilations) == dict(je.compilations())
    assert te.scheduler == je.scheduler
    return got[0]


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("policy", ["bucketed", "chunked"])
def test_streams_events_and_compilations_match_reference(ref, policy,
                                                         layout):
    streams = _same(*_engines(ref, policy, layout))
    if policy == "chunked":
        # the headline claim: chunked = bucketed
        assert streams == _drain(_engines(ref, "bucketed", layout)[1])[0]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_bucketed_over_float32_pools_matches_reference(ref, layout):
    """Both engines handed a float32 cache (the harness tests' setting):
    the bf16 staging cache of a prefill is cast into it, as the
    reference's insert casts."""
    je, te = _engines(ref, "bucketed", layout)
    je.cache = ref.jax.tree.map(lambda a: a.astype(ref.jnp.float32),
                                je.cache)
    te.cache = type(te.cache)(*(None if t is None else t.float()
                                for t in te.cache))
    _same(je, te)


@pytest.mark.parametrize("policy", ["bucketed", "chunked"])
def test_int8_kv_on_the_dense_layout_matches_reference(ref, policy):
    je, te = _engines(ref, policy, "dense", kv="int8")
    assert te.cache.k.dtype == torch.int8
    assert tuple(te.cache.k_scale.shape) == (CFG.num_layers, 4, 65,
                                             CFG.num_kv_heads)
    _same(je, te)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_int8_weights_on_the_bucketed_scheduler_match_reference(ref,
                                                                layout):
    _same(*_engines(ref, "bucketed", layout, quant="int8"))


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("policy", ["bucketed", "chunked"])
def test_fleet_matches_reference(ref, policy, layout):
    je, te = _engines(ref, policy, layout, fleet=True)
    assert te.fabric is not None
    _same(je, te, fleet=True)


def test_speculation_on_the_dense_layout_matches_reference(ref):
    """The target verifies over the dense layout (no block tables)."""
    je, te = _engines(ref, "auto", "dense", spec_k=2)
    _same(je, te)
    assert te.stats["spec_steps"] == je.stats["spec_steps"] > 0
    assert te.stats["spec_accepted"] == je.stats["spec_accepted"]


def test_bucketed_admission_samples_and_preempts_like_the_reference(ref):
    """A pool of 8 blocks preempts under the bucketed scheduler: banked
    tokens resume through a new bucket's prefill; eos ends a request at its
    first token."""
    j_cfg, cfg, params, sd = ref.build(QWEN)
    mem = dict(cache_layout="paged", max_batch=4, max_len=64, block_size=8,
               num_blocks=8)
    je = ref.engine(ref.spec.RuntimeSpec(
        arch=j_cfg, execution=ref.spec.ExecutionSpec(compute_dtype="fp32"),
        memory=ref.spec.MemorySpec(**mem),
        scheduler=ref.spec.SchedulerSpec(policy="bucketed")))
    te = ServingEngine(RuntimeSpec(
        arch=cfg, execution=ExecutionSpec(compute_dtype="fp32"),
        memory=MemorySpec(**mem),
        scheduler=SchedulerSpec(policy="bucketed")), device="cpu")
    je.load(params)
    te.load(sd)
    out = []
    for eng in (je, te):
        first = _drain(eng)[0][0][0]
        log = []
        eng.events.subscribe(log.append)
        uids = [eng.submit(p, max_new_tokens=20) for p in PROMPTS[1:5]]
        uids.append(eng.submit([1, 2, 3], max_new_tokens=5, eos_id=first))
        done = {r.uid: r.generated for r in eng.run_to_completion()}
        out.append(([done[u] for u in uids], eng.stats["preemptions"],
                    [(e.kind, e.uid, e.step, e.data) for e in log]))
    assert out[1] == out[0]
    assert out[1][1] > 0 and out[1][0][-1] == [out[1][0][-1][0]]


# ---------------------------------------------------------------------------
# the spec and the engine's surface
# ---------------------------------------------------------------------------
def test_memory_stats_refuses_the_dense_layout(ref):
    _, te = _engines(ref, "bucketed", "dense")
    with pytest.raises(ValueError, match="memory_stats requires "
                                         "cache_layout='paged'"):
        te.memory_stats()


@pytest.mark.parametrize("mem,sched,want", [
    (dict(cache_layout="paged", block_size=8), dict(chunk_size=8),
     "chunked"),
    (dict(cache_layout="paged", block_size=8), dict(chunk_size=12),
     "bucketed"),                                # not block-aligned
    (dict(cache_layout="dense"), dict(chunk_size=12), "chunked"),
    (dict(cache_layout="dense"), dict(chunk_size=128), "bucketed"),
    (dict(cache_layout="dense"), dict(policy="bucketed"), "bucketed"),
])
def test_auto_resolves_as_the_reference_engine(ref, mem, sched, want):
    j_cfg, cfg, params, _ = ref.build(QWEN)
    m = dict(max_batch=2, max_len=64, **mem)
    spec = RuntimeSpec(arch=cfg, memory=MemorySpec(**m),
                       scheduler=SchedulerSpec(**sched))
    assert spec.resolved_policy == want
    assert ServingEngine(spec, device="cpu").scheduler == want
    je = ref.engine(ref.spec.RuntimeSpec(
        arch=j_cfg, memory=ref.spec.MemorySpec(**m),
        scheduler=ref.spec.SchedulerSpec(**sched)))
    assert je.scheduler == want


def test_spec_messages_are_the_references(ref):
    """The prefix cache needs the chunked scheduler (explicit bucketed: the
    reference spec's message; "auto" resolving to bucketed: its engine's),
    speculation needs it, and the smallest bucket must be a multiple of
    the block size."""
    j_cfg = ref.build(QWEN)[0]
    s = ref.spec
    cases = [
        (dict(memory=dict(cache_layout="paged", max_len=64, block_size=8,
                          prefix_cache=True),
              scheduler=dict(policy="bucketed")), True),
        (dict(memory=dict(cache_layout="paged", max_len=64, block_size=8),
              scheduler=dict(policy="bucketed"), speculation=2), True),
        (dict(memory=dict(cache_layout="paged", max_len=64, block_size=8,
                          prefix_cache=True),
              scheduler=dict(chunk_size=12)), False),
    ]
    for kw, in_spec in cases:
        def spec_kw(arch, memory, scheduler, speculation, kw=kw):
            return dict(arch=arch, memory=memory(**kw["memory"]),
                        scheduler=scheduler(**kw["scheduler"]),
                        speculation=speculation(
                            draft_model=arch, k=kw["speculation"])
                        if "speculation" in kw else None)
        j_kw = spec_kw(j_cfg, s.MemorySpec, s.SchedulerSpec,
                       s.SpeculationSpec)
        with pytest.raises(ValueError) as j_err:
            if in_spec:
                s.RuntimeSpec(**j_kw)
            else:
                ref.engine(s.RuntimeSpec(**j_kw))
        with pytest.raises(ValueError) as t_err:
            RuntimeSpec(**spec_kw(CFG, MemorySpec, SchedulerSpec,
                                  SpeculationSpec))
        assert str(t_err.value) == str(j_err.value)
    bad = dict(cache_layout="paged", max_len=128, block_size=64)
    with pytest.raises(ValueError) as j_err:
        ref.engine(s.RuntimeSpec(arch=j_cfg, memory=s.MemorySpec(**bad),
                                 scheduler=s.SchedulerSpec(chunk_size=64)))
    with pytest.raises(ValueError) as t_err:
        ServingEngine(RuntimeSpec(arch=CFG, memory=MemorySpec(**bad),
                                  scheduler=SchedulerSpec(chunk_size=64)),
                      device="cpu")
    assert str(t_err.value) == str(j_err.value) \
        == "block_size=64 must divide the smallest prefill bucket 32"
    assert _buckets(64) == [32, 64] and _buckets(500) == [
        32, 64, 128, 256, 500] and _buckets(16) == [16]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_replay_deterministic_json_matches_reference(ref, layout):
    trace = harness.bursty_trace(10, burst_size=4, gap_steps=3, max_len=48,
                                 max_new=5, seed=13)
    je, te = _engines(ref, "bucketed", layout)
    want = ref.harness.replay(je, ref.trace.loads_trace(dumps_trace(trace)))
    got = harness.replay(te, trace)
    assert got.metrics.deterministic_json() \
        == want.metrics.deterministic_json()
    assert {got.uid_to_rid[r.uid]: r.generated for r in got.finished} \
        == {want.uid_to_rid[r.uid]: r.generated for r in want.finished}


# ---------------------------------------------------------------------------
# launch counts and the launcher
# ---------------------------------------------------------------------------
def _counting(calls: dict):
    """Count the model's calls of the matmul and norm wrappers (their plain
    versions run on the CPU) and of the paged attention entry points."""
    def wrap(mod, name):
        fn = getattr(mod, name)

        def counted(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return mock.patch.object(mod, name, counted)
    return [wrap(tm_mod, "tiled_matmul"), wrap(ln_mod, "rmsnorm"),
            wrap(attn, "paged_decode_attention"),
            wrap(attn, "chunked_prefill_attention")]


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_program_launches_count_the_wrappers(ref, name, layout):
    """One decode step, one mixed step and one prefill on the kernels'
    plain versions: the wrappers' calls equal ``program_launches``."""
    _, cfg, _, sd = ref.build(name)
    model = _port_model(sd, cfg, matmul_backend="pallas",
                        paged_attn_impl="pallas")
    B, W = 2, 8
    if layout == "paged":
        from repro_torch.core.paging import PagingConfig
        cache = model.init_cache(PagingConfig(8, 8))
        tables = torch.arange(1, 9, dtype=torch.int32).reshape(B, 4)
    else:
        cache, tables = model.init_cache(batch=B, max_len=32), None
    toks = torch.randint(0, cfg.vocab_size, (B, W), dtype=torch.int32)
    runs = {
        "mixed": lambda: model.mixed_step(
            cache, toks, torch.zeros(B, dtype=torch.int32),
            torch.full((B,), W, dtype=torch.int32), tables),
        "decode": lambda: model.decode_step(
            cache, toks[:, :1], torch.full((B,), W, dtype=torch.int32),
            tables),
        "prefill": lambda: model.prefill(toks, 16)}
    for program, run in runs.items():
        calls: dict = {}
        patches = _counting(calls)
        for p in patches:
            p.start()
        try:
            run()
        finally:
            for p in patches:
                p.stop()
        want = counts.program_launches(cfg, program, layout=layout)
        assert {n: calls.get(n, 0) for n in want if n != "int8_matmul"} \
            == {n: c for n, c in want.items() if n != "int8_matmul"}, \
            program


def test_launch_serve_dense_layout_on_cpu(capsys):
    """``--cache-layout dense``; a chunk wider than the cache makes
    ``"auto"`` fall back to the bucketed scheduler, as in the reference."""
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--requests", "3", "--max-new", "4",
          "--max-len", "32", "--cache-layout", "dense", "--chunk-size",
          "64", "--temperature", "0", "--kernels", "pallas"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    assert "bucketed scheduler, dense cache" in out
    assert "'prefill_buckets': 1" in out and "paged pool" not in out
    main(["--device", "cpu", "--requests", "3", "--max-new", "4",
          "--max-len", "32", "--arch", "phi-3-vision-4.2b"])
    out = capsys.readouterr().out
    assert "chunked scheduler, dense cache" in out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card_engines(layout, policy="bucketed"):
    cfg = reduced(get_config(QWEN))
    spec = RuntimeSpec(
        arch=cfg, execution=ExecutionSpec(matmul_backend="pallas",
                                          paged_attn_impl="pallas"),
        memory=MemorySpec(cache_layout=layout, max_batch=4, max_len=128,
                          block_size=16),
        scheduler=SchedulerSpec(policy=policy, chunk_size=16))
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    sd = Model(cfg, device="cuda").init(g).state_dict()
    out = []
    for graphs in (True, False):
        eng = ServingEngine(spec, device="cuda", graphs=graphs)
        eng.load(sd)
        out.append(eng)
    return out


def _card_drain(eng):
    prompts = [list(range(1, n + 1)) for n in (5, 40, 70, 100, 12)]
    uids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    done = {r.uid: r.generated for r in eng.run_to_completion()}
    return [done[u] for u in uids]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_one_graph_per_bucket_and_graphed_equals_eager(layout):
    """Buckets 32, 64 and 128: one capture each, replayed on a second
    drain; one capture of the decode program; the streams are the eager
    engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    graphed, eager = _card_engines(layout)
    first = _card_drain(graphed)
    assert dict(graphed.compilations) == {"decode": 1, "prefill": 3,
                                          "prefill_buckets": 3}
    assert graphed.stats["prefill_captures"] == 3
    assert _card_drain(graphed) == first == _card_drain(eager)
    assert graphed.stats["prefill_captures"] == 3
    assert graphed.stats["prefill_replays"] == 7
    assert graphed.stats["graph_captures"] == 1


@pytest.mark.cuda
def test_dense_layout_decode_runs_the_kernels_but_no_walk():
    """The dense layout's steps launch the matmul and norm kernels and no
    paged walk (the reference's dense attend is XLA); the graphed engine
    streams what the eager one does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    graphed, eager = _card_engines("dense", "chunked")
    before = counts.launch_counts()
    got = _card_drain(eager)
    after = counts.launch_counts()
    made = {n: after[n] - before[n] for n in after}
    assert made["paged_decode_attention"] == 0
    assert made["chunked_prefill_attention"] == 0
    assert made["tiled_matmul"] > 0 and made["rmsnorm"] > 0
    assert got == _card_drain(graphed)
