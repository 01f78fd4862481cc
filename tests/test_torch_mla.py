"""MLA in the port (deepseek-v3-671b) against the JAX reference at its
``reduced_cfg`` with ``lossless_moe`` (capacity factor E, as the reference
suite's MLA engine tests).

Weights come from the reference's ``Model(cfg).init(PRNGKey)`` and go
through numpy and ``repro_torch.bridge`` (which carries the training-only
``mtp`` head; the serving model drops it as it loads).  Checked:

* the port's config equals the reference's field for field, full and
  reduced (MLA ranks, the MoE block with its shared expert, dense prefix
  and ``router_scale``, the MTP depth);
* the bridge's names are the port's ``Model``'s (the ``build_mla``
  leaves, ``dense_prefix.0.attn.*`` included), ``k_up`` kept float32;
* ``mla_decode_paged``, ``mla_mixed_paged`` and ``mla_mixed`` (the dense
  latent cache of a draft) against the reference's functions, one layer,
  at float32 over a float32 pool: outputs within 1e-5 x max|out| and the
  written latents;
* one mixed step then one decode step, and ``forward``, at float32 over
  a float32 pool within 1e-4 x max|logits|, with the plain products and
  with the kernels' plain versions (``"pallas"``: ``tiled_matmul`` and the
  ``rmsnorm`` of ``q_norm`` / ``kv_norm``);
* an int8 latent pool against the port's own float32 pool within the
  codec's tolerance (the reference's int8-MLA tests are known red);
* greedy engine streams, lifecycle events and step counts bit for bit
  against the reference engine at float32 compute over a bf16 pool: the
  plain route and the kernels' route, the prefix cache (on = off, and a
  copy-on-write fork copies the latent leaves), a self-draft at k = 2;
* int8 weights at the default size rule leaf for leaf and stream for
  stream; at ``quant_min_size=1`` the reference raises ``AttributeError``
  (``_mla_attend`` reshapes a ``QTensor``) while the port refuses with a
  ``ValueError`` in ``Model`` and in ``RuntimeSpec``;
* ``RuntimeSpec`` refuses MLA in a fleet, naming ROADMAP item 11m;
  ``--arch deepseek-v3-671b`` serves through the launcher.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.kv_quant import fork_block
from repro_torch.core.paging import PagingConfig
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec, SpeculationSpec, maxima_for)
from repro_torch.models import attention as attn
from repro_torch.models.attention import MLACache
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from test_torch_threads import one_thread  # noqa: F401 (autouse)

NAME = "deepseek-v3-671b"
FULL = get_config(NAME)
STEP_TOL = 1e-4                      # x max|logits|, f32 compute and pool
FN_TOL = 1e-5                        # x max|out|, one layer
BS, NBLK, NUM_BLOCKS = 8, 4, 12
TABLES = np.array([[3, 1, 7, 0], [2, 9, 4, 11], [5, 0, 0, 0]], np.int32)
N_LIVE = np.array([8, 8, 5], np.int32)
PROMPTS = [[1, 2, 3], list(range(1, 12)), list(range(2, 30, 3))]
SHARED = list(range(1, 25))
WAVES = [[(SHARED + [30], 4)],
         [(SHARED + [40, 41], 4), (SHARED[:20] + [99, 98], 4),
          ([70, 71], 4)]]
STREAMS = [[(p, 6) for p in PROMPTS]]


def _lossless(c):
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=float(c.moe.num_experts)))


CFG = _lossless(reduced(FULL))


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import serve_quant as j_serve_quant
    from repro.core import spec as j_spec
    from repro.core.paging import PagingConfig as JPagingConfig
    from repro.models import attention as j_attn
    from repro.models.model import Model as JModel
    from repro.models.model import ModelOptions
    from repro.serving.engine import ServingEngine as JServingEngine

    @functools.cache
    def build():
        j_cfg = _lossless(j_reduced(REGISTRY[NAME]))
        params = JModel(j_cfg).init(jax.random.PRNGKey(3))
        sd = from_jax_params(jax.tree.map(np.asarray, params), CFG, "cpu")
        return j_cfg, params, sd

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, registry=REGISTRY, reduced=j_reduced,
        attn=j_attn, model=JModel, options=ModelOptions, spec=j_spec,
        paging=JPagingConfig, engine=JServingEngine,
        serve_quant=j_serve_quant, build=build)


def _close(want, got, rel):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    assert np.isfinite(got).all()
    err, scale = np.abs(want - got).max(), np.abs(want).max()
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


def _port_model(sd, **kw):
    tm = Model(CFG, compute_dtype=torch.float32, device="cpu", **kw)
    tm.load_state_dict(sd)
    return tm


# ---------------------------------------------------------------------------
# config and bridge
# ---------------------------------------------------------------------------
def test_port_config_matches_reference(ref):
    for port, j in ((FULL, ref.registry[NAME]),
                    (reduced(FULL), ref.reduced(ref.registry[NAME]))):
        mine = dataclasses.asdict(port)
        assert mine == {k: v for k, v in dataclasses.asdict(j).items()
                        if k in mine}
        assert port.mla.qk_head_dim == j.mla.qk_head_dim
    assert FULL.source == "arXiv:2412.19437"
    assert (FULL.mla.q_lora_rank, FULL.mla.kv_lora_rank,
            FULL.mla.qk_head_dim) == (1536, 512, 192)
    small = reduced(FULL)
    assert (small.mla.kv_lora_rank, small.mla.qk_head_dim,
            small.num_mtp_modules, small.moe.first_k_dense) == (16, 24, 1, 1)


def test_mla_config_needs_no_head_dim_divisor():
    """The reference's rule: with ``mla`` the head count need not divide
    d_model."""
    dataclasses.replace(CFG, d_model=66, head_dim=0)
    with pytest.raises(ValueError, match="is not divisible"):
        dataclasses.replace(CFG, d_model=66, head_dim=0, mla=None)


def test_bridge_names_are_the_models(ref):
    _, params, sd = ref.build()
    tm = Model(CFG, compute_dtype=torch.float32, device="cpu")
    assert set(tm.state_dict()) == {n for n in sd if not n.startswith("mtp.")}
    assert any(n.startswith("mtp.") for n in sd)
    assert "mtp" in params
    for leaf in ("q_down.kernel", "q_norm.scale", "q_up.kernel",
                 "kv_down.kernel", "kv_norm.scale", "k_up.kernel",
                 "v_up.kernel", "wo.kernel"):
        a, b = leaf.split(".")
        np.testing.assert_array_equal(
            sd[f"layers.0.attn.{leaf}"].numpy(),
            np.asarray(params["layers"]["attn"][a][b][0]))
        np.testing.assert_array_equal(
            sd[f"dense_prefix.0.attn.{leaf}"].numpy(),
            np.asarray(params["dense_prefix"][0]["attn"][a][b]))
    tm16 = Model(CFG, device="cpu")
    tm16.load_state_dict(sd)
    assert tm16.layers[0].attn.k_up.kernel.dtype == torch.float32
    assert tm16.layers[0].attn.v_up.kernel.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the attention functions, one layer
# ---------------------------------------------------------------------------
def _layer(ref):
    """The reference's and the port's first main-stack attention layer."""
    _, params, sd = ref.build()
    jp = ref.jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    return jp, _port_model(sd).layers[0].attn


def _pools(rs, j_cfg):
    m = j_cfg.mla
    c = rs.randn(NUM_BLOCKS + 1, BS, m.kv_lora_rank).astype(np.float32)
    r = rs.randn(NUM_BLOCKS + 1, BS, m.qk_rope_head_dim).astype(np.float32)
    return c, r


@pytest.mark.parametrize("mm", ["xla", "pallas"])
def test_mla_decode_paged_matches_reference(ref, mm):
    j_cfg, _, _ = ref.build()
    jp, tp = _layer(ref)
    rs = np.random.RandomState(1)
    x = rs.randn(3, 1, 64).astype(np.float32)
    c, r = _pools(rs, j_cfg)
    idx = np.array([9, 30, 4], np.int32)
    jnp = ref.jnp
    want, jc = ref.attn.mla_decode_paged(
        jnp.asarray(x), jp, j_cfg, ref.attn.MLACache(jnp.asarray(c),
                                                     jnp.asarray(r)),
        jnp.asarray(idx), jnp.asarray(TABLES))
    cache = MLACache(torch.from_numpy(c.copy()), torch.from_numpy(r.copy()))
    got = attn.mla_decode_paged(torch.from_numpy(x), tp, CFG, cache,
                                torch.from_numpy(idx),
                                torch.from_numpy(TABLES), mm=mm)
    _close(want, got.numpy(), FN_TOL)
    _close(jc.c_kv, cache.c_kv.numpy(), FN_TOL)
    _close(jc.k_rope, cache.k_rope.numpy(), FN_TOL)


@pytest.mark.parametrize("mm", ["xla", "pallas"])
def test_mla_mixed_paged_matches_reference(ref, mm):
    j_cfg, _, _ = ref.build()
    jp, tp = _layer(ref)
    rs = np.random.RandomState(2)
    x = rs.randn(3, 8, 64).astype(np.float32)
    c, r = _pools(rs, j_cfg)
    start = np.array([0, 16, 3], np.int32)
    jnp = ref.jnp
    want, jc = ref.attn.mla_mixed_paged(
        jnp.asarray(x), jp, j_cfg, ref.attn.MLACache(jnp.asarray(c),
                                                     jnp.asarray(r)),
        jnp.asarray(start), jnp.asarray(N_LIVE), jnp.asarray(TABLES))
    cache = MLACache(torch.from_numpy(c.copy()), torch.from_numpy(r.copy()))
    got = attn.mla_mixed_paged(torch.from_numpy(x), tp, CFG, cache,
                               torch.from_numpy(start),
                               torch.from_numpy(N_LIVE),
                               torch.from_numpy(TABLES), mm=mm)
    live = np.arange(8)[None, :] < N_LIVE[:, None]
    _close(np.asarray(want)[live], got.numpy()[live], FN_TOL)
    # dead lanes went to the null block: the other rows are the reference's
    _close(np.asarray(jc.c_kv)[1:], cache.c_kv.numpy()[1:], FN_TOL)
    _close(np.asarray(jc.k_rope)[1:], cache.k_rope.numpy()[1:], FN_TOL)


def test_mla_mixed_dense_matches_reference(ref):
    """The draft's dense latent cache: the reference's [B, S, ...] against
    the port's [B, S + 1, ...] (its spare row S takes the dead lanes and
    the positions past the end)."""
    j_cfg, _, _ = ref.build()
    jp, tp = _layer(ref)
    rs = np.random.RandomState(3)
    S = 24
    x = rs.randn(3, 8, 64).astype(np.float32)
    m = j_cfg.mla
    c = rs.randn(3, S, m.kv_lora_rank).astype(np.float32)
    r = rs.randn(3, S, m.qk_rope_head_dim).astype(np.float32)
    start = np.array([0, 12, 20], np.int32)
    n_live = np.array([8, 1, 8], np.int32)
    jnp = ref.jnp
    want, jc = ref.attn.mla_mixed(
        jnp.asarray(x), jp, j_cfg, ref.attn.MLACache(jnp.asarray(c),
                                                     jnp.asarray(r)),
        jnp.asarray(start), jnp.asarray(n_live))
    pad = ((0, 0), (0, 1), (0, 0))
    cache = MLACache(torch.from_numpy(np.pad(c, pad)),
                     torch.from_numpy(np.pad(r, pad)))
    got = attn.mla_mixed(torch.from_numpy(x), tp, CFG, cache,
                         torch.from_numpy(start), torch.from_numpy(n_live),
                         mm="xla")
    pos = start[:, None] + np.arange(8)[None, :]
    live = (np.arange(8)[None, :] < n_live[:, None]) & (pos < S)
    _close(np.asarray(want)[live], got.numpy()[live], FN_TOL)
    _close(jc.c_kv, cache.c_kv[:, :S].numpy(), FN_TOL)
    _close(jc.k_rope, cache.k_rope[:, :S].numpy(), FN_TOL)


# ---------------------------------------------------------------------------
# the model's steps
# ---------------------------------------------------------------------------
def _step_inputs():
    rs = np.random.RandomState(0)
    toks = rs.randint(0, CFG.vocab_size, (3, 8)).astype(np.int32)
    dtoks = rs.randint(0, CFG.vocab_size, (3, 1)).astype(np.int32)
    return toks, dtoks, np.zeros(3, np.int32)


def _port_steps(tm, cache):
    toks, dtoks, start = _step_inputs()
    tl = tm.mixed_step(cache, torch.from_numpy(toks), torch.from_numpy(start),
                       torch.from_numpy(N_LIVE), torch.from_numpy(TABLES))
    td = tm.decode_step(cache, torch.from_numpy(dtoks),
                        torch.from_numpy(N_LIVE), torch.from_numpy(TABLES))
    return tl.numpy(), td.numpy()


@pytest.mark.parametrize("mm", ["xla", "pallas"])
def test_steps_and_forward_match_reference(ref, mm):
    """mixed_step (8 lanes, partial slots) then decode_step, float32
    compute over a float32 latent pool; the latent pool's layers (the
    dense prefix's first) are the reference's; and the full-sequence
    forward (the naive expansion)."""
    j_cfg, params, sd = ref.build()
    jnp = ref.jnp
    jm = ref.model(j_cfg, ref.options(compute_dtype=jnp.float32,
                                      matmul_backend=mm))
    tm = _port_model(sd, matmul_backend=mm)
    toks, dtoks, start = _step_inputs()
    jc = jm.init_cache(3, NBLK * BS, paging=ref.paging(BS, NUM_BLOCKS))
    jc = ref.jax.tree.map(lambda a: a.astype(jnp.float32), jc)
    tc = tm.init_cache(PagingConfig(BS, NUM_BLOCKS))
    assert tc.c_kv.shape == (CFG.num_layers, NUM_BLOCKS + 1, BS, 16)
    assert tc.k_rope.shape == (CFG.num_layers, NUM_BLOCKS + 1, BS, 8)
    tc = MLACache(tc.c_kv.float(), tc.k_rope.float())
    jl, jc = jm.mixed_step(params, jc, jnp.asarray(toks), jnp.asarray(start),
                           jnp.asarray(N_LIVE),
                           block_tables=jnp.asarray(TABLES))
    jd, _ = jm.decode_step(params, jc, jnp.asarray(dtoks),
                           jnp.asarray(N_LIVE),
                           block_tables=jnp.asarray(TABLES))
    tl, td = _port_steps(tm, tc)
    live = np.arange(8)[None, :] < N_LIVE[:, None]
    _close(np.asarray(jl)[live], tl[live], STEP_TOL)
    _close(jd, td, STEP_TOL)
    want = jm.forward(params, {"tokens": jnp.asarray(toks)})
    _close(want, tm.forward(torch.from_numpy(toks)).numpy(), STEP_TOL)


def test_int8_latent_pool_tracks_the_float_pool(ref):
    """The int8 codec over the latents (one float32 scale per cached
    position and tensor) against the port's own float32 pool: the
    reference's int8-MLA tests are known red, so the oracle is the codec's
    tolerance, the reference's int8-KV bound of 5e-2 x max|logits|."""
    _, _, sd = ref.build()
    out = {}
    for kv in ("compute", "int8"):
        tm = _port_model(sd, kv_dtype=kv)
        tc = tm.init_cache(PagingConfig(BS, NUM_BLOCKS))
        if kv == "compute":
            tc = MLACache(tc.c_kv.float(), tc.k_rope.float())
        else:
            assert tc.c_kv.dtype == torch.int8
            assert tc.c_scale.shape == (CFG.num_layers, NUM_BLOCKS + 1, BS)
        out[kv] = _port_steps(tm, tc)
    live = np.arange(8)[None, :] < N_LIVE[:, None]
    _close(out["compute"][0][live], out["int8"][0][live], 5e-2)
    _close(out["compute"][1], out["int8"][1], 5e-2)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
# (kv dtype, matmul backend): MLA attends through the gather view on both
PATHS = {"plain": ("compute", "xla"), "kernels": ("compute", "pallas")}


def _engines(ref, path="plain", quant="none", min_size=None, prefix=False,
             spec_k=0):
    kv, mm = PATHS[path]
    j_cfg, params, sd = ref.build()
    mem = dict(cache_layout="paged", max_batch=3, max_len=32, block_size=8,
               kv_dtype=kv, prefix_cache=prefix)
    qkw = dict(quant=quant) if quant != "none" else {}
    if min_size is not None:
        qkw["quant_min_size"] = min_size
    je = ref.engine(ref.spec.RuntimeSpec(
        arch=j_cfg,
        execution=ref.spec.ExecutionSpec(matmul_backend=mm,
                                         compute_dtype="fp32", **qkw),
        memory=ref.spec.MemorySpec(**mem),
        scheduler=ref.spec.SchedulerSpec(chunk_size=8),
        speculation=ref.spec.SpeculationSpec(draft_model=j_cfg, k=spec_k)
        if spec_k else None))
    te = ServingEngine(RuntimeSpec(
        arch=CFG,
        execution=ExecutionSpec(matmul_backend=mm, compute_dtype="fp32",
                                **qkw),
        memory=MemorySpec(**mem),
        scheduler=SchedulerSpec(chunk_size=8),
        speculation=SpeculationSpec(draft_model=CFG, k=spec_k)
        if spec_k else None), device="cpu")
    if spec_k:
        je.load(params, draft=params)
        te.load(sd, draft=sd)
    else:
        je.load(params)
        te.load(sd)
    return je, te


def _drain(eng, waves):
    log = []
    eng.events.subscribe(log.append)
    streams = []
    for wave in waves:
        uids = [eng.submit(p, max_new_tokens=n) for p, n in wave]
        done = {r.uid: r.generated for r in eng.run_to_completion()}
        streams += [done[u] for u in uids]
    return streams, [(e.kind, e.uid, e.step, e.data) for e in log]


def _same(je, te, waves, keys=("decode_steps", "prefill_tokens")):
    want, got = _drain(je, waves), _drain(te, waves)
    assert all(len(s) == n for s, (_, n) in
               zip(got[0], [r for w in waves for r in w]))
    assert got == want
    for key in keys:
        assert te.stats[key] == je.stats[key], key
    assert te.compilations["decode"] == te.compilations["prefill"] == 1
    return got


@pytest.mark.parametrize("path", list(PATHS))
def test_greedy_streams_match_reference(ref, path):
    _same(*_engines(ref, path=path), STREAMS)


@pytest.mark.parametrize("path", list(PATHS))
def test_prefix_cache_streams_match_reference(ref, path):
    """A full-block hit, a copy-on-write fork mid-block and a miss over
    the latent pool: streams, events and the four prefix stats equal the
    reference's, and the streams equal the cache-off drain's."""
    je, te = _engines(ref, path=path, prefix=True)
    got = _same(je, te, WAVES, keys=("decode_steps", "prefill_tokens",
                                     "prefix_hits", "prefix_hit_tokens",
                                     "cow_forks", "prefix_evictions"))
    assert te.stats["prefix_hits"] >= 2 and te.stats["cow_forks"] >= 1
    _, off = _engines(ref, path=path)
    assert _drain(off, WAVES)[0] == got[0]


def test_fork_block_copies_the_latent_leaves():
    """Every leaf of an int8 latent pool (values and scales) moves bit for
    bit, and no other block changes."""
    tm = Model(CFG, kv_dtype="int8", device="cpu")
    cache = tm.init_cache(PagingConfig(BS, NUM_BLOCKS))
    g = torch.Generator().manual_seed(0)
    for t in cache:
        t.copy_(torch.randint(-100, 100, t.shape, generator=g)
                .to(t.dtype))
    before = [t.clone() for t in cache]
    fork_block(cache, 3, 7)
    for t, b in zip(cache, before, strict=True):
        assert torch.equal(t[:, 7], b[:, 3])
        keep = [i for i in range(t.shape[1]) if i != 7]
        assert torch.equal(t[:, keep], b[:, keep])


@pytest.mark.parametrize("path", list(PATHS))
def test_self_draft_streams_match_reference(ref, path):
    """k = 2: the draft's dense latent cache (``mla_mixed``) proposes, the
    target verifies 3 lanes over the latent pool; streams, events and the
    speculation stats equal the reference's, and the streams equal
    speculation off."""
    je, te = _engines(ref, path=path, spec_k=2)
    assert isinstance(te.draft_cache, MLACache)
    assert te.draft_cache.c_kv.shape == (CFG.num_layers, 3, 33, 16)
    got = _same(je, te, STREAMS, keys=("decode_steps", "spec_steps",
                                       "spec_accepted"))
    assert te.stats["spec_accepted"] > 0
    _, off = _engines(ref, path=path)
    assert _drain(off, STREAMS)[0] == got[0]


@pytest.mark.parametrize("floor", [None, 1025])
def test_int8_weights_below_k_up_are_the_references(ref, floor):
    """At the default floor (65536 elements) the reduced model quantizes
    nothing; at 1025 every kernel and the table but k_up and v_up ([16,
    64], 1024 elements in each stack).  Every leaf equals
    ``quantize_params``', and the streams equal the reference's."""
    _, params, sd = ref.build()
    kw = {} if floor is None else dict(quant_min_size=floor)
    tm = Model(CFG, compute_dtype=torch.float32, quant="int8", device="cpu",
               **kw)
    tm.load_state_dict(sd)
    q = ref.serve_quant.quantize_params(params, *([] if floor is None
                                                  else [floor]))
    # the serving model drops the training-only mtp head the bridge carries
    want = {n: t for n, t in from_jax_params(
        ref.jax.tree.map(np.asarray, q), CFG, "cpu").items()
        if not n.startswith("mtp.")}
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype, name
        assert torch.equal(got[name], t), name
    quantized = {n for n, t in got.items() if t.dtype == torch.int8}
    if floor is None:
        assert not quantized
    else:
        assert {"embed.table", "layers.0.attn.q_up.kernel",
                "dense_prefix.0.attn.kv_down.kernel",
                "layers.0.attn.wo.kernel"} <= quantized
        assert not any("k_up" in n or "v_up" in n for n in quantized)
    _same(*_engines(ref, quant="int8", min_size=floor), STREAMS)


def test_int8_weights_that_quantize_k_up_are_refused(ref):
    """At quant_min_size=1 the reference quantizes k_up / v_up and its
    absorbed attend raises AttributeError; the port refuses the
    configuration up front with a ValueError (at 1024 too: each stack of
    k_up holds 1024 elements)."""
    j_cfg, params, sd = ref.build()
    jm = ref.model(j_cfg, ref.options(compute_dtype=ref.jnp.float32))
    q = ref.serve_quant.quantize_params(params, 1)
    jc = jm.init_cache(3, NBLK * BS, paging=ref.paging(BS, NUM_BLOCKS))
    toks, _, start = _step_inputs()
    jnp = ref.jnp
    with pytest.raises(AttributeError):
        jm.mixed_step(q, jc, jnp.asarray(toks), jnp.asarray(start),
                      jnp.asarray(N_LIVE), block_tables=jnp.asarray(TABLES))
    msg = "the reference cannot serve this configuration"
    for floor in (1, 1024):
        with pytest.raises(ValueError, match=msg):
            Model(CFG, quant="int8", quant_min_size=floor, device="cpu")
    mem = MemorySpec(cache_layout="paged", max_len=32, block_size=8)
    with pytest.raises(ValueError, match=msg + r".*attention.py:595"):
        RuntimeSpec(arch=CFG, memory=mem,
                    execution=ExecutionSpec(quant="int8", quant_min_size=1))
    # a float target with a quantized MLA draft, and the full width at
    # the default rule (k_up is 512 x 16384)
    dense = reduced(get_config("qwen1.5-0.5b"), vocab_size=CFG.vocab_size)
    with pytest.raises(ValueError, match=msg):
        RuntimeSpec(arch=dense, memory=mem,
                    scheduler=SchedulerSpec(chunk_size=8),
                    execution=ExecutionSpec(quant="int8", quant_min_size=1),
                    speculation=SpeculationSpec(draft_model=CFG, k=2))
    with pytest.raises(ValueError, match="layers.<i>.attn.k_up.kernel"):
        RuntimeSpec(arch=FULL, memory=mem,
                    execution=ExecutionSpec(quant="int8"))


# ---------------------------------------------------------------------------
# the spec and the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_spec_serves_mla_and_refuses_it_in_a_fleet(kv):
    mem = MemorySpec(cache_layout="paged", max_len=64, block_size=8,
                     kv_dtype=kv, prefix_cache=True)
    for cfg in (CFG, FULL):
        RuntimeSpec(arch=cfg, memory=mem)
        RuntimeSpec(arch=cfg, memory=mem,
                    scheduler=SchedulerSpec(chunk_size=8),
                    speculation=SpeculationSpec(draft_model=cfg, k=3))
        with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 11m"):
            RuntimeSpec(arch=cfg, memory=MemorySpec(**{
                **dataclasses.asdict(mem), "prefix_cache": False}),
                maxima=maxima_for(cfg, seq_max=64))
    RuntimeSpec(arch=CFG, memory=mem, execution=ExecutionSpec(quant="int8"))


def test_launch_serve_serves_deepseek_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", NAME, "--requests", "3", "--max-new",
          "5", "--max-len", "32", "--block-size", "8", "--chunk-size", "8",
          "--cache-layout", "paged",
          "--temperature", "0", "--kernels", "pallas", "--kv-dtype", "int8",
          "--prefix-cache", "--spec-k", "2"])
    out = capsys.readouterr().out
    assert f"{NAME} on cpu: 3 requests, 15 tokens" in out
    assert "speculation: k=2" in out


@pytest.mark.cuda
def test_graphed_mla_engine_equals_eager():
    """Reduced deepseek-v3 on the kernels over a bf16 latent pool: a
    graphed drain (one capture per program, no eager step) streams what
    an eager one does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    spec = RuntimeSpec(
        arch=CFG, execution=ExecutionSpec(matmul_backend="pallas"),
        memory=MemorySpec(cache_layout="paged", max_batch=3, max_len=32,
                          block_size=8),
        scheduler=SchedulerSpec(chunk_size=8))
    g = torch.Generator(device="cuda").manual_seed(0)
    sd = Model(CFG, device="cuda").init(g).state_dict()
    runs = []
    for graphs in (True, False):
        eng = ServingEngine(spec, device="cuda", graphs=graphs)
        eng.load(sd)
        runs.append((_drain(eng, STREAMS)[0], dict(eng.compilations),
                     eng.stats["eager_steps"]))
    (g_streams, comp, eager), (e_streams, _, _) = runs
    assert g_streams == e_streams
    assert comp["decode"] == comp["prefill"] == 1 and eager == 0

