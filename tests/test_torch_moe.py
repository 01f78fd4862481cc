"""The MoE family in the port (granite-moe-1b-a400m) against the JAX
reference at its ``reduced_cfg``.

Weights come from the reference's ``Model(cfg).init(PRNGKey)`` and go
through numpy and ``repro_torch.bridge``.  Three configs: granite as
reduced (4 experts top-2, capacity factor 1.25: tokens drop), the same
lossless (the reference suite's ``no_drop``: capacity factor E), and
granite with a shared expert, ``router_scale`` 2.5 and a dense prefix of
one layer (``first_k_dense`` 1, ``dense_d_ff`` 128), the reference built
on the same overrides.  Checked:

* the port's config equals the reference's field for field, full and
  reduced; the bridge's names (``layers.<i>.moe.{router,w1,wg,w2}``,
  ``moe.shared.*.kernel``, ``dense_prefix.<j>.*``) and values;
* ``capacity`` at W = 1, 4, 8 and 16;
* ``route``: expert ids exactly, weights within 1e-6 (float32 softmax in
  another order of sums), a row of tied probabilities included;
* ``apply_moe`` with drops (the test counts them from the reference's
  routing), lossless, and with the shared expert and ``router_scale``:
  float32 within 1e-5 x max|out| (summation order only), bf16 within
  2e-2 x max|out| (the reference's bf16 tolerance);
* one mixed step then one decode step at float32 compute over a float32
  pool within 1e-4 x max|logits|, through the gather path and through the
  kernels (their plain versions here, the reference's Pallas kernels in
  interpret mode);
* greedy engine streams and lifecycle events bit for bit against the
  reference engine at float32 compute: over bf16 and int8 pools (an int8
  pool held against the reference's gather engine, whose Pallas engine is
  known-red there), with int8 weights (the expert and router leaves left
  float, every leaf equal to ``repro.core.serve_quant.quantize_params``'s),
  with the prefix cache, and with a self-draft at k = 2 (``spec_steps``,
  ``spec_accepted``);
* ``RuntimeSpec`` takes granite as target and as draft, and refuses it
  with ``maxima=`` with the reference fabric's message; ``--arch
  granite-moe-1b-a400m`` serves through the launcher, float and fully
  quantized with a self-draft.
* On the card (``cuda`` marker): graphed drains equal eager ones, float
  and fully quantized, one capture per program.

The reference is imported only inside fixtures, so the card test also runs
where JAX is absent:
``python -m pytest -q --noconftest -m cuda tests/test_torch_moe.py``.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.paging import PagingConfig
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec, SpeculationSpec, maxima_for)
from repro_torch.models import moe
from repro_torch.models.attention import KVCache
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from test_torch_threads import one_thread  # noqa: F401 (autouse)

NAME = "granite-moe-1b-a400m"
FULL = get_config(NAME)
CFG = reduced(FULL)
STEP_TOL = 1e-4                      # x max|logits|, f32 compute and pool
BS, NBLK, NUM_BLOCKS = 8, 4, 12
TABLES = np.array([[3, 1, 7, 0], [2, 9, 4, 11], [5, 0, 0, 0]], np.int32)
N_LIVE = np.array([8, 8, 5], np.int32)
PROMPTS = [[1, 2, 3], list(range(1, 12)), list(range(2, 30, 3))]
# tests/test_paging.py's prefix waves: a full-block hit, a copy-on-write
# fork mid-block, a miss
SHARED = list(range(1, 25))
WAVES = [[(SHARED + [30], 4)],
         [(SHARED + [40, 41], 4), (SHARED[:20] + [99, 98], 4),
          ([70, 71], 4)]]


def _extras(c):
    """A shared expert, router_scale 2.5 and a dense prefix of one layer
    (either package's config)."""
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, num_shared_experts=1, shared_expert_d_ff=32,
        router_scale=2.5, first_k_dense=1, dense_d_ff=128))


def _lossless(c):
    """The reference suite's ``no_drop``: capacity factor E."""
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=float(c.moe.num_experts)))


VARIANTS = {"granite": lambda c: c, "lossless": _lossless,
            "extras": _extras}


@pytest.fixture(scope="module")
def ref():
    """The reference's MoE module, engine surface and quantizer, and a
    builder of (reference config, port config, reference params, bridged
    state dict) for each variant."""
    import jax
    import jax.numpy as jnp

    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import serve_quant as j_serve_quant
    from repro.core import spec as j_spec
    from repro.core.paging import PagingConfig as JPagingConfig
    from repro.models import moe as j_moe
    from repro.models.model import Model as JModel
    from repro.models.model import ModelOptions
    from repro.serving.engine import ServingEngine as JServingEngine

    @functools.cache
    def build(variant: str, num_layers: int | None = None):
        over = {} if num_layers is None else dict(num_layers=num_layers)
        j_cfg = VARIANTS[variant](j_reduced(REGISTRY[NAME], **over))
        cfg = VARIANTS[variant](reduced(FULL, **over))
        params = JModel(j_cfg).init(jax.random.PRNGKey(3))
        sd = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
        return j_cfg, cfg, params, sd

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, registry=REGISTRY, reduced=j_reduced,
        moe=j_moe, model=JModel, options=ModelOptions, spec=j_spec,
        paging=JPagingConfig, engine=JServingEngine,
        serve_quant=j_serve_quant, build=build)


def _close(want, got, rel):
    assert np.isfinite(got).all()
    err, scale = np.abs(want - got).max(), np.abs(want).max()
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


# ---------------------------------------------------------------------------
# config, bridge, capacity, routing
# ---------------------------------------------------------------------------
def test_port_config_matches_reference(ref):
    for port, j in ((FULL, ref.registry[NAME]),
                    (CFG, ref.reduced(ref.registry[NAME]))):
        assert port.family == "moe"
        mine = dataclasses.asdict(port)
        assert mine == {k: v for k, v in dataclasses.asdict(j).items()
                        if k in mine}
    assert FULL.moe.capacity_factor == 1.25
    assert (FULL.moe.num_experts, FULL.moe.experts_per_token,
            FULL.moe.expert_d_ff) == (32, 8, 512)
    assert (CFG.moe.num_experts, CFG.moe.experts_per_token,
            CFG.moe.expert_d_ff) == (4, 2, 32)


@pytest.mark.parametrize("variant", ["granite", "extras"])
def test_bridge_names_are_the_references(ref, variant):
    """The port's state dict names are the bridged reference leaves, the
    stacked ``layers`` unstacked over L - first_k_dense, the prefix list
    entry by entry; every value is the reference's."""
    _, cfg, params, sd = ref.build(variant)
    tm = Model(cfg, compute_dtype=torch.float32, device="cpu")
    assert set(tm.state_dict()) == set(sd)
    k = cfg.moe.first_k_dense
    p = params["layers"]["moe"]
    for i in range(cfg.num_layers - k):
        for leaf in ("router", "w1", "wg", "w2"):
            np.testing.assert_array_equal(
                sd[f"layers.{i}.moe.{leaf}"].numpy(), np.asarray(p[leaf][i]))
    if variant == "extras":
        np.testing.assert_array_equal(
            sd["layers.0.moe.shared.wg.kernel"].numpy(),
            np.asarray(p["shared"]["wg"]["kernel"][0]))
        np.testing.assert_array_equal(
            sd["dense_prefix.0.ffn.w2.kernel"].numpy(),
            np.asarray(params["dense_prefix"][0]["ffn"]["w2"]["kernel"]))
        assert sd["dense_prefix.0.ffn.w1.kernel"].shape == (64, 128)
        assert len(tm.layers) == cfg.num_layers - 1
    else:
        assert not any(n.startswith("dense_prefix.") for n in sd)
    tm.load_state_dict(sd)
    assert tm.layers[0].moe.router.dtype == torch.float32


def test_bridge_refuses_a_stack_of_the_wrong_depth(ref):
    j_cfg, cfg, params, _ = ref.build("extras")
    with pytest.raises(ValueError, match="leading axis 1 != the 2 stacked layers"):
        from_jax_params(ref.jax.tree.map(np.asarray, params),
                        dataclasses.replace(cfg, moe=dataclasses.replace(
                            cfg.moe, first_k_dense=0)), "cpu")


@pytest.mark.parametrize("W", [1, 4, 8, 16])
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_capacity_matches_reference(ref, which, W):
    port = FULL if which == "full" else CFG
    j = ref.registry[NAME] if which == "full" \
        else ref.reduced(ref.registry[NAME])
    assert moe.capacity(W, port.moe) == ref.moe.capacity(W, j.moe)
    if which == "full":
        # a decode step takes one slot per expert, a verify pass at k = 3
        # four, a chunk of 16 five of its 128 routed slots
        assert moe.capacity(W, port.moe) == {1: 1, 4: 4, 8: 4, 16: 5}[W]


@pytest.mark.parametrize("which", ["full", "reduced"])
@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_route_matches_reference(ref, which, scale):
    """Ids exactly (a zero row ties every expert: the lowest ids win, as
    ``jax.lax.top_k`` picks them), weights within 1e-6."""
    m = dataclasses.replace((FULL if which == "full" else CFG).moe,
                            router_scale=scale)
    j_full = ref.registry[NAME]
    j_cfg = j_full if which == "full" else ref.reduced(j_full)
    j_m = dataclasses.replace(j_cfg.moe, router_scale=scale)
    rs = np.random.RandomState(7)
    d = 64
    x = rs.randn(3, 5, d).astype(np.float32)
    x[1, 2] = 0.0                                    # tied probabilities
    w = (rs.randn(d, m.num_experts) / np.sqrt(d)).astype(np.float32)
    jw, ji = ref.moe.route(ref.jnp.asarray(x), ref.jnp.asarray(w), j_m)
    tw, ti = moe.route(torch.from_numpy(x), torch.from_numpy(w), m)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti[1, 2].numpy(),
                                  np.arange(m.experts_per_token))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------
def _drops(ji: np.ndarray, m, cap: int) -> int:
    """Routed slots past capacity, per the reference's expert ids [B, S,
    k] (each sequence's slots claim capacity in order)."""
    n = 0
    for seq in ji.reshape(ji.shape[0], -1):
        n += sum(max(0, int((seq == e).sum()) - cap)
                 for e in range(m.num_experts))
    return n


@pytest.mark.parametrize("mm", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("variant", ["granite", "lossless", "extras"])
def test_apply_moe_matches_reference(ref, variant, dtype, mm):
    """A chunk of 16 tokens per sequence that lean toward the same
    experts: at capacity factor 1.25 slots drop (counted), lossless none.
    ``mm`` routes the shared expert's projections (the kernel's plain
    version under "pallas")."""
    j_cfg, cfg, params, sd = ref.build(variant)
    jdt = ref.jnp.float32 if dtype == "fp32" else ref.jnp.bfloat16
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    rs = np.random.RandomState(11)
    base = rs.randn(1, 1, 64).astype(np.float32)
    x = (base + 0.5 * rs.randn(3, 16, 64)).astype(np.float32)
    jp = ref.jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    jx = ref.jnp.asarray(x).astype(jdt)
    want = np.asarray(ref.moe.apply_moe(jx, jp, j_cfg)).astype(np.float32)
    cap = moe.capacity(16, cfg.moe)
    _, ji = ref.moe.route(jx, jp["router"], j_cfg.moe)
    drops = _drops(np.asarray(ji), cfg.moe, cap)
    if variant == "lossless":
        assert drops == 0
    else:
        assert drops > 0
    tm = Model(cfg, compute_dtype=tdt, device="cpu")
    tm.load_state_dict(sd)
    got = moe.apply_moe(torch.from_numpy(x).to(tdt), tm.layers[0].moe, cfg,
                        mm).float().numpy()
    _close(want, got, 1e-5 if dtype == "fp32" else 2e-2)


# ---------------------------------------------------------------------------
# the model's steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mm,impl", [("xla", "gather"), ("pallas", "pallas")])
@pytest.mark.parametrize("variant", ["granite", "extras"])
def test_steps_match_reference(ref, variant, mm, impl):
    """mixed_step (a chunk of 8 lanes with partial slots: capacity 5 of
    16 routed slots, so tokens drop) then decode_step (capacity 1), float32
    compute over a float32 pool, both packages on the same weights."""
    j_cfg, cfg, params, sd = ref.build(variant)
    jnp = ref.jnp
    jm = ref.model(j_cfg, ref.options(compute_dtype=jnp.float32,
                                      matmul_backend=mm,
                                      paged_attn_impl=impl))
    tm = Model(cfg, compute_dtype=torch.float32, matmul_backend=mm,
               paged_attn_impl=impl, device="cpu")
    tm.load_state_dict(sd)
    rs = np.random.RandomState(0)
    W = 8
    toks = rs.randint(0, cfg.vocab_size, (3, W)).astype(np.int32)
    start = np.zeros(3, np.int32)
    jc = jm.init_cache(3, NBLK * BS, paging=ref.paging(BS, NUM_BLOCKS))
    jc = ref.jax.tree.map(lambda a: a.astype(jnp.float32), jc)
    tc = tm.init_cache(PagingConfig(BS, NUM_BLOCKS))
    tc = KVCache(tc.k.float(), tc.v.float())
    assert tc.k.shape[0] == cfg.num_layers
    jl, jc = jm.mixed_step(params, jc, jnp.asarray(toks), jnp.asarray(start),
                           jnp.asarray(N_LIVE),
                           block_tables=jnp.asarray(TABLES))
    tl = tm.mixed_step(tc, torch.from_numpy(toks), torch.from_numpy(start),
                       torch.from_numpy(N_LIVE), torch.from_numpy(TABLES))
    live = np.arange(W)[None, :] < N_LIVE[:, None]
    # the pool's layers are the reference's, the prefix's first
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=0,
                               atol=1e-5 * float(np.abs(jc.k).max()))
    dtoks = rs.randint(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    jd, _ = jm.decode_step(params, jc, jnp.asarray(dtoks),
                           jnp.asarray(N_LIVE),
                           block_tables=jnp.asarray(TABLES))
    td = tm.decode_step(tc, torch.from_numpy(dtoks), torch.from_numpy(N_LIVE),
                        torch.from_numpy(TABLES))
    _close(np.asarray(jl)[live], tl.numpy()[live], STEP_TOL)
    _close(np.asarray(jd), td.numpy(), STEP_TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
# (kv dtype, matmul backend, attention impl, the reference's attention
# impl): an int8 pool's kernels against the reference's gather engine
PATHS = {"bf16-gather": ("compute", "xla", "gather", "gather"),
         "bf16-kernels": ("compute", "pallas", "pallas", "pallas"),
         "int8-gather": ("int8", "xla", "gather", "gather"),
         "int8-kernels": ("int8", "pallas", "pallas", "gather")}


def _engines(ref, variant="granite", path="bf16-gather", quant="none",
             min_size=1, prefix=False, spec_k=0):
    kv, mm, impl, ref_impl = PATHS[path]
    j_cfg, cfg, params, sd = ref.build(variant)
    mem = dict(cache_layout="paged", max_batch=3, max_len=32, block_size=8,
               kv_dtype=kv, prefix_cache=prefix)
    qkw = dict(quant=quant, quant_min_size=min_size) \
        if quant != "none" else {}
    je = ref.engine(ref.spec.RuntimeSpec(
        arch=j_cfg,
        execution=ref.spec.ExecutionSpec(matmul_backend=mm,
                                         paged_attn_impl=ref_impl,
                                         compute_dtype="fp32", **qkw),
        memory=ref.spec.MemorySpec(**mem),
        scheduler=ref.spec.SchedulerSpec(chunk_size=8),
        speculation=ref.spec.SpeculationSpec(draft_model=j_cfg, k=spec_k)
        if spec_k else None))
    te = ServingEngine(RuntimeSpec(
        arch=cfg,
        execution=ExecutionSpec(matmul_backend=mm, paged_attn_impl=impl,
                                compute_dtype="fp32", **qkw),
        memory=MemorySpec(**mem),
        scheduler=SchedulerSpec(chunk_size=8),
        speculation=SpeculationSpec(draft_model=cfg, k=spec_k)
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


STREAMS = [[(p, 6) for p in PROMPTS]]


@pytest.mark.parametrize("path", list(PATHS))
def test_greedy_streams_match_reference(ref, path):
    _same(*_engines(ref, path=path), STREAMS)


@pytest.mark.parametrize("path", ["bf16-gather", "bf16-kernels"])
def test_extras_streams_match_reference(ref, path):
    """A shared expert, router_scale 2.5 and a dense prefix layer: the
    prefix writes cache layer 0, the MoE layer cache layer 1."""
    _same(*_engines(ref, variant="extras", path=path), STREAMS)


def test_int8_weights_are_the_references(ref):
    """Every leaf of a model serving int8 weights equals the bridged
    ``quantize_params`` tree: attention projections, the table and the
    shared expert's kernels int8 with the reference's scales, the router
    and experts float.  With 3 layers, a dense prefix and a floor of 8000
    elements the 2-layer stack's [64, 64] projections (8192 stacked) are
    quantized and the prefix's (4096, unstacked) are not, nor the shared
    expert's [64, 32] kernels (4096 stacked); the prefix's [64, 128] FFN
    kernels (8192) are."""
    for variant, layers, floor in (("granite", None, 1), ("extras", None, 1),
                                   ("extras", 3, 8000)):
        _, cfg, params, sd = ref.build(variant, layers)
        tm = Model(cfg, compute_dtype=torch.float32, quant="int8",
                   quant_min_size=floor, device="cpu")
        tm.load_state_dict(sd)
        q = ref.serve_quant.quantize_params(params, floor)
        want = from_jax_params(ref.jax.tree.map(np.asarray, q), cfg, "cpu")
        got = tm.state_dict()
        assert set(got) == set(want)
        for name, t in want.items():
            assert got[name].dtype == t.dtype, name
            assert torch.equal(got[name], t), name
        assert got["layers.0.attn.wq.kernel"].dtype == torch.int8
        for leaf in ("router", "w1", "wg", "w2"):
            assert got[f"layers.0.moe.{leaf}"].dtype == torch.float32
        if variant == "extras":
            shared = got["layers.0.moe.shared.w1.kernel"].dtype
            prefix = got["dense_prefix.0.attn.wq.kernel"].dtype
            assert got["dense_prefix.0.ffn.w1.kernel"].dtype == torch.int8
            assert (shared, prefix) == ((torch.int8,) * 2 if floor == 1
                                        else (torch.float32,) * 2)


@pytest.mark.parametrize("path", ["int8-gather", "int8-kernels"])
def test_int8_weight_streams_match_reference(ref, path):
    """int8 weights (floor 1) over an int8 pool."""
    _same(*_engines(ref, path=path, quant="int8"), STREAMS)


@pytest.mark.parametrize("path", ["bf16-gather", "bf16-kernels"])
def test_prefix_cache_streams_match_reference(ref, path):
    je, te = _engines(ref, path=path, prefix=True)
    _same(je, te, WAVES, keys=("decode_steps", "prefill_tokens",
                               "prefix_hits", "prefix_hit_tokens",
                               "cow_forks", "prefix_evictions"))
    assert te.stats["prefix_hits"] >= 2 and te.stats["cow_forks"] >= 1


@pytest.mark.parametrize("path", ["bf16-gather", "bf16-kernels"])
def test_self_draft_streams_match_reference(ref, path):
    """k = 2: the verify pass routes W = 3 lanes (capacity 3), the draft's
    proposals one lane each; streams, events and the speculation stats
    equal the reference's, in fewer fused steps than speculation off."""
    je, te = _engines(ref, path=path, spec_k=2)
    got = _same(je, te, STREAMS, keys=("decode_steps", "spec_steps",
                                       "spec_accepted"))
    assert te.stats["spec_accepted"] > 0
    _, off = _engines(ref, path=path)
    assert _drain(off, STREAMS)[0] == got[0]
    assert te.stats["decode_steps"] < off.stats["decode_steps"]


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [CFG, FULL], ids=["reduced", "full"])
def test_spec_serves_and_drafts_granite(cfg):
    mem = MemorySpec(cache_layout="paged", max_len=64, block_size=8)
    RuntimeSpec(arch=cfg, memory=mem)
    RuntimeSpec(arch=cfg, memory=mem, scheduler=SchedulerSpec(chunk_size=8),
                speculation=SpeculationSpec(draft_model=cfg, k=3))
    with pytest.raises(ValueError, match=f"{cfg.name}: multi-topology "
                       "serving covers the dense GQA family; family 'moe' "
                       "needs its own engine"):
        RuntimeSpec(arch=cfg, memory=mem, maxima=maxima_for(cfg, seq_max=64))


@pytest.mark.parametrize("extra", [[], ["--quant", "int8", "--quant-min-size",
                                          "1", "--kv-dtype", "int8",
                                          "--spec-k", "3"]],
                         ids=["float", "int8-spec"])
def test_launch_serve_serves_granite_on_cpu(capsys, extra):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", NAME, "--requests", "3", "--max-new",
          "6", "--max-len", "32", "--block-size", "8", "--chunk-size", "8",
          "--cache-layout", "paged",
          "--temperature", "0", "--kernels", "pallas", "--attn", "pallas",
          *extra])
    out = capsys.readouterr().out
    assert f"{NAME} on cpu: 3 requests, 18 tokens" in out
    assert ("speculation: k=3" in out) == bool(extra)


def test_model_refuses_an_moe_family_without_its_block():
    with pytest.raises(ValueError, match="Queue 1 items 11-12"):
        Model(dataclasses.replace(CFG, moe=None), device="cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_graphed_moe_engine_equals_eager(quant):
    """Reduced granite on the kernels, float weights over a bf16 pool or
    fully quantized: a graphed drain (one capture per program, no eager
    step) streams what an eager one does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    spec = RuntimeSpec(
        arch=CFG,
        execution=ExecutionSpec(matmul_backend="pallas",
                                paged_attn_impl="pallas",
                                quant="int8" if quant else "none",
                                quant_min_size=1),
        memory=MemorySpec(cache_layout="paged", max_batch=3, max_len=32,
                          block_size=8, kv_dtype="int8" if quant
                          else "compute"),
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
