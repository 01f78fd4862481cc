"""Mesh serving of the port against the reference's mesh tests on the CPU.

The oracles are the reference's own (``tests/test_mesh_serving.py``,
which its suite holds green on 8 fake CPU devices): its single-device
engine streams the tokens its tp = 2 engine streams, at fp32 compute,
so the port's tensor-parallel engine (``models/tensor_parallel.py``, two
ranks on ``["cpu"] * 2``) and its data-parallel ``EngineCluster`` are
held token for token against the reference's single-device engine on
the same weights (``Model.init(PRNGKey(0))`` carried over through
``bridge.from_jax_params``) and the same trace (the reference's
``poisson_trace(10, rate=0.5, max_len=16, max_new=6, seed=3)``):

(a) tp = 2 at four points (dense layout + chunked, paged, int8 KV, the
    prefix cache), each program captured once;
(b) the dp = 2 and tp = 2 x dp = 2 clusters, whose merged events run
    submit ... admit ... first_token ... finish under cluster uids;
(c) routing by free capacity;
(d) ``capacity()`` against the reference's, and admission seats exactly
    ``max_concurrent``;
(e) ``maxima_for(..., mesh=MeshSpec(tp=2))``;
(f) each rank's pool holds half the kv heads; 3 kv heads replicate;
(g) ``resolve_spec`` / ``strategy_for_mesh`` on the reference suite's
    cases (``tests/test_distributed.py``);
(h) ``Model.axes()`` and ``AdaptiveEngine.axes()`` leaf for leaf against
    the reference's;
(i) the spec and engine refusals, with the reference's messages, and MoE
    under tp naming ROADMAP item 13b;
(j) the tuner's meshes at ``n_devices=4``;
(k) ranks on two distinct cards (``cuda``-marked; skips below two).

Beside them: a tp step against one device's within float32 rounding at
every head split (kv heads split, kv heads whole, nothing split), int8
weights and an int8 pool under tp, a self-draft speculating over tp = 2
(the reference's tokens), the vlm family at tp = 2 against one device,
``serve --tp/--dp`` on the host, and the launch helpers.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_axes, from_jax_params
from repro_torch.configs import REGISTRY, get_config, reduced
from repro_torch.core.paging import PagingConfig
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, MeshSpec,
                                   RuntimeSpec, SchedulerSpec,
                                   SpeculationSpec, maxima_for)
from repro_torch.distributed import sharding as shd
from repro_torch.harness import replay
from repro_torch.harness.trace import loads_trace
from repro_torch.models.model import Model
from repro_torch.models.tensor_parallel import TPModel
from repro_torch.serving.cluster import EngineCluster
from repro_torch.serving.engine import ServingEngine
from test_torch_threads import one_thread  # noqa: F401 (autouse)

NAME = "qwen1.5-0.5b"
CFG = reduced(get_config(NAME))
MATRIX = {
    "dense": dict(cache_layout="dense", scheduler=True),
    "paged": {},
    "int8-kv": dict(kv_dtype="int8"),
    "prefix-cache": dict(prefix_cache=True),
}


def _spec(mesh=MeshSpec(), ref=False, **mem_kw):
    """The reference suite's spec (paged, 4 slots of 64, blocks of 8,
    fp32 compute) in either package; ``scheduler=True`` pins the chunked
    scheduler on the dense layout."""
    kw = dict(cache_layout="paged", max_batch=4, max_len=64, block_size=8)
    kw.update(mem_kw)
    sched = kw.pop("scheduler", False)
    if ref:
        from repro.core import spec as js
        mesh = js.MeshSpec(tp=mesh.tp, dp=mesh.dp)
        return js.RuntimeSpec(
            arch=_ref_cfg(), execution=js.ExecutionSpec(compute_dtype="fp32"),
            memory=js.MemorySpec(**kw), mesh=mesh,
            **({"scheduler": js.SchedulerSpec(policy="chunked")}
               if sched else {}))
    return RuntimeSpec(
        arch=CFG, execution=ExecutionSpec(compute_dtype="fp32"),
        memory=MemorySpec(**kw), mesh=mesh,
        **({"scheduler": SchedulerSpec(policy="chunked")} if sched else {}))


@functools.cache
def _ref_cfg():
    from repro.configs import REGISTRY as JREG
    from repro.configs import reduced as jreduced
    return jreduced(JREG[NAME])


@pytest.fixture(scope="module")
def ref():
    """The reference's weights and trace, and its single-device engine's
    streams at each point (computed once per point)."""
    import jax

    from repro.harness import poisson_trace
    from repro.harness import replay as jreplay
    from repro.harness.trace import dumps_trace
    from repro.models.model import Model as JModel
    from repro.serving.engine import ServingEngine as JEngine

    j_params = JModel(_ref_cfg()).init(jax.random.PRNGKey(0))
    j_trace = poisson_trace(10, rate=0.5, max_len=16, max_new=6,
                            vocab=CFG.vocab_size - 1, seed=3)
    np_params = jax.tree.map(np.asarray, j_params)

    @functools.cache
    def streams(point: str) -> dict:
        eng = JEngine(_spec(ref=True, **MATRIX[point]))
        eng.load(j_params)
        r = jreplay(eng, j_trace)
        return {r.uid_to_rid[q.uid]: tuple(q.generated) for q in r.finished}

    return dict(params=from_jax_params(np_params, CFG, "cpu"),
                trace=loads_trace(dumps_trace(j_trace)), streams=streams)


def _streams(engine, trace):
    r = replay(engine, trace)
    return {r.uid_to_rid[q.uid]: tuple(q.generated) for q in r.finished}, r


def _tp_engine(params, mesh=MeshSpec(tp=2), **mem):
    eng = ServingEngine(_spec(mesh=mesh, **mem),
                        devices=["cpu"] * mesh.tp)
    eng.load(params)
    return eng


# ---------------------------------------------------------------------------
# (a) tp = 2 streams the reference's single-device tokens
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("point", sorted(MATRIX))
def test_tp2_streams_match_reference_single_device(point, ref):
    eng = _tp_engine(ref["params"], **MATRIX[point])
    got, _ = _streams(eng, ref["trace"])
    assert got == ref["streams"](point)
    comp = eng.compilations
    assert comp["prefill"] == 1 and comp["decode"] == 1
    assert isinstance(eng.model, TPModel)


def test_tp2_speculates_the_reference_streams(ref):
    """A self-draft at k = 2 over the tp = 2 engine (the draft whole on
    the first rank's device, the verify pass over the ranks): greedy
    acceptance keeps the target's stream, the reference's tokens."""
    spec = dataclasses.replace(
        _spec(mesh=MeshSpec(tp=2)),
        speculation=SpeculationSpec(draft_model=CFG, k=2))
    eng = ServingEngine(spec, devices=["cpu"] * 2)
    eng.load(ref["params"], draft=ref["params"])
    got, _ = _streams(eng, ref["trace"])
    assert got == ref["streams"]("paged")
    assert eng.stats["spec_steps"] > 0


def test_tp2_vlm_matches_one_device():
    """phi-3-vision (the vlm family) at tp = 2 against the port's one
    device engine (held against the reference in test_torch_vlm.py):
    prompts across the stub frontend's 8 patch positions, fp32."""
    vlm = reduced(get_config("phi-3-vision-4.2b"))
    params = Model(vlm, device="cpu", compute_dtype=torch.float32).init(
        torch.Generator().manual_seed(0)).state_dict()
    prompts = [[(7 * i + j) % vlm.vocab_size for j in range(n)]
               for i, n in enumerate((3, 9, 17, 30))]

    def run(mesh):
        spec = RuntimeSpec(arch=vlm,
                           execution=ExecutionSpec(compute_dtype="fp32"),
                           memory=MemorySpec(cache_layout="paged",
                                             max_batch=4, max_len=64,
                                             block_size=8), mesh=mesh)
        eng = ServingEngine(spec, devices=["cpu"] * mesh.tp)
        eng.load(params)
        uids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        done = {r.uid: r.generated for r in eng.run_to_completion()}
        return [done[u] for u in uids]

    assert run(MeshSpec(tp=2)) == run(MeshSpec())


# ---------------------------------------------------------------------------
# (b) the dp = 2 and tp = 2 x dp = 2 clusters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tp,dp", [(1, 2), (2, 2)])
def test_cluster_streams_match_and_events_merge(tp, dp, ref):
    cl = EngineCluster(_spec(mesh=MeshSpec(tp=tp, dp=dp)),
                       devices=["cpu"] * (tp * dp))
    cl.load(ref["params"])
    got, rc = _streams(cl, ref["trace"])
    assert got == ref["streams"]("paged")
    for comp in cl.compilations:
        assert comp["prefill"] == 1 and comp["decode"] == 1
    uids = {e.uid for e in rc.events}
    assert uids == set(rc.uid_to_rid)
    for uid in uids:
        kinds = [e.kind for e in rc.events if e.uid == uid]
        assert kinds[0] == "submit" and kinds[-1] == "finish"
        assert "admit" in kinds and "first_token" in kinds
        assert kinds.index("admit") < kinds.index("first_token")
    assert len(rc.metrics.per_request) == len(ref["trace"].requests)
    # both replicas served
    assert all(s["decode_steps"] for s in cl.replica_stats())


# ---------------------------------------------------------------------------
# (c) routing, (d) capacity
# ---------------------------------------------------------------------------
def test_cluster_routes_by_free_capacity(ref):
    cl = EngineCluster(_spec(mesh=MeshSpec(tp=1, dp=2)),
                       devices=["cpu"] * 2)
    cl.load(ref["params"])
    # equal capacity: the first submit ties to replica 0, the second goes
    # to replica 1 (replica 0 has queued demand)
    cl.submit([1, 2, 3], max_new_tokens=4)
    cl.submit([4, 5, 6], max_new_tokens=4)
    assert len(cl.replicas[0].queue) == 1
    assert len(cl.replicas[1].queue) == 1
    done = cl.run_to_completion()
    assert sorted(r.uid for r in done) == [1, 2]


def test_capacity_matches_reference_and_admission(ref):
    spec = _spec(mesh=MeshSpec(tp=2, dp=2), max_batch=2)
    cap = spec.capacity()
    want = _spec(mesh=MeshSpec(tp=2, dp=2), ref=True, max_batch=2).capacity()
    assert dataclasses.asdict(cap) == dataclasses.asdict(want)
    assert cap.n_devices == 4 and cap.max_concurrent == 4
    assert cap.kv_shards == 2
    assert cap.per_device_cache_bytes * cap.kv_shards \
        == cap.cache_bytes_per_replica
    cl = EngineCluster(spec, devices=["cpu"] * 4)
    cl.load(ref["params"])
    for i in range(cap.max_concurrent + 2):
        cl.submit([1 + i, 2, 3], max_new_tokens=32)
    cl.step()
    assert sum(r is not None for r in cl.slot_req) == cap.max_concurrent
    assert len(cl.queue) == 2
    # each replica's ranks hold half a pool's bytes (the planned blocks
    # and the null block beside them)
    for eng in cl.replicas:
        per_rank = [sum(t.numel() * t.element_size() for t in c
                        if t is not None) for c in eng.cache.ranks]
        pool = eng.paging
        assert per_rank == [cap.per_device_cache_bytes * pool.pool_blocks
                            // pool.num_blocks] * 2


# ---------------------------------------------------------------------------
# (e) maxima_for, (f) the pool's shards and the fallback
# ---------------------------------------------------------------------------
def test_maxima_for_is_mesh_aware():
    from repro.core import spec as js
    maxima = maxima_for(CFG, seq_max=64)
    sharded = maxima_for(CFG, seq_max=64, mesh=MeshSpec(tp=2))
    assert sharded.heads_max * 2 == maxima.heads_max
    assert sharded.d_ff_max * 2 == maxima.d_ff_max
    want = js.maxima_for(_ref_cfg(), seq_max=64, mesh=js.MeshSpec(tp=2))
    assert sharded._asdict() == want._asdict()
    spec = _spec()
    assert spec.fits_within(sharded, MeshSpec(tp=2))
    assert not spec.fits_within(sharded)
    assert spec.violations(sharded) == _spec(ref=True).violations(
        want, js.MeshSpec())


def test_tp2_pool_holds_half_the_kv_heads(ref):
    eng = _tp_engine(ref["params"])
    k = [c.k for c in eng.cache.ranks]
    assert len(k) == 2
    assert all(t.shape[-2] * 2 == CFG.num_kv_heads for t in k)
    int8 = _tp_engine(ref["params"], kv_dtype="int8")
    for c in int8.cache.ranks:     # scale rows on their kv-head axis
        assert c.k_scale.shape[-1] * 2 == CFG.num_kv_heads
        assert c.k_scale.shape == c.k.shape[:-1]


def test_indivisible_kv_heads_replicate():
    odd = dataclasses.replace(CFG, num_heads=3, num_kv_heads=3)
    assert MeshSpec(tp=2).kv_shards(odd) == 1
    mesh = shd.tp_mesh(["cpu", "cpu"])
    strategy = shd.strategy_for_mesh(mesh)
    import collections
    KV = collections.namedtuple("KV", ["k", "v"])
    cache = [KV(torch.zeros(2, 4, 8, 3, 16), torch.zeros(2, 4, 8, 3, 16))]
    sh = shd.kv_cache_shardings(mesh, cache, strategy)
    assert sh[0].k.spec == () and sh[0].v.spec == ()
    tpm = TPModel(odd, ["cpu"] * 2, compute_dtype=torch.float32)
    pools = tpm.init_cache(PagingConfig(block_size=8, num_blocks=8))
    assert all(c.k.shape[-2] == 3 for c in pools.ranks)
    assert not tpm.heads_split


# ---------------------------------------------------------------------------
# one step against one device's, at every split of the heads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("heads,kv,tp,kw", [
    (4, 4, 2, {}), (4, 4, 4, {}), (4, 2, 4, {}), (3, 3, 2, {}),
    (4, 4, 2, dict(kv_dtype="int8")),
    (4, 4, 2, dict(quant="int8", quant_min_size=1)),
])
@pytest.mark.parametrize("paged", [True, False])
def test_tp_step_matches_one_device(heads, kv, tp, kw, paged):
    """A mixed step then a decode step of the tensor-parallel model
    against ``Model``'s on the same weights, at fp32: within float32
    rounding carried through the bf16 pool (the split sums round
    differently; an int8 pool's rows requantize)."""
    cfg = dataclasses.replace(CFG, num_heads=heads, num_kv_heads=kv)
    g = torch.Generator().manual_seed(0)
    params = Model(cfg, device="cpu", compute_dtype=torch.float32).init(
        g).state_dict()
    one = Model(cfg, device="cpu", compute_dtype=torch.float32, **kw)
    one.load_state_dict(params)
    tpm = TPModel(cfg, ["cpu"] * tp, compute_dtype=torch.float32, **kw)
    tpm.load_state_dict(params)
    paging = PagingConfig(block_size=8, num_blocks=16) if paged else None
    c1 = one.init_cache(paging, batch=2, max_len=32)
    c2 = tpm.init_cache(paging, batch=2, max_len=32)
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32) \
        if paged else None
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=g,
                         dtype=torch.int32)
    start = torch.zeros(2, dtype=torch.int32)
    n_live = torch.tensor([8, 5], dtype=torch.int32)
    a = one.mixed_step(c1, toks, start, n_live, bt)
    b = tpm.mixed_step(c2, toks, start, n_live, bt)
    idx = torch.tensor([8, 5], dtype=torch.int32)
    a2 = one.decode_step(c1, toks[:, :1], idx, bt)
    b2 = tpm.decode_step(c2, toks[:, :1], idx, bt)
    for x, y in ((a, b), (a2, b2)):
        assert x.shape == y.shape
        assert (x - y).abs().max() <= 2e-2 * x.abs().max()


# ---------------------------------------------------------------------------
# (g) the sharding rules, (h) the logical axes
# ---------------------------------------------------------------------------
def _abstract(*pairs):
    from jax.sharding import AbstractMesh
    try:
        return AbstractMesh(tuple(pairs))
    except TypeError:
        names, sizes = zip(*pairs)
        return AbstractMesh(tuple(sizes), tuple(names))


@pytest.mark.parametrize("logical,shape,rules", [
    (("embed", "heads"), (1024, 4096), {"heads": "model", "embed": None}),
    ((None, "heads"), (200, 198), {"heads": "model"}),
    (("a", "b"), (64, 64), {"a": "model", "b": "model"}),
    (("embed", "ffn"), (64, 96), {"embed": ("data",), "ffn": "model"}),
    (("vocab", "embed"), (151936, 1024), {"vocab": ("data", "model")}),
])
def test_resolve_spec_as_the_reference(logical, shape, rules):
    from jax.sharding import PartitionSpec as P

    from repro.distributed import sharding as jshd
    want = jshd.resolve_spec(P(*logical), shape, rules,
                             _abstract(("data", 16), ("model", 16)))
    got = shd.resolve_spec(logical, shape, rules,
                           shd.Mesh((("data", 16), ("model", 16))))
    assert got == tuple(want)


def test_strategy_for_mesh_as_the_reference():
    from repro.distributed import sharding as jshd
    for pairs in ((("pod", 2), ("data", 16), ("model", 16)),
                  (("data", 16), ("model", 16)), (("data", 8),)):
        want = jshd.strategy_for_mesh(_abstract(*pairs))
        got = shd.strategy_for_mesh(shd.Mesh(pairs))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert shd.param_rules(got) == jshd.param_rules(want)
        assert shd.activation_rules(got) == jshd.activation_rules(want)


def test_sharding_helpers():
    mesh = shd.tp_mesh(["cpu"] * 4)
    strategy = shd.strategy_for_mesh(mesh)
    assert strategy.dp_axes == ("data",) and strategy.tp_axis == "model"
    assert shd.batch_sharding(mesh, strategy).spec == (("data",),)
    assert shd.replicated(mesh).spec == ()
    t = torch.arange(32).reshape(4, 8)
    blocks = [shd.local_shard(t, (None, "model"), mesh, r) for r in range(4)]
    assert torch.equal(torch.cat(blocks, dim=1), t)
    tree = {"w": t.float(), "b": torch.zeros(8)}
    shards = {"w": shd.NamedSharding(mesh, (None, "model")),
              "b": shd.replicated(mesh)}
    assert shd.per_device_bytes(tree, mesh, shards) == 32 * 4 // 4 + 8 * 4
    with pytest.raises(ValueError, match="at least one device"):
        shd.tp_mesh([])


# every config of the registry but the port's own fleet member
# (adaptor-bert-shaped), which the reference's registry has not
@pytest.mark.parametrize("name", sorted(set(REGISTRY)
                                        - {"adaptor-bert-shaped"}))
def test_model_axes_match_reference(name):
    from repro.configs import REGISTRY as JREG
    from repro.configs import reduced as jreduced
    from repro.models.model import Model as JModel
    cfg = reduced(get_config(name))
    want = from_jax_axes(JModel(jreduced(JREG[name])).axes(), cfg)
    # the MTP head is a trainable model's (serving drops it)
    trainable = bool(cfg.num_mtp_modules and cfg.moe is not None)
    model = Model(cfg, device="meta", trainable=trainable)
    assert model.axes() == want


def test_adaptive_axes_match_reference():
    from repro.core import spec as js
    from repro.core.adaptive import AdaptiveEngine as JAE
    from repro.core.adaptive import EngineOptions as JOpts
    from repro_torch.core.adaptive import AdaptiveEngine, EngineOptions
    from repro_torch.core.adaptive import flatten
    for decoder in (False, True):
        names = ("adaptor-bert", "shallow-transformer")
        maxima = maxima_for(*(reduced(get_config(n)) for n in names),
                            seq_max=32, layers_dec_max=2 if decoder else 0)
        jmax = js.maxima_for(*(jreduced_cfg(n) for n in names), seq_max=32,
                             layers_dec_max=2 if decoder else 0)
        got = AdaptiveEngine(maxima, EngineOptions(decoder=decoder),
                             device="meta").axes()
        want = {k: tuple(v) for k, v in flatten(
            JAE(jmax, JOpts(decoder=decoder)).axes()).items()}
        assert got == want


def jreduced_cfg(name):
    from repro.configs import REGISTRY as JREG
    from repro.configs import reduced as jreduced
    return jreduced(JREG[name])


# ---------------------------------------------------------------------------
# (i) refusals
# ---------------------------------------------------------------------------
def _ref_message(make) -> str:
    with pytest.raises(ValueError) as err:
        make()
    return str(err.value)


@pytest.mark.parametrize("case", ["tp0", "dp0", "bucketed", "fleet",
                                  "kernels", "family"])
def test_spec_refusals_match_reference(case):
    from repro.core import spec as js
    hybrid = reduced(get_config("recurrentgemma-2b"))
    dense = dict(cache_layout="dense")
    cases = {
        "tp0": (lambda m: m.MeshSpec(tp=0), lambda m: m.MeshSpec(tp=0)),
        "dp0": (lambda m: m.MeshSpec(dp=0), lambda m: m.MeshSpec(dp=0)),
        "bucketed": (
            lambda m: m.RuntimeSpec(arch=CFG, mesh=m.MeshSpec(tp=2),
                                    scheduler=m.SchedulerSpec(
                                        policy="bucketed")),
            lambda m: m.RuntimeSpec(arch=_ref_cfg(), mesh=m.MeshSpec(tp=2),
                                    scheduler=m.SchedulerSpec(
                                        policy="bucketed"))),
        "fleet": (
            lambda m: m.RuntimeSpec(
                arch=CFG, mesh=m.MeshSpec(tp=2),
                maxima=maxima_for(CFG, seq_max=64),
                memory=m.MemorySpec(max_len=64)),
            lambda m: m.RuntimeSpec(
                arch=_ref_cfg(), mesh=m.MeshSpec(tp=2),
                maxima=js.maxima_for(_ref_cfg(), seq_max=64),
                memory=m.MemorySpec(max_len=64))),
        "kernels": (
            lambda m: m.RuntimeSpec(arch=CFG, mesh=m.MeshSpec(tp=2),
                                    execution=m.ExecutionSpec(
                                        matmul_backend="pallas")),
            lambda m: m.RuntimeSpec(arch=_ref_cfg(), mesh=m.MeshSpec(tp=2),
                                    execution=m.ExecutionSpec(
                                        matmul_backend="pallas"))),
        "family": (
            lambda m: m.RuntimeSpec(arch=hybrid, mesh=m.MeshSpec(tp=2),
                                    memory=m.MemorySpec(**dense),
                                    scheduler=m.SchedulerSpec(
                                        policy="chunked")),
            lambda m: m.RuntimeSpec(
                arch=jreduced_cfg("recurrentgemma-2b"),
                mesh=m.MeshSpec(tp=2), memory=m.MemorySpec(**dense),
                scheduler=m.SchedulerSpec(policy="chunked"))),
    }
    import repro_torch.core.spec as ps
    mine, theirs = cases[case]
    assert _ref_message(lambda: mine(ps)) == _ref_message(lambda: theirs(js))


def test_engine_refusals_match_reference(ref):
    from repro.serving.engine import ServingEngine as JEngine
    with pytest.raises(ValueError, match="EngineCluster") as mine:
        ServingEngine(_spec(mesh=MeshSpec(tp=1, dp=2)), device="cpu")
    with pytest.raises(ValueError, match="EngineCluster") as theirs:
        JEngine(_spec(mesh=MeshSpec(tp=1, dp=2), ref=True))
    assert str(mine.value) == str(theirs.value)
    eng = ServingEngine(_spec(), device="cpu")
    eng.load(ref["params"])
    with pytest.raises(ValueError, match="vocab"):
        eng.submit([CFG.vocab_size], max_new_tokens=2)
    tp = _tp_engine(ref["params"])
    with pytest.raises(ValueError, match=r"outside vocab \[0, 128\)"):
        tp.submit([CFG.vocab_size], max_new_tokens=2)
    with pytest.raises(ValueError, match="needs 2 devices but only 1"):
        ServingEngine(_spec(mesh=MeshSpec(tp=2)), devices=["cpu"])
    with pytest.raises(ValueError, match="one rank per device"):
        ServingEngine(_spec(mesh=MeshSpec(tp=2)), device="cpu")
    with pytest.raises(ValueError, match="needs 4 devices"):
        EngineCluster(_spec(mesh=MeshSpec(tp=2, dp=2)),
                      devices=["cpu"] * 3)
    # the dense layout under "auto" resolves to bucketed: the engine
    # refuses it as the reference's does
    with pytest.raises(ValueError, match="resolved to 'bucketed'"):
        ServingEngine(_spec(mesh=MeshSpec(tp=2), cache_layout="dense",
                            max_len=8), devices=["cpu"] * 2)


def test_moe_under_tp_names_item_13b():
    moe = reduced(get_config("granite-moe-1b-a400m"))
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 13b"):
        RuntimeSpec(arch=moe, mesh=MeshSpec(tp=2),
                    memory=MemorySpec(cache_layout="paged"))
    # the reference accepts it; one device and dp are the port's too
    from repro.core import spec as js
    js.RuntimeSpec(arch=jreduced_cfg("granite-moe-1b-a400m"),
                   mesh=js.MeshSpec(tp=2),
                   memory=js.MemorySpec(cache_layout="paged"))
    RuntimeSpec(arch=moe, mesh=MeshSpec(dp=2),
                memory=MemorySpec(cache_layout="paged"))


def test_spec_accepts_tp_on_dense_and_vlm():
    for name in ("qwen1.5-0.5b", "phi-3-vision-4.2b", "qwen2-72b"):
        spec = RuntimeSpec(arch=reduced(get_config(name)),
                           mesh=MeshSpec(tp=2),
                           memory=MemorySpec(cache_layout="paged"))
        assert spec.mesh.n_devices == 2
    assert RuntimeSpec(arch=CFG, mesh=None).mesh == MeshSpec()


# ---------------------------------------------------------------------------
# (j) the tuner
# ---------------------------------------------------------------------------
def test_tuner_explores_meshes():
    import importlib
    jtune = importlib.import_module("repro.harness.tune")
    from repro_torch.harness.tune import DeviceProfile, WorkloadProfile, tune
    wl = dict(mean_prompt_len=16, max_prompt_len=32, burst_size=16)
    r1 = tune(CFG, DeviceProfile(cache_budget_bytes=1 << 20),
              WorkloadProfile(**wl))
    assert {(c.spec.mesh.tp, c.spec.mesh.dp) for c in r1.ranked} == {(1, 1)}
    r4 = tune(CFG, DeviceProfile(cache_budget_bytes=1 << 20, n_devices=4),
              WorkloadProfile(**wl))
    assert {(c.spec.mesh.tp, c.spec.mesh.dp) for c in r4.ranked} \
        == {(1, 4), (2, 2), (4, 1)}
    assert r4.best.score > r1.best.score
    # on the reference's device figures, the reference's ranking
    from repro.core import analytical as jan
    from repro_torch.core.analytical import GPUSpec
    v5e = jan.V5E
    gpu = GPUSpec(name=v5e.name, peak_flops=v5e.peak_flops,
                  hbm_bw=v5e.hbm_bw, link_bw=v5e.ici_bw,
                  hbm_bytes=v5e.hbm_bytes, smem_bytes=v5e.vmem_bytes,
                  mma_tile=v5e.mxu_tile)
    got = tune(CFG, DeviceProfile(gpu=gpu, cache_budget_bytes=1 << 20,
                                  n_devices=4), WorkloadProfile(**wl))
    want = jtune.tune(_ref_cfg(), jtune.DeviceProfile(
        cache_budget_bytes=1 << 20, n_devices=4), jtune.WorkloadProfile(**wl))
    assert [(c.spec.mesh.tp, c.spec.mesh.dp, c.max_batch, c.cache_bytes)
            for c in got.ranked] \
        == [(c.spec.mesh.tp, c.spec.mesh.dp, c.max_batch, c.cache_bytes)
            for c in want.ranked]


# ---------------------------------------------------------------------------
# the launcher and the CLI
# ---------------------------------------------------------------------------
def test_dev_devices_and_mesh_count():
    from repro_torch.launch import mesh as lm
    assert lm.dev_devices(2, device="cpu", allow_repeat=True) \
        == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="allow_repeat"):
        lm.dev_devices(2, device="cpu")
    assert lm.dev_devices(1, device="cpu") == [torch.device("cpu")]
    assert lm.mesh_device_count(MeshSpec(tp=2, dp=3)) == 6
    assert lm.mesh_device_count(shd.Mesh((("data", 2), ("model", 4)))) == 8


@pytest.mark.parametrize("argv", [
    ["--tp", "2"], ["--dp", "2"], ["--tp", "2", "--dp", "2",
                                   "--cache-layout", "paged"]])
def test_serve_mesh_on_the_host(argv, capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--requests", "3", "--max-len", "32",
          "--max-new", "4", "--block-size", "8", "--chunk-size", "8",
          "--temperature", "0", *argv])
    out = capsys.readouterr().out
    assert "mesh: tp=" in out and "3 requests" in out


@pytest.mark.parametrize("argv,match", [
    (["--dp", "2", "--fleet", "qwen1.5-0.5b,adaptor-bert-shaped"],
     "--dp replicates one architecture"),
    (["--dp", "2", "--spec-k", "2"], "--spec-k drives one"),
    (["--tp", "0"], "--tp and --dp must be >= 1"),
])
def test_serve_mesh_argument_errors(argv, match, capsys):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit):
        main(["--device", "cpu", *argv])
    assert match in capsys.readouterr().err


# ---------------------------------------------------------------------------
# (k) two cards
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_tp2_on_two_cards_matches_one_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    g = torch.Generator().manual_seed(0)
    params = Model(CFG, device="cpu", compute_dtype=torch.float32).init(
        g).state_dict()
    prompts = [[1 + i, 2, 3, 4 + i] for i in range(4)]

    def run(devices):
        eng = ServingEngine(_spec(mesh=MeshSpec(tp=2)), devices=devices,
                            graphs=False)
        eng.load(params)
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        return sorted((r.uid, r.generated) for r in eng.run_to_completion())

    assert run(["cuda:0", "cuda:1"]) == run(["cuda:0", "cuda:0"])
