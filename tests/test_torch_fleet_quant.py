"""The fleet's int8 weight table (``DecodeFabric(quant="int8")``) against
the JAX reference's.

The fleet is the reference suite's (tests/test_kv_quant.py): member A the
reduced qwen1.5-0.5b, member B a smaller "adaptor-bert-shaped" topology on
its template (3 heads, 1 layer, d_model 48, d_ff 96, vocab 96), the
reference's weights bridged into the port, the reference's prompts and 5
new tokens each.

* ``_quant_names`` plans the same leaves on the maxima-padded sizes at
  ``quant_min_size`` 0, 1, 16384 (the FFN kernels only) and the default
  65536 (nothing at this size); ``pack_member`` gives the reference's rows
  bit for bit, int8 values and float32 scales (per layer and output column
  for kernels, per row for ``embed`` / ``lm_head``) alike.
* One mixed and one decode step of the two fabrics over the int8 table,
  on one float32 pool, within 1e-4 (float32 sums in another order).
* At bf16 compute the dequantized weights and embeddings equal the
  reference's bit for bit: values times scales rounded in the compute
  dtype (dequantizing in float32 and casting gives other numbers), the
  product then in float32.
* The fleet engine's greedy streams, lifecycle events and fused steps
  equal the reference fleet engine's bit for bit at float32 compute, over
  a bf16 and an int8 pool, on the gather path and on the kernels' plain
  versions (over an int8 pool against the reference's gather engine: its
  Pallas engine diverges from its gather path there, tests/test_kv_quant.py
  test_int8_cache_pallas_kernels_match_gather); the kernels' route equals
  the gather route.  (Streams at bf16 compute are no oracle: the two
  packages' bf16 fleets part at float weights already, on the last tokens
  of this workload.)
* The engine's table is int8 (values and scales resident), its bytes the
  reference's, below the float table's.

The reference is imported inside fixtures, so the ``cuda`` test also runs
where JAX is absent:
``python -m pytest -q --noconftest -m cuda tests/test_torch_fleet_quant.py``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.quant import DEFAULT_QUANT_MIN_SIZE, QTensor
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec, maxima_for)
from repro_torch.models.attention import KVCache
from repro_torch.models.model import Model
from repro_torch.serving import fabric as fab_mod
from repro_torch.serving.engine import ServingEngine

CFG_A = reduced(get_config("qwen1.5-0.5b"))
CFG_B = dataclasses.replace(
    CFG_A, name="adaptor-bert-shaped", num_layers=1, d_model=48,
    num_heads=3, num_kv_heads=3, d_ff=96, vocab_size=96)
MAXIMA = maxima_for(CFG_A, CFG_B, seq_max=64)
MEM = dict(cache_layout="paged", max_batch=4, max_len=64, block_size=8)
# the reference suite's near-tie-free fleet prompts (tests/test_kv_quant.py)
PROMPTS = {"a": [list(range(1, 12)), [10, 20, 30, 40], [5, 9, 14]],
           "b": [[4, 5], [6, 7, 8], [80, 70, 60, 50]]}
MAX_NEW = 5
STEP_TOL = 1e-4
# 0 and 1 plan every kernel and table, 16384 the FFN kernels alone (a mixed
# float / int8 table), the default none at this size
MIN_SIZES = [0, 1, 16384, DEFAULT_QUANT_MIN_SIZE]


@pytest.fixture(scope="module")
def ref():
    """The reference's fleet pieces, both members' weights and the same
    weights bridged into state dicts of the port."""
    import jax

    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import spec as j_spec
    from repro.core.quant import QTensor as JQTensor
    from repro.models.attention import KVCache as JKVCache
    from repro.models.model import Model as JModel
    from repro.serving import fabric as j_fabric
    from repro.serving.engine import ServingEngine as JServingEngine
    from repro.serving.sampling import SamplingParams as JSampling
    j_a = j_reduced(REGISTRY["qwen1.5-0.5b"])
    j_b = dataclasses.replace(
        j_a, name="adaptor-bert-shaped", num_layers=1, d_model=48,
        num_heads=3, num_kv_heads=3, d_ff=96, vocab_size=96)
    params = (JModel(j_a).init(jax.random.PRNGKey(0)),
              JModel(j_b).init(jax.random.PRNGKey(1)))
    bridged = tuple(from_jax_params(jax.tree.map(np.asarray, p), c, "cpu")
                    for p, c in zip(params, (CFG_A, CFG_B)))
    return types.SimpleNamespace(
        jax=jax, spec=j_spec, fabric=j_fabric, engine=JServingEngine,
        sampling=JSampling, KVCache=JKVCache, QTensor=JQTensor,
        cfgs=(j_a, j_b), params=params, bridged=bridged,
        maxima=j_spec.maxima_for(j_a, j_b, seq_max=64))


def _flat(tree, qtensor, prefix=""):
    """{dotted name: numpy array} of a table or row of either package, a
    ``QTensor`` leaf as ``<name>.values`` and ``<name>.scale``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, qtensor, f"{prefix}{k}."))
        elif isinstance(v, qtensor):
            out[f"{prefix}{k}.values"] = np.asarray(v.values)
            out[f"{prefix}{k}.scale"] = np.asarray(v.scale)
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("min_size", MIN_SIZES)
def test_table_rows_equal_reference(ref, min_size):
    """The planned leaves and both members' packed rows, bit for bit."""
    j_fab = ref.fabric.DecodeFabric(ref.maxima, 2, ref.cfgs[0],
                                    quant="int8", quant_min_size=min_size)
    t_fab = fab_mod.DecodeFabric(MAXIMA, 2, CFG_A, quant="int8",
                                 quant_min_size=min_size, device="cpu")
    assert t_fab._quant_names() == j_fab._quant_names()
    want_t = _flat(j_fab.init_table(), ref.QTensor)
    got_t = _flat(t_fab.init_table(), QTensor)
    assert {k: (v.shape, v.dtype) for k, v in got_t.items()} == \
        {k: (v.shape, v.dtype) for k, v in want_t.items()}
    for member in (0, 1):
        want = _flat(j_fab.pack_member(ref.cfgs[member], ref.params[member]),
                     ref.QTensor)
        got = _flat(t_fab.pack_member((CFG_A, CFG_B)[member],
                                      ref.bridged[member]), QTensor)
        assert set(got) == set(want)
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
    assert t_fab.table_bytes(t_fab.init_table()) == \
        j_fab.table_bytes(j_fab.init_table())


def test_int8_kernel_scales_are_per_layer_and_column():
    """A stacked kernel row ``[L, Din, Dout]`` takes scales ``[L, 1,
    Dout]``: each layer's column quantized on its own amax (127 reached in
    every live column of every layer)."""
    fab = fab_mod.DecodeFabric(MAXIMA, 2, CFG_A, quant="int8",
                               quant_min_size=1, device="cpu")
    params = Model(CFG_A, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict()
    wq = fab.pack_member(CFG_A, params)["layers"]["wq"]
    assert wq.values.dtype == torch.int8 and wq.scale.dtype == torch.float32
    L, D, HO = wq.values.shape
    assert wq.scale.shape == (L, 1, HO)
    assert bool((wq.values.abs().amax(dim=1) == 127).all())
    for i in range(L):
        w = params[f"layers.{i}.attn.wq.kernel"].float()
        np.testing.assert_allclose(wq.scale[i, 0].numpy(),
                                   (w.abs().amax(0) / 127).numpy(),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# one step of each fabric
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_fabric_steps_match_reference(ref, impl):
    """One mixed step (prefilling, decoding and idle slots, both members)
    then one decode step over the int8 table at float32 compute, on one
    float32 pool handed to both fabrics: logits within 1e-4."""
    jnp = ref.jax.numpy
    j_fab = ref.fabric.DecodeFabric(ref.maxima, 2, ref.cfgs[0],
                                    compute_dtype=jnp.float32, quant="int8",
                                    quant_min_size=1)
    t_fab = fab_mod.DecodeFabric(MAXIMA, 2, CFG_A,
                                 compute_dtype=torch.float32, quant="int8",
                                 quant_min_size=1, device="cpu")
    j_table, t_table = j_fab.init_table(), t_fab.init_table()
    for m in (0, 1):
        j_table = j_fab.insert_model(
            j_table, j_fab.pack_member(ref.cfgs[m], ref.params[m]), m)
        t_fab.insert_model(t_table, t_fab.pack_member((CFG_A, CFG_B)[m],
                                                      ref.bridged[m]), m)
    assert isinstance(t_table["layers"]["w1"], QTensor)
    rs = np.random.RandomState(5)
    B, W, bs, nblk = 4, 8, 8, 8
    L, H, hd = MAXIMA.layers_enc_max, MAXIMA.heads_max, MAXIMA.head_dim_max
    pool = [rs.randn(L, B * nblk + 1, bs, H, hd).astype(np.float32)
            for _ in range(2)]
    tables = (rs.permutation(B * nblk) + 1).reshape(B, nblk).astype(np.int32)
    topo = np.asarray([t_fab.topo_row((CFG_A, CFG_B)[b % 2], b % 2)
                       for b in range(B)], np.int32)
    vocab = topo[:, fab_mod.REG_VOCAB]
    toks = (rs.randint(0, 1 << 20, (B, W)) % vocab[:, None]).astype(np.int32)
    start = np.asarray([0, 5, 17, 30], np.int32)
    n_live = np.asarray([8, 3, 1, 0], np.int32)
    t_cache = KVCache(*(torch.from_numpy(p.copy()) for p in pool))
    j_cache = ref.KVCache(jnp.asarray(pool[0]), jnp.asarray(pool[1]), None,
                          None)
    t = torch.from_numpy
    got = t_fab.mixed_step(t_table, t_cache, t(toks), t(start), t(n_live),
                           t(topo), t(tables), paged_attn_impl=impl)
    want, j_cache = j_fab.mixed_step(
        j_table, j_cache, jnp.asarray(toks), jnp.asarray(start),
        jnp.asarray(n_live), jnp.asarray(topo), jnp.asarray(tables),
        paged_attn_impl=impl, interpret=True)
    live = np.arange(W)[None, :] < n_live[:, None]
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=STEP_TOL, rtol=STEP_TOL)
    index = start + n_live
    got = t_fab.decode_step(t_table, t_cache, t(toks[:, :1]), t(index),
                            t(topo), t(tables), paged_attn_impl=impl)
    want, _ = j_fab.decode_step(
        j_table, j_cache, jnp.asarray(toks[:, :1]), jnp.asarray(index),
        jnp.asarray(topo), jnp.asarray(tables), paged_attn_impl=impl,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=STEP_TOL, rtol=STEP_TOL)


@pytest.mark.parametrize("leaf", ["wq", "w2", "embed"])
def test_bf16_dequantization_rounds_as_the_reference(ref, leaf):
    """At bf16 compute an int8 leaf is dequantized as values times scales
    in bf16 (the reference's rounding order), bit for bit: a kernel read
    back through ``_mm`` against the identity (each output one product, so
    the f32 sum is exact), the embedding through ``_embed_rows``; rounding
    the float32 dequantization to bf16 instead gives other numbers."""
    jnp = ref.jax.numpy
    j_fab = ref.fabric.DecodeFabric(ref.maxima, 2, ref.cfgs[0], quant="int8",
                                    quant_min_size=1)
    t_fab = fab_mod.DecodeFabric(MAXIMA, 2, CFG_A, quant="int8",
                                 quant_min_size=1, device="cpu")
    j_row = j_fab.pack_member(ref.cfgs[0], ref.params[0])
    t_row = t_fab.pack_member(CFG_A, ref.bridged[0])
    if leaf == "embed":
        q = t_row["embed"]
        mid = torch.zeros(1, 1, dtype=torch.int32)
        toks = torch.arange(MAXIMA.vocab, dtype=torch.int32)[None]
        got = t_fab._embed_rows({"embed": QTensor(q.values[None],
                                                  q.scale[None])}, mid, toks)
        jq = j_row["embed"]
        want = j_fab._embed_rows(
            {"embed": ref.QTensor(jq.values[None], jq.scale[None])},
            jnp.zeros((1, 1), jnp.int32), jnp.asarray(toks.numpy()))
    else:
        q = t_row["layers"][leaf]
        w = QTensor(q.values[:1], q.scale[:1])             # layer 0
        eye = torch.eye(w.values.shape[1], dtype=torch.bfloat16)[None]
        got = t_fab._mm(eye, w)
        jq = j_row["layers"][leaf]
        want = j_fab._mm(jnp.asarray(eye.float().numpy(), jnp.bfloat16),
                         ref.QTensor(jq.values[:1], jq.scale[:1]))
        f32_first = (w.values.float() * w.scale).to(torch.bfloat16)
        assert not torch.equal(got, f32_first)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the fleet engine against the reference's
# ---------------------------------------------------------------------------
def _drain(eng, members):
    """Add both members, submit the prompts interleaved by length, drain;
    returns ({(member, prompt): stream}, events, fused steps)."""
    ids = {k: eng.add_model(p, c) for k, (c, p) in members.items()}
    log = []
    eng.events.subscribe(log.append)
    want = sorted(((k, p) for k in ids for p in PROMPTS[k]),
                  key=lambda kp: len(kp[1]))
    uids = {eng.submit(p, max_new_tokens=MAX_NEW, model=ids[k]): (k, tuple(p))
            for k, p in want}
    done = eng.run_to_completion()
    assert len(done) == len(want)
    return ({uids[r.uid]: r.generated for r in done},
            [(e.kind, e.uid, e.step, e.data) for e in log],
            eng.stats["decode_steps"])


def _ref_engine(ref, impl, kv, compute, min_size):
    s = ref.spec
    return ref.engine(s.RuntimeSpec(
        arch=ref.cfgs[0], maxima=ref.maxima,
        execution=s.ExecutionSpec(quant="int8", quant_min_size=min_size,
                                  paged_attn_impl=impl,
                                  compute_dtype=compute),
        memory=s.MemorySpec(**MEM, kv_dtype=kv),
        scheduler=s.SchedulerSpec(chunk_size=8)), max_models=2,
        sampling=ref.sampling())


def _port_engine(impl, kv, compute, min_size, device="cpu", **kw):
    return ServingEngine(RuntimeSpec(
        arch=CFG_A, maxima=MAXIMA,
        execution=ExecutionSpec(quant="int8", quant_min_size=min_size,
                                paged_attn_impl=impl, compute_dtype=compute),
        memory=MemorySpec(**MEM, kv_dtype=kv),
        scheduler=SchedulerSpec(chunk_size=8)), max_models=2, device=device,
        **kw)


STREAM_CASES = [  # (compute, pool, port impl, reference impl, min_size)
    pytest.param("fp32", "compute", "gather", "gather", 1, id="f32-bf16pool"),
    pytest.param("fp32", "compute", "pallas", "pallas", 1,
                 id="f32-bf16pool-kernels"),
    pytest.param("fp32", "int8", "gather", "gather", 1, id="f32-int8pool"),
    pytest.param("fp32", "int8", "pallas", "gather", 1,
                 id="f32-int8pool-kernels"),
    pytest.param("fp32", "compute", "gather", "gather", 0, id="min-size-0"),
    pytest.param("fp32", "compute", "pallas", "pallas", 16384,
                 id="min-size-16384-kernels"),
    pytest.param("fp32", "int8", "gather", "gather", DEFAULT_QUANT_MIN_SIZE,
                 id="min-size-default"),
]


@pytest.mark.parametrize("compute,kv,impl,ref_impl,min_size", STREAM_CASES)
def test_quantized_fleet_streams_match_reference(ref, compute, kv, impl,
                                                 ref_impl, min_size):
    """Greedy streams, events and fused steps bit for bit against the
    reference's fleet engine with the int8 table; every token in its
    member's vocab; one program per kind."""
    je = _ref_engine(ref, ref_impl, kv, compute, min_size)
    want = _drain(je, {"a": (ref.cfgs[0], ref.params[0]),
                       "b": (ref.cfgs[1], ref.params[1])})
    te = _port_engine(impl, kv, compute, min_size)
    got = _drain(te, {"a": (CFG_A, ref.bridged[0]),
                      "b": (CFG_B, ref.bridged[1])})
    assert got == want
    assert te.compilations["decode"] == te.compilations["prefill"] == 1
    for (member, _), stream in got[0].items():
        vocab = (CFG_A if member == "a" else CFG_B).vocab_size
        assert len(stream) == MAX_NEW and all(0 <= t < vocab for t in stream)


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_kernels_route_equals_gather_route(ref, kv):
    """The kernels' plain versions (paged, live_kv) and the block-table
    gather stream the same over the int8 table (the reference's
    paged-equals-dense check on the port's one layout)."""
    members = {"a": (CFG_A, ref.bridged[0]), "b": (CFG_B, ref.bridged[1])}
    gather = _drain(_port_engine("gather", kv, "fp32", 1), members)
    kernels = _drain(_port_engine("pallas", kv, "fp32", 1), members)
    assert kernels[0] == gather[0]


def test_fleet_int8_table_is_actually_quantized(ref):
    """add_model packs int8 values and scales, not quietly float: the
    engine's table leaves are ``QTensor``s resident beside an int8 pool,
    and its bytes are the reference's, about a quarter of the float
    table's for the quantized leaves."""
    eng = _port_engine("gather", "int8", "fp32", 1)
    eng.add_model(ref.bridged[0], CFG_A)
    eng.add_model(ref.bridged[1], CFG_B)
    assert isinstance(eng.table["embed"], QTensor)
    wq = eng.table["layers"]["wq"]
    assert isinstance(wq, QTensor) and wq.values.dtype == torch.int8
    assert wq.scale.shape == (2, MAXIMA.layers_enc_max, 1,
                              MAXIMA.heads_max * MAXIMA.head_dim_max)
    assert eng.cache.k.dtype == torch.int8 and eng.cache.k_scale is not None
    # every leaf is an input the fused step reads in place
    leaves = fab_mod.tree_leaves(eng.table)
    assert any(t is wq.values for t in leaves)
    assert any(t is wq.scale for t in leaves)
    j_fab = ref.fabric.DecodeFabric(ref.maxima, 2, ref.cfgs[0],
                                    quant="int8", quant_min_size=1)
    q_bytes = eng.fabric.table_bytes(eng.table)
    assert q_bytes == j_fab.table_bytes(j_fab.init_table())
    f_bytes = fab_mod.DecodeFabric(MAXIMA, 2, CFG_A, device="cpu") \
        .table_bytes(fab_mod.DecodeFabric(MAXIMA, 2, CFG_A, device="cpu")
                     .init_table())
    assert q_bytes < 0.5 * f_bytes


def test_quantized_fleet_refuses_what_the_reference_refuses(ref):
    """The matmul kernels stay refused in a fleet, pointing at the
    fabric's own int8 table; an unknown quant is refused by the fabric."""
    spec = RuntimeSpec(arch=CFG_A, maxima=MAXIMA, memory=MemorySpec(**MEM),
                       execution=ExecutionSpec(matmul_backend="pallas",
                                               quant="int8"))
    with pytest.raises(ValueError, match="ExecutionSpec\\(quant='int8'\\)"):
        ServingEngine(spec, device="cpu")
    with pytest.raises(ValueError, match="quant='int4' is not one of"):
        fab_mod.DecodeFabric(MAXIMA, 2, CFG_A, quant="int4", device="cpu")


def test_launch_serve_fleet_with_int8_table(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--requests", "4", "--max-new", "4",
          "--max-len", "32", "--block-size", "8", "--chunk-size", "8",
          "--cache-layout", "paged",
          "--attn", "pallas", "--quant", "int8", "--quant-min-size", "1",
          "--fleet", "qwen1.5-0.5b,adaptor-bert-shaped"])
    out = capsys.readouterr().out
    assert "4 requests, 16 tokens" in out and "served by one fused step" \
        in out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_quantized_fleet_graphed_equals_eager():
    """The int8-table fleet through the paged kernels with live_kv over an
    int8 pool, each fused program one CUDA graph: the streams equal an
    eager engine's, one capture per program, no eager step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    members = {k: (c, Model(c, device="cuda").init(gen.manual_seed(i))
                   .state_dict())
               for i, (k, c) in enumerate((("a", CFG_A), ("b", CFG_B)))}
    runs = []
    for graphs in (True, False):
        eng = _port_engine("pallas", "int8", "bf16", 1, device="cuda",
                           graphs=graphs)
        runs.append(_drain(eng, members)[0])
        assert isinstance(eng.table["layers"]["w1"], QTensor)
        if graphs:
            assert eng.compilations["decode"] == 1
            assert eng.compilations["prefill"] == 1
            assert eng.stats["eager_steps"] == 0
    assert runs[0] == runs[1]
