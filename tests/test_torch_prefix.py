"""The port's prefix cache with copy-on-write against the JAX reference's.

* ``repro_torch.core.paging.PrefixCache`` against
  ``repro.core.paging.PrefixCache``: the reference suite's operation
  sequences (roundtrip and partial match, park and LRU evict, an existing
  node wins) on both, and random admission / release / eviction programs
  (hypothesis) whose every lookup, allocation, refcount, parked block and
  eviction must agree.
* ``kv_quant.fork_block`` bit for bit against the reference's, for the
  values and the int8 scale rows, in place.
* The engine with ``MemorySpec(prefix_cache=True)``: greedy streams,
  lifecycle events (the ``admit`` event's ``cached_tokens`` included) and
  the ``prefix_hits`` / ``prefix_hit_tokens`` / ``cow_forks`` /
  ``prefix_evictions`` counts bit for bit against the reference engine,
  on the waves of tests/test_paging.py (a full-block hit, a copy-on-write
  fork that resumes prefill mid-block, a miss) over a bf16 and an int8
  pool, through the gather path and through the paged kernels (their
  plain versions here, the reference's Pallas kernels in interpret mode).
  The int8 pool is held against the reference's gather engine, as in
  tests/test_torch_quant.py (its int8-pool Pallas engine is known-red).
  Then the reference's shared-block accounting, a mid-prefill preemption
  that re-hits the trie, a hit charged only for its uncached suffix, a
  forced preemption while holding shared blocks, eviction before
  preemption, and the fleet's per-model namespaces.
* On the card (``cuda`` marker): a graphed drain with a hit and a fork
  equals the eager drain.

The reference is imported only inside fixtures, so the card test also runs
where JAX is absent:
``python -m pytest -q --noconftest -m cuda tests/test_torch_prefix.py``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.core import kv_quant
from repro_torch.core import paging as t_paging
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec, maxima_for)
from repro_torch.models.attention import KVCache
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from test_torch_threads import one_thread  # noqa: F401 (autouse)

CFG = reduced(get_config("qwen1.5-0.5b"))
CFG_B = dataclasses.replace(
    CFG, name="adaptor-bert-shaped", num_layers=1, d_model=48, num_heads=3,
    num_kv_heads=3, d_ff=96, vocab_size=96)
SHARED = list(range(1, 25))                     # 3 full 8-token blocks
# tests/test_paging.py test_prefix_sharing_bit_identical_streams
WAVES = [[(SHARED + [30], 4)],
         [(SHARED + [40, 41], 4),               # full-block hit
          (SHARED[:20] + [99, 98], 4),          # CoW fork mid-block 3
          ([70, 71], 4)]]                       # unrelated miss
PREFIX_STATS = ("prefix_hits", "prefix_hit_tokens", "cow_forks",
                "prefix_evictions")


@pytest.fixture(scope="module")
def ref():
    """The reference's paging module, fork_block, engine surface and
    weights (qwen1.5-0.5b reduced, and the fleet's second member), with
    the same weights bridged into the port."""
    import jax

    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import kv_quant as j_kv_quant
    from repro.core import paging as j_paging
    from repro.core import spec as j_spec
    from repro.models.model import Model as JModel
    from repro.serving.engine import ServingEngine as JServingEngine
    j_a = j_reduced(REGISTRY["qwen1.5-0.5b"])
    j_b = dataclasses.replace(
        j_a, name="adaptor-bert-shaped", num_layers=1, d_model=48,
        num_heads=3, num_kv_heads=3, d_ff=96, vocab_size=96)
    params = (JModel(j_a).init(jax.random.PRNGKey(0)),
              JModel(j_b).init(jax.random.PRNGKey(1)))
    bridged = tuple(from_jax_params(jax.tree.map(np.asarray, p), c, "cpu")
                    for p, c in zip(params, (CFG, CFG_B)))
    return types.SimpleNamespace(
        jnp=jax.numpy, paging=j_paging, fork_block=j_kv_quant.fork_block,
        spec=j_spec, engine=JServingEngine, cfgs=(j_a, j_b), params=params,
        bridged=bridged)


# ---------------------------------------------------------------------------
# PrefixCache against the reference's
# ---------------------------------------------------------------------------
def _snapshot(a, pc) -> tuple:
    """Everything observable of an allocator and its trie."""
    return (tuple(a._free), tuple(a._refs), pc.num_nodes, pc.num_parked,
            pc.evictions, dataclasses.astuple(a.stats()))


def _hit(h) -> tuple:
    return (tuple(h.blocks), h.tokens, h.fork_block, h.fork_tokens,
            h.cached_tokens)


def _roundtrip(mod) -> list:
    """tests/test_paging.py test_prefix_trie_roundtrip_and_partial_match."""
    a = mod.BlockAllocator(mod.PagingConfig(block_size=4, num_blocks=16))
    pc = mod.PrefixCache(a)
    toks = list(range(10, 22))                 # 12 tokens = 3 full blocks
    blocks = a.alloc(3)
    assert pc.insert(0, toks, blocks) == 3
    full = pc.lookup(0, toks + [99], limit=12)
    assert full.blocks == blocks and full.tokens == 12
    div = toks[:6] + [77, 78, 79, 80]
    part = pc.lookup(0, div, limit=len(div) - 1)
    assert part.blocks == blocks[:1] and part.tokens == 4
    assert part.fork_block == blocks[1] and part.fork_tokens == 2
    other = pc.lookup(1, toks, limit=12)
    assert other.cached_tokens == 0
    return [_hit(full), _hit(part), _hit(other), _snapshot(a, pc)]


def _park_evict(mod) -> list:
    """tests/test_paging.py test_prefix_trie_park_evict_lru."""
    a = mod.BlockAllocator(mod.PagingConfig(block_size=4, num_blocks=16))
    pc = mod.PrefixCache(a)
    b1 = a.alloc(2)
    pc.insert(0, [1, 2, 3, 4, 5, 6, 7, 8], b1)
    b2 = a.alloc(1)
    pc.insert(0, [9, 9, 9, 9], b2)
    assert pc.park(a.decref(b1 + b2)) == []
    assert a.num_free == 13 and pc.num_parked == 3
    assert a.stats().cached_blocks == 3
    out = [_snapshot(a, pc)]
    hit = pc.lookup(0, [9, 9, 9, 9, 0], limit=4)
    pc.acquire(hit)                            # pin the younger chain
    freed = pc.evict(3)
    assert freed == 2 and a.num_free == 15     # b1's two blocks only
    assert pc.lookup(0, [1, 2, 3, 4], limit=4).cached_tokens == 0
    assert pc.lookup(0, [9, 9, 9, 9, 0], limit=4).tokens == 4
    out += [freed, _snapshot(a, pc)]
    pc.release(hit)
    return out + [_snapshot(a, pc)]


def _existing_wins(mod) -> list:
    """tests/test_paging.py test_prefix_trie_insert_existing_node_wins."""
    a = mod.BlockAllocator(mod.PagingConfig(block_size=4, num_blocks=8))
    pc = mod.PrefixCache(a)
    b1 = a.alloc(1)
    assert pc.insert(0, [5, 6, 7, 8], b1) == 1
    b2 = a.alloc(1)
    assert pc.insert(0, [5, 6, 7, 8], b2) == 0
    assert pc.lookup(0, [5, 6, 7, 8, 0], limit=4).blocks == b1
    assert not pc.owns(b2[0])
    return [b1, b2, _snapshot(a, pc)]


@pytest.mark.parametrize("scenario", [_roundtrip, _park_evict,
                                      _existing_wins])
def test_trie_sequences_match_reference(ref, scenario):
    assert scenario(t_paging) == scenario(ref.paging)


BASE = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7]


def _program(mod, ops, bs=4, num_blocks=10) -> list:
    """The engine's use of the trie as a random program: admissions look
    up (capped at len - 1), acquire, allocate (evicting parked blocks when
    the free list is short), fork-and-drop a partial source and register
    the prompt's whole blocks; releases decref and park; explicit
    evictions.  Returns every observation."""
    a = mod.BlockAllocator(mod.PagingConfig(block_size=bs,
                                            num_blocks=num_blocks))
    pc = mod.PrefixCache(a)
    held, log = [], []
    for kind, ns, plen, tail, n in ops:
        if kind == "admit":
            toks = BASE[:plen] + tail
            hit = pc.lookup(ns, toks, len(toks) - 1)
            pc.acquire(hit)
            need = mod.blocks_for_tokens(len(toks), bs) - len(hit.blocks)
            fresh = a.alloc(need)
            if fresh is None:
                log.append(("evicted", pc.evict(need - a.num_free)))
                fresh = a.alloc(need)
            if fresh is None:
                pc.release(hit)
                log.append(("waits", _hit(hit)))
            else:
                pc.drop_fork_source(hit)
                blocks = hit.blocks + fresh
                log.append(("admit", _hit(hit), tuple(fresh),
                            pc.insert(ns, toks, blocks[:len(toks) // bs])))
                held.append(blocks)
        elif kind == "release" and held:
            blocks = held.pop(n % len(held))
            a.free(pc.park(a.decref(blocks)))
        elif kind == "evict":
            log.append(("evict", pc.evict(n)))
        log.append(_snapshot(a, pc))
    return log


def test_random_trie_programs_match_reference(ref):
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    op = st.tuples(st.sampled_from(["admit", "admit", "release", "evict"]),
                   st.integers(0, 1), st.integers(0, len(BASE)),
                   st.lists(st.integers(0, 3), max_size=5),
                   st.integers(0, 4))

    @hyp.settings(max_examples=60, deadline=None, derandomize=True)
    @hyp.given(st.lists(op, min_size=1, max_size=30)
               .filter(lambda ops: all(o[2] + len(o[3]) > 0 for o in ops)))
    def check(ops):
        assert _program(t_paging, ops) == _program(ref.paging, ops)
    check()


# ---------------------------------------------------------------------------
# fork_block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_fork_block_is_bit_identical_and_in_place(ref, kv_dtype):
    r = np.random.RandomState(3)
    shape = (2, 6, 8, 2, 16)                   # [L, blocks, bs, kv, hd]
    if kv_dtype == "int8":
        vals = [r.randint(-127, 128, shape).astype(np.int8) for _ in "kv"]
        scales = [r.rand(*shape[:-1]).astype(np.float32) for _ in "kv"]
    else:
        vals = [r.randn(*shape).astype(np.float32) for _ in "kv"]
        scales = [None, None]
    t = [None if x is None else torch.from_numpy(x.copy())
         for x in vals + scales]
    if kv_dtype == "compute":
        t[:2] = [x.bfloat16() for x in t[:2]]
    cache = KVCache(*t)
    ptrs = [x.data_ptr() for x in t if x is not None]
    kv_quant.fork_block(cache, 4, 1)
    want = ref.fork_block(
        [ref.jnp.asarray(x, ref.jnp.bfloat16 if kv_dtype == "compute"
                         and i < 2 else None)
         for i, x in enumerate(vals + scales) if x is not None],
        ref.jnp.int32(4), ref.jnp.int32(1))
    got = [x for x in t if x is not None]
    assert [x.data_ptr() for x in got] == ptrs
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
        assert torch.equal(g[:, 1], g[:, 4])


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------
def _pair(ref, impl="gather", kv_dtype="compute", ref_impl=None,
          prefix=True, maxima=False, **mem):
    """A reference engine and a port engine on the same weights, float32
    compute, paged + chunked at chunk = block = 8, the prefix cache on;
    ``maxima``: a fleet of both members (model 0 and model 1)."""
    mem = {"max_batch": 4, "max_len": 64, "block_size": 8,
           "kv_dtype": kv_dtype, "prefix_cache": prefix, **mem}
    kw = dict(maxima=ref.spec.maxima_for(*ref.cfgs, seq_max=64)) \
        if maxima else {}
    je = ref.engine(ref.spec.RuntimeSpec(
        arch=ref.cfgs[0],
        execution=ref.spec.ExecutionSpec(paged_attn_impl=ref_impl or impl,
                                         compute_dtype="fp32"),
        memory=ref.spec.MemorySpec(cache_layout="paged", **mem),
        scheduler=ref.spec.SchedulerSpec(chunk_size=8), **kw),
        **({"max_models": 2} if maxima else {}))
    te = ServingEngine(RuntimeSpec(
        arch=CFG,
        execution=ExecutionSpec(paged_attn_impl=impl, compute_dtype="fp32"),
        memory=MemorySpec(cache_layout="paged", **mem),
        scheduler=SchedulerSpec(chunk_size=8),
        **(dict(maxima=maxima_for(CFG, CFG_B, seq_max=64)) if maxima
           else {})), max_models=2, device="cpu")
    if maxima:
        je.add_model(ref.params[0], ref.cfgs[0])
        je.add_model(ref.params[1], ref.cfgs[1])
        te.add_model(ref.bridged[0], CFG)
        te.add_model(ref.bridged[1], CFG_B)
    else:
        je.load(ref.params[0])
        te.load(ref.bridged[0])
    for eng in (je, te):
        eng.log = []
        eng.events.subscribe(eng.log.append)
    return je, te


def _run(eng, wave, model=0) -> list[list[int]]:
    """Submit one wave ((prompt, max_new) pairs) and drain it; the streams
    in submission order."""
    uids = [eng.submit(p, max_new_tokens=b, model=model) for p, b in wave]
    done = {r.uid: r.generated for r in eng.run_to_completion()}
    return [done[u] for u in uids]


def _same(je, te) -> None:
    """The events and the counts of both engines are equal."""
    assert [(e.kind, e.uid, e.step, e.data) for e in te.log] \
        == [(e.kind, e.uid, e.step, e.data) for e in je.log]
    for key in PREFIX_STATS + ("decode_steps", "prefill_tokens",
                               "preemptions"):
        assert te.stats[key] == je.stats[key], key
    assert dataclasses.astuple(te.memory_stats()) \
        == dataclasses.astuple(je.memory_stats())


@pytest.mark.parametrize("kv_dtype,impl,ref_impl", [
    ("compute", "gather", "gather"), ("compute", "pallas", "pallas"),
    ("int8", "gather", "gather"), ("int8", "pallas", "gather")])
def test_prefix_waves_match_reference(ref, kv_dtype, impl, ref_impl):
    """A full-block hit, a copy-on-write fork (start 20, mid-block 3) and
    a miss: streams, events and the four counts bit for bit, and the
    streams of the port's own engine with the cache off."""
    je, te = _pair(ref, impl, kv_dtype, ref_impl)
    got = [s for w in WAVES for s in _run(te, w)]
    assert got == [s for w in WAVES for s in _run(je, w)]
    _same(je, te)
    assert te.stats["prefix_hits"] == 2 and te.stats["cow_forks"] == 1
    assert te.stats["prefix_hit_tokens"] == 24 + 20
    admits = [e.data["cached_tokens"] for e in te.log if e.kind == "admit"]
    assert admits == [0, 24, 20, 0]
    assert te.memory_stats().cached_blocks == 3    # parked after the drain
    assert te.compilations["decode"] == 1
    off = ServingEngine(dataclasses.replace(
        te.spec, memory=dataclasses.replace(te.spec.memory,
                                            prefix_cache=False)),
        device="cpu")
    off.load(ref.bridged[0])
    assert [s for w in WAVES for s in _run(off, w)] == got
    assert off.stats["prefill_tokens"] \
        == te.stats["prefill_tokens"] + te.stats["prefix_hit_tokens"]


def test_shared_block_accounting_matches_reference(ref):
    """tests/test_paging.py test_prefix_sharing_shared_block_accounting:
    two concurrent holders of one 2-block chain, the pool charging the
    shared blocks once."""
    je, te = _pair(ref)
    shared = list(range(1, 17))
    for eng in (je, te):
        eng.submit(shared + [5], max_new_tokens=2)
        eng.run_to_completion()
        eng.submit(shared + [6], max_new_tokens=30)
        eng.submit(shared + [7], max_new_tokens=30)
        eng.step()
    s = te.memory_stats()
    assert dataclasses.astuple(s) == dataclasses.astuple(je.memory_stats())
    assert s.shared_blocks == 2
    assert te.allocator.ref(te._slot_blocks[0][0]) == 2
    assert s.used_blocks < sum(len(b) for b in te._slot_blocks)
    for eng in (je, te):
        eng.run_to_completion()
    assert te.memory_stats().shared_blocks == 0
    _same(je, te)


def test_mid_prefill_preemption_rehits_trie_as_reference(ref):
    """tests/test_paging.py test_prefix_mid_prefill_preemption_rehits_trie:
    B is preempted mid-prefill while it holds the shared chain; release
    decrefs (never a double free) and its re-admission hits the trie."""
    shared = list(range(1, 17))
    reqs = [(shared + list(range(40, 48)), 8),
            (shared + list(range(50, 94)), 4)]
    je, te = _pair(ref, max_batch=2, num_blocks=9)
    for eng in (je, te):
        _run(eng, [(shared + [9], 2)])         # warm: register the chain
    got = _run(te, reqs)
    assert got == _run(je, reqs)
    _same(je, te)
    assert te.stats["preemptions"] >= 1 and te.stats["prefix_hits"] >= 3
    s = te.memory_stats()
    assert s.used_blocks == s.cached_blocks    # drained: only parked blocks
    _, off = _pair(ref, max_batch=2, num_blocks=9, prefix=False)
    _run(off, [(shared + [9], 2)])
    assert _run(off, reqs) == got


def test_hit_charges_budget_only_for_uncached_suffix(ref):
    """tests/test_chunked_prefill.py
    test_prefix_hit_charges_budget_only_for_uncached_suffix: a 33-token
    prompt whose first 32 tokens are cached prefills in one step."""
    shared = list(range(1, 33))
    je, te = _pair(ref)
    for eng in (je, te):
        _run(eng, [(shared + [40], 2)])
        uid = eng.submit(shared + [41], max_new_tokens=4)
        eng.step()
        slot = next(s for s, r in enumerate(eng.slot_req)
                    if r is not None and r.uid == uid)
        assert eng._pf[slot] == 33                # 32 cached + 1 granted
        assert [r.uid for r in eng.run_to_completion()] == [uid]
    assert te.stats["prefix_hit_tokens"] >= 32
    _same(je, te)


def test_forced_preemption_while_holding_shared_blocks(ref):
    """tests/test_chunked_prefill.py
    test_prefix_forced_preemption_while_holding_shared_blocks: preempted
    mid-prefill while mapping the registered chain, the request re-hits it
    on re-admission and streams what a never-preempted engine streams."""
    shared = list(range(1, 17))
    prompt = shared + list(range(40, 64))
    je, te = _pair(ref)
    out = {}
    for eng in (je, te):
        _run(eng, [(shared + [9], 2)])
        uid = eng.submit(prompt, max_new_tokens=4)
        eng.step()                                 # resumes at 16, + 8
        slot = next(s for s, r in enumerate(eng.slot_req)
                    if r is not None and r.uid == uid)
        assert 16 < eng._pf[slot] < len(prompt)
        assert eng.allocator.ref(eng._slot_blocks[slot][0]) == 1
        hits = eng.stats["prefix_hits"]
        eng._preempt(slot)
        done = {r.uid: r.generated for r in eng.run_to_completion()}
        assert eng.stats["prefix_hits"] == hits + 1
        out[eng is te] = done[uid]
    assert out[True] == out[False]
    _same(je, te)
    _, clean = _pair(ref)
    _run(clean, [(shared + [9], 2)])
    assert _run(clean, [(prompt, 4)]) == [out[True]]


def test_eviction_before_preemption_matches_reference(ref):
    """A pool too small to keep a parked chain: admissions evict parked
    blocks (LRU, leaves first) instead of preempting, with the reference's
    counts and the cache-off engine's streams."""
    waves = [[(list(range(1, 33)) + [40], 4)],
             [(list(range(50, 90)), 4), (list(range(1, 17)) + [7], 4)]]
    je, te = _pair(ref, max_batch=2, num_blocks=8)
    got = [s for w in waves for s in _run(te, w)]
    assert got == [s for w in waves for s in _run(je, w)]
    _same(je, te)
    assert te.stats["prefix_evictions"] > 0
    assert te.stats["preemptions"] == 0
    _, off = _pair(ref, max_batch=2, num_blocks=8, prefix=False)
    assert [s for w in waves for s in _run(off, w)] == got


def test_fleet_namespaces_isolate_models(ref):
    """tests/test_chunked_prefill.py
    test_prefix_fleet_namespaces_isolate_models: the same token ids under
    two members never share blocks; each member hits its own chain."""
    je, te = _pair(ref, "pallas", maxima=True)
    shared = list(range(1, 17))
    for eng in (je, te):
        _run(eng, [(shared + [7], 2)], model=0)
        _run(eng, [(shared + [8], 2)], model=1)
        assert eng.stats["prefix_hits"] == 0       # cross-model: no sharing
        eng.submit(shared + [8], max_new_tokens=2, model=0)
        eng.submit(shared + [9], max_new_tokens=2, model=1)
        assert len(eng.run_to_completion()) == 2
        assert eng.stats["prefix_hits"] == 2
    got = [_run(te, [(shared + [5, 6], 3)], model=m) for m in (0, 1)]
    assert got == [_run(je, [(shared + [5, 6], 3)], model=m) for m in (0, 1)]
    _same(je, te)
    _, off = _pair(ref, "pallas", maxima=True, prefix=False)
    assert got == [_run(off, [(shared + [5, 6], 3)], model=m)
                   for m in (0, 1)]


# ---------------------------------------------------------------------------
# the spec and the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("maxima", [None, maxima_for(CFG, CFG_B, seq_max=64)])
def test_spec_serves_the_prefix_cache(maxima):
    spec = RuntimeSpec(arch=CFG, maxima=maxima, memory=MemorySpec(
        cache_layout="paged", max_len=64, block_size=8, prefix_cache=True),
        scheduler=SchedulerSpec(chunk_size=8))
    eng = ServingEngine(spec, max_models=2, device="cpu")
    assert eng.prefix_cache is not None


@pytest.mark.parametrize("sched", [SchedulerSpec(chunk_size=12),
                                   SchedulerSpec(policy="bucketed")])
def test_prefix_cache_requires_the_chunked_scheduler(sched):
    with pytest.raises(ValueError, match="prefix_cache=True requires the "
                                         "chunked scheduler"):
        RuntimeSpec(arch=CFG, scheduler=sched, memory=MemorySpec(
            cache_layout="paged", max_len=64, block_size=8,
            prefix_cache=True))


def test_prefix_cache_requires_the_paged_layout():
    with pytest.raises(ValueError, match="requires cache_layout='paged'"):
        MemorySpec(prefix_cache=True)


def test_launch_serve_reports_the_prefix_cache(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "3", "--max-len", "32",
                "--block-size", "8", "--chunk-size", "8", "--max-new", "4",
                "--cache-layout", "paged",
                "--prefix-cache"])
    out = capsys.readouterr().out
    assert "prefix cache: 0 hits / 0 tokens skipped, 0 CoW forks, " \
           "0 evictions" in out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_graphed_prefix_drain_equals_eager():
    """A graphed drain with a full-block hit and a fork (the fork lands
    between replays, and before the first capture of the mixed step) gives
    the eager drain's streams and counts, with one capture per program."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = Model(CFG, device="cuda").init(gen).state_dict()
    spec = RuntimeSpec(
        arch=CFG, execution=ExecutionSpec(matmul_backend="pallas",
                                          paged_attn_impl="pallas"),
        memory=MemorySpec(cache_layout="paged", max_batch=4, max_len=64,
                          block_size=8, prefix_cache=True),
        scheduler=SchedulerSpec(chunk_size=8))
    out = {}
    for graphs in (True, False):
        eng = ServingEngine(spec, graphs=graphs)
        eng.load(params)
        out[graphs] = ([s for w in WAVES for s in _run(eng, w)],
                       {k: eng.stats[k] for k in PREFIX_STATS})
        if graphs:
            assert eng.compilations["decode"] == 1
            assert eng.compilations["prefill"] == 1
            assert eng.stats["eager_steps"] == 0
    assert out[True] == out[False]
    assert out[True][1]["cow_forks"] == 1
