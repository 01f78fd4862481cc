"""Speculative decoding in the port against the JAX reference, part two:
the engine's compositions, the validation messages, the launcher and a
fleet that speculates.

The fixture ``ref`` (the reference's weights at ``reduced_cfg("qwen1.5-
0.5b")``, bridged through numpy, and the drafts), the constants and the
engine helpers are tests/test_torch_speculative.py's, imported from it
unchanged; see that module's docstring for what the two files hold:

* speculation over prefix-shared blocks, int8 weights with a quantized
  draft, the stochastic accept path's replay on fresh engines, the
  validation messages, draft loading without speculation, ``serve
  --spec-k`` alone and in a fleet;
* a fleet that speculates (the reference census's
  ``fleet-paged-spec-chunked``): streams, events, fused steps,
  ``spec_steps`` and ``spec_accepted`` equal the reference fleet engine's
  bit for bit at float32 compute over bf16 and int8 pools, on the gather
  path and the kernels' plain versions, and with the fleet's int8 weight
  table.

This module imports the JAX reference only inside the shared fixture, so
the card test also runs where JAX is absent:
``python -m pytest -q --noconftest -m cuda
tests/test_torch_speculative_fleet.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec, SpeculationSpec)
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampling import SamplingParams
from test_torch_speculative import (CFG, FLEET_MAXIMA, MEMBER,  # noqa: F401
                                    MEMBER_REQS, QUANT_REQS, REQS,
                                    _drain, _engines, _specs, _truncations,
                                    ref)
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def test_spec_composes_with_prefix_sharing(ref):
    """Speculation over prefix-shared blocks (tests/test_speculative.py's
    case): rollback truncates the slot's block tail while the trie and a
    sibling request hold the prefix chain.  Streams equal the reference's
    and the port's with speculation off; the pool drains to its parked
    chain alone."""
    shared = list(range(1, 25))                    # 3 full 8-token blocks
    waves = [[(shared + [30], 4)],
             [(shared + [40], 12), (shared + [41], 12)]]
    je, te = _engines(ref, k=3, prefix=True)
    want, got = _drain(je, waves=waves), _drain(te, waves=waves)
    assert got == want
    assert te.stats["prefix_hits"] == je.stats["prefix_hits"] >= 2
    assert te.compilations["decode"] == 1
    s = te.memory_stats()
    assert s.used_blocks == s.cached_blocks > 0
    _, off = _engines(ref, k=0, prefix=True)
    assert _drain(off, waves=waves)[0] == got[0]


def test_int8_weights_with_a_quantized_draft(ref):
    """quant="int8" (every eligible leaf, quant_min_size=1) quantizes the
    draft's weights as it loads them.  Over
    an int8 pool through the kernels' plain versions, with float32 draft
    caches in both packages, the streams, events and speculation stats
    equal the reference's speculative engine (its gather engine: its
    Pallas engine diverges over an int8 pool).  Neither engine streams
    what it does with speculation off here: the one int8 activation scale
    of a step spans every row of the verify pass, the idle slots' lanes
    among them, so the first rows' last bits move with the batch."""
    je, te = _engines(ref, k=3, kv="int8", mm="pallas", impl="pallas",
                      ref_impl="gather", quant="int8", f32_draft_cache=True)
    assert te.draft_model.layers[0].attn.wq.kernel.dtype == torch.int8
    assert te.draft_model.embed.table.dtype == torch.int8
    want, got = _drain(je, QUANT_REQS), _drain(te, QUANT_REQS)
    assert got == want
    for key in ("decode_steps", "spec_steps", "spec_accepted"):
        assert te.stats[key] == je.stats[key], key
    assert te.stats["spec_accepted"] > 0


def test_stochastic_speculation_replays(ref):
    """greedy_accept=False at temperature 0.8: the proposals, uniforms and
    corrections come from each request's generator, so two fresh engines
    give the same streams; the steps ran eagerly (a stochastic slot), on
    one program per kind."""
    runs = []
    for _ in range(2):
        _, t_spec = _specs(ref, k=2, greedy_accept=False)
        te = ServingEngine(t_spec, device="cpu",
                           sampling=SamplingParams(temperature=0.8))
        te.load(ref.sd, draft=ref.sd)
        runs.append(_drain(te, [([1, 2, 3], 12), ([7, 8], 10)])[0])
        assert te.stats["spec_steps"] > 0
        assert te.compilations["decode"] == 1
    assert runs[0] == runs[1]
    assert all(len(s) == n for s, n in zip(runs[0], (12, 10)))


@pytest.mark.parametrize("build,match", [
    (lambda: SpeculationSpec(draft_model=CFG, k=0), "must be >= 1"),
    (lambda: SpeculationSpec(draft_model=dataclasses.replace(
        CFG, family="ssm"), k=2), "cannot draft"),
    (lambda: RuntimeSpec(arch=CFG, memory=MemorySpec(
        cache_layout="paged", max_len=64, block_size=8),
        scheduler=SchedulerSpec(policy="bucketed"),
        speculation=SpeculationSpec(draft_model=CFG, k=2)),
     "chunked scheduler"),
    (lambda: RuntimeSpec(arch=CFG, memory=MemorySpec(
        cache_layout="paged", max_batch=2, max_len=64, block_size=8),
        scheduler=SchedulerSpec(policy="chunked", chunk_size=8),
        speculation=SpeculationSpec(draft_model=CFG, k=8)), "verify lanes"),
    (lambda: RuntimeSpec(arch=CFG, memory=MemorySpec(
        cache_layout="paged", max_len=64, block_size=8),
        scheduler=SchedulerSpec(chunk_size=8),
        speculation=SpeculationSpec(draft_model=dataclasses.replace(
            CFG, vocab_size=CFG.vocab_size + 1))), "tokenizer space"),
    # a fleet's draft proposes over the maxima's vocab lanes
    (lambda: RuntimeSpec(arch=MEMBER, memory=MemorySpec(
        cache_layout="paged", max_len=64, block_size=8),
        scheduler=SchedulerSpec(chunk_size=8), maxima=FLEET_MAXIMA,
        speculation=SpeculationSpec(draft_model=MEMBER)),
     "draft vocab_size=96 != target vocab 128"),
    # the dense layout is served: a dense target is refused only for the
    # reference's reasons, here a chunk wider than the cache
    (lambda: RuntimeSpec(arch=CFG, memory=MemorySpec(max_len=64),
                         scheduler=SchedulerSpec(chunk_size=128),
                         speculation=SpeculationSpec(draft_model=CFG)),
     "speculation requires a satisfiable chunked scheduler: "
     "chunk_size=128 > max_len=64"),
], ids=["k", "draft-family", "bucketed", "verify-lanes", "vocab", "fleet",
        "dense-target"])
def test_speculation_validation(build, match):
    with pytest.raises(ValueError, match=match):
        build()


def test_draft_loading_needs_speculation():
    spec = RuntimeSpec(arch=CFG, memory=MemorySpec(
        cache_layout="paged", max_len=64, block_size=8),
        scheduler=SchedulerSpec(chunk_size=8))
    eng = ServingEngine(spec, device="cpu")
    params = Model(CFG, device="cpu").init(torch.Generator()).state_dict()
    with pytest.raises(ValueError, match="requires spec.speculation"):
        eng.load(params, draft=params)
    with pytest.raises(ValueError, match="requires spec.speculation"):
        eng.load_draft(params)


def test_launch_serve_speculates_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--requests", "3", "--max-new", "6",
          "--max-len", "32", "--block-size", "8", "--chunk-size", "8",
          "--cache-layout", "paged",
          "--temperature", "0", "--spec-k", "3"])
    out = capsys.readouterr().out
    assert "3 requests, 18 tokens" in out and "speculation: k=3" in out


def test_launch_serve_speculates_in_a_fleet(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--requests", "4", "--max-new", "6",
          "--max-len", "32", "--block-size", "8", "--chunk-size", "8",
          "--cache-layout", "paged",
          "--temperature", "0", "--attn", "pallas", "--spec-k", "3",
          "--fleet", "qwen1.5-0.5b,adaptor-bert-shaped"])
    out = capsys.readouterr().out
    assert "4 requests, 24 tokens" in out and "speculation: k=3" in out
    assert "served by one fused step" in out


# ---------------------------------------------------------------------------
# (d) a fleet that speculates
# ---------------------------------------------------------------------------
def _fleet_engines(ref, *, kv="compute", impl="gather", ref_impl=None,
                   quant="none"):
    """The reference's fleet engine and the port's, k = 3, the target A's
    own weights as the draft, member B added after ``load``."""
    qkw = dict(quant=quant, quant_min_size=1) if quant != "none" else {}
    mem = dict(cache_layout="paged", max_batch=4, max_len=64, block_size=8,
               kv_dtype=kv)
    s = ref.spec
    je = ref.engine(s.RuntimeSpec(
        arch=ref.cfg, maxima=ref.maxima,
        execution=s.ExecutionSpec(paged_attn_impl=ref_impl or impl,
                                  compute_dtype="fp32", **qkw),
        memory=s.MemorySpec(**mem),
        scheduler=s.SchedulerSpec(policy="chunked", chunk_size=8),
        speculation=s.SpeculationSpec(draft_model=ref.cfg, k=3)),
        max_models=2)
    te = ServingEngine(RuntimeSpec(
        arch=CFG, maxima=FLEET_MAXIMA,
        execution=ExecutionSpec(paged_attn_impl=impl, compute_dtype="fp32",
                                **qkw),
        memory=MemorySpec(**mem),
        scheduler=SchedulerSpec(policy="chunked", chunk_size=8),
        speculation=SpeculationSpec(draft_model=CFG, k=3)), max_models=2,
        device="cpu")
    je.load(ref.params, draft=ref.params)
    te.load(ref.sd, draft=ref.sd)
    assert je.add_model(ref.member_params, ref.member_cfg) == \
        te.add_model(ref.member_sd, MEMBER) == 1
    return je, te


def _fleet_drain(eng):
    """Both members' requests, interleaved, in one drain."""
    log = []
    eng.events.subscribe(log.append)
    reqs = [(p, b, 0) for p, b in REQS] + [(p, b, 1) for p, b in MEMBER_REQS]
    uids = [eng.submit(p, max_new_tokens=b, model=m) for p, b, m in
            sorted(reqs, key=lambda r: len(r[0]))]
    done = {r.uid: r.generated for r in eng.run_to_completion()}
    return [done[u] for u in uids], [(e.kind, e.uid, e.step, e.data)
                                     for e in log]


FLEET_PATHS = {"bf16-gather": ("compute", "gather", None, "none"),
               "bf16-kernels": ("compute", "pallas", None, "none"),
               "int8-gather": ("int8", "gather", None, "none"),
               "int8-kernels": ("int8", "pallas", "gather", "none"),
               "int8-table": ("compute", "pallas", None, "int8"),
               "int8-table-int8-pool": ("int8", "gather", None, "int8")}


@pytest.mark.parametrize("path", FLEET_PATHS)
def test_fleet_speculation_matches_reference(ref, path):
    """A speculating fleet against the reference's (its census point
    fleet-paged-spec-chunked at k = 3): streams, events, fused steps and
    the speculation stats bit for bit; every token inside its member's
    vocab; the self-draft accepts on A's slots, B's slots reject what the
    draft proposes past B's vocab.  Over an int8 pool the kernels' route
    is held against the reference's gather engine (its Pallas engine
    diverges there)."""
    kv, impl, ref_impl, quant = FLEET_PATHS[path]
    je, te = _fleet_engines(ref, kv=kv, impl=impl, ref_impl=ref_impl,
                            quant=quant)
    seen = _truncations(te)
    want, got = _fleet_drain(je), _fleet_drain(te)
    assert got == want
    for key in ("decode_steps", "spec_steps", "spec_accepted",
                "prefill_tokens"):
        assert te.stats[key] == je.stats[key], key
    assert te.compilations["decode"] == te.compilations["prefill"] == 1
    assert te.stats["spec_accepted"] > 0 and seen["blocks"] >= 0
    for (p, _, m), stream in zip(sorted(
            [(p, b, 0) for p, b in REQS] + [(p, b, 1) for p, b in
                                            MEMBER_REQS],
            key=lambda r: len(r[0])), got[0]):
        vocab = (CFG, MEMBER)[m].vocab_size
        assert all(0 <= t < vocab for t in stream)
    s = te.memory_stats()
    assert s.used_blocks == 0 and te.allocator.num_free == s.total_blocks


@pytest.mark.cuda
def test_graphed_fleet_speculation_equals_eager():
    """A speculating fleet (self-draft of member A, member B added) with
    each fused program one CUDA graph, through the paged kernels with
    live_kv: the streams and the speculation stats equal an eager
    engine's, one capture per program, no eager step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = RuntimeSpec(
        arch=CFG, maxima=FLEET_MAXIMA,
        execution=ExecutionSpec(paged_attn_impl="pallas"),
        memory=MemorySpec(cache_layout="paged", max_batch=4, max_len=64,
                          block_size=8),
        scheduler=SchedulerSpec(chunk_size=8),
        speculation=SpeculationSpec(draft_model=CFG, k=3))
    gen = torch.Generator(device="cuda")
    params = Model(CFG, device="cuda").init(gen.manual_seed(0)).state_dict()
    member = Model(MEMBER, device="cuda").init(gen.manual_seed(1)) \
        .state_dict()
    runs = []
    for graphs in (True, False):
        eng = ServingEngine(spec, max_models=2, graphs=graphs)
        eng.load(params, draft=params)
        eng.add_model(member, MEMBER)
        runs.append((_fleet_drain(eng)[0], eng.stats["spec_accepted"],
                     eng.stats["decode_steps"]))
        if graphs:
            assert eng.compilations["decode"] == 1
            assert eng.compilations["prefill"] == 1
            assert eng.stats["eager_steps"] == 0
    assert runs[0] == runs[1]
