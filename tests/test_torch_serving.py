"""The port's serving engine against the JAX reference's, plus the port's
isolation and host-discipline checks.

The same prompts (those of tests/test_chunked_prefill.py) go through the
reference's ``ServingEngine`` and the port's, both paged and chunked, at
float32 compute with greedy sampling, on the same weights (bridged from
the reference's init).  The greedy streams and the lifecycle event
sequences (kind, uid, logical step, data) must be identical: with the
gather path, with the hand-written kernels selected (their plain
versions on the CPU, the reference's Pallas kernels in interpret mode),
and with a pool small enough to preempt a request mid-prefill.

This module imports the JAX reference only inside its fixture, so the
card test also runs where JAX is absent:
``python -m pytest -q --noconftest -m cuda tests/test_torch_serving.py``.
"""
import ast
import types
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec)
from repro_torch.models.model import Model
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampling import SamplingParams, filtered_probs

ROOT = Path(__file__).resolve().parents[1]
CFG = reduced(get_config("qwen1.5-0.5b"))
PROMPTS = [[1, 2, 3], list(range(1, 9)), [4], list(range(2, 40, 3)),
           [7, 7, 7, 7, 7], list(range(1, 20))]


@pytest.fixture(scope="module")
def weights():
    """The reference's init (its params) and the same weights bridged into
    a state dict of the port, plus the reference's engine surface."""
    import jax

    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import spec as j_spec
    from repro.models.model import Model as JModel
    from repro.serving.engine import ServingEngine as JServingEngine
    j_cfg = j_reduced(REGISTRY["qwen1.5-0.5b"])
    params = JModel(j_cfg).init(jax.random.PRNGKey(0))
    ref = types.SimpleNamespace(cfg=j_cfg, spec=j_spec,
                                engine=JServingEngine, params=params)
    return ref, from_jax_params(jax.tree.map(np.asarray, params), CFG, "cpu")


def _engines(weights, impl="gather", mm="xla", **mem):
    mem = {"max_batch": 4, "max_len": 64, "block_size": 8, **mem}
    chunk = mem.pop("chunk_size", 8)
    ref = weights[0]
    je = ref.engine(ref.spec.RuntimeSpec(
        arch=ref.cfg,
        execution=ref.spec.ExecutionSpec(matmul_backend=mm,
                                         paged_attn_impl=impl,
                                         compute_dtype="fp32"),
        memory=ref.spec.MemorySpec(cache_layout="paged", **mem),
        scheduler=ref.spec.SchedulerSpec(chunk_size=chunk)))
    je.load(ref.params)
    te = ServingEngine(RuntimeSpec(
        arch=CFG,
        execution=ExecutionSpec(matmul_backend=mm, paged_attn_impl=impl,
                                compute_dtype="fp32"),
        memory=MemorySpec(cache_layout="paged", **mem),
        scheduler=SchedulerSpec(chunk_size=chunk)), device="cpu")
    te.load(weights[1])
    return je, te


def _drain(eng, prompts, max_new=5):
    log = []
    eng.events.subscribe(log.append)
    uids = {eng.submit(p, max_new_tokens=max_new): i
            for i, p in enumerate(prompts)}
    done = eng.run_to_completion()
    assert len(done) == len(prompts)
    streams = {uids[r.uid]: r.generated for r in done}
    events = [(e.kind, e.uid, e.step, e.data) for e in log]
    return streams, events


@pytest.mark.parametrize("impl,mm", [("gather", "xla"), ("pallas", "pallas")])
def test_greedy_streams_and_events_match_reference(weights, impl, mm):
    je, te = _engines(weights, impl, mm)
    ref, got = _drain(je, PROMPTS), _drain(te, PROMPTS)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert {k for k, *_ in got[1]} >= {"submit", "admit", "first_token",
                                        "progress", "finish"}
    assert te.stats["decode_steps"] == je.stats["decode_steps"]
    assert te.stats["prefill_tokens"] == je.stats["prefill_tokens"]


def test_mid_prefill_preemption_matches_reference(weights):
    """A pool of exactly 4 blocks seats A (1 block) + B (3 blocks); A's
    decode growth runs the pool dry while B is still mid-prompt, so B is
    preempted before its first token and re-enters through the chunk
    scheduler (as test_mid_prefill_preemption_paged_bit_identical)."""
    prompts = [list(range(1, 8)), list(range(10, 34))]
    je, te = _engines(weights, max_batch=2, max_len=32, num_blocks=4)
    ref = _drain(je, prompts, max_new=6)
    got = _drain(te, prompts, max_new=6)
    assert te.stats["preemptions"] > 0
    assert te.stats["preemptions"] == je.stats["preemptions"]
    assert got == ref
    assert any(k == "preempt" for k, *_ in got[1])
    # and the preempted stream equals an unpressured port engine's
    _, roomy = _engines(weights, max_batch=2, max_len=32)
    assert _drain(roomy, prompts, max_new=6)[0] == got[0]


def test_host_traffic_is_one_transfer_per_sync(weights):
    _, te = _engines(weights)
    te.submit(list(range(1, 12)), max_new_tokens=6)
    te.step()                                   # admission + first chunk
    gets, uploads = te.stats["device_gets"], te.block_tables.clone()
    te.step()                                   # no finish: one transfer
    assert te.stats["device_gets"] == gets + 1
    assert torch.equal(te.block_tables, uploads)
    done = te.run_to_completion()
    assert len(done) == 1 and len(done[0].generated) == 6
    assert te.memory_stats().used_blocks == 0   # released at harvest


def test_stochastic_streams_replay_per_seed(weights):
    sp = SamplingParams(temperature=0.9, top_k=20, top_p=0.95)

    def run(seed):
        eng = ServingEngine(RuntimeSpec(
            arch=CFG, memory=MemorySpec(cache_layout="paged", max_batch=4,
                                        max_len=64, block_size=8),
            scheduler=SchedulerSpec(chunk_size=8)), device="cpu",
            sampling=sp, seed=seed)
        eng.load(weights[1])
        uids = {eng.submit(p, max_new_tokens=8): i
                for i, p in enumerate(PROMPTS[:4])}
        return {uids[r.uid]: r.generated for r in eng.run_to_completion()}

    a, b, c = run(0), run(0), run(1)
    assert a == b
    assert a != c
    assert all(0 <= t < CFG.vocab_size for s in a.values() for t in s)


def _multinomial_sample(logits, temperature, top_k, top_p, generators,
                        rows=None):
    """``sample_per_slot`` as it drew before the staged route: the index of
    the stochastic rows built from the host list on every call and one
    ``torch.multinomial`` per row."""
    toks = logits.argmax(dim=-1).to(torch.int32)
    live = [b for b, g in enumerate(generators) if g is not None]
    if not live:
        return toks
    sel = torch.tensor(live, device=logits.device)
    probs = filtered_probs(logits[sel], temperature[sel], top_k[sel],
                           top_p[sel])
    drawn = torch.cat([torch.multinomial(probs[i], 1,
                                         generator=generators[b])
                       for i, b in enumerate(live)])
    toks[sel] = drawn.to(torch.int32)
    return toks


def test_staged_uploads_keep_the_streams(weights):
    """The route without host syncs (uploads through ``HostStage``, the
    stochastic rows' index kept between steps, multinomial's own draw
    without its host-side check) streams what the route before it did:
    greedy and stochastic requests in one batch, 4 steps per sync, the
    block tables on the device equal to the host's after every step."""
    sp = SamplingParams(temperature=0.9, top_k=20, top_p=0.95)

    def run(sample):
        eng = ServingEngine(RuntimeSpec(
            arch=CFG, memory=MemorySpec(cache_layout="paged", max_batch=4,
                                        max_len=64, block_size=8),
            scheduler=SchedulerSpec(chunk_size=8)), device="cpu", seed=3)
        eng.load(weights[1])
        uids = {eng.submit(p, max_new_tokens=7,
                           sampling=sp if i % 2 else None): i
                for i, p in enumerate(PROMPTS)}
        dispatch, tables = eng._dispatch, []

        def checked():
            dispatch()
            tables.append(torch.equal(eng.block_tables, torch.tensor(
                eng._tables, dtype=torch.int32)))

        with mock.patch.object(engine_mod, "sample_per_slot", sample), \
                mock.patch.object(eng, "_dispatch", checked):
            done = eng.run_to_completion(sync_every=4)
        assert len(tables) > 8 and all(tables)
        assert len(done) == len(PROMPTS)
        assert sum(s.waits for s in eng._stages.values()) == 0
        return {uids[r.uid]: r.generated for r in done}

    staged = run(engine_mod.sample_per_slot)
    assert staged == run(_multinomial_sample)
    assert len({tuple(s) for s in staged.values()}) == len(PROMPTS)


def test_filters_match_reference_semantics():
    """top_k = 1 keeps only the argmax; top_p keeps the smallest prefix of
    the sorted distribution reaching p; disabled filters keep everything."""
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0], [0.1, 0.4, 0.3, 0.2]])
    one = torch.ones(2)
    p = filtered_probs(logits, one, torch.tensor([1, 0], dtype=torch.int32),
                       torch.tensor([1.0, 1.0]))
    assert torch.equal(p[0] > 0, torch.tensor([True, False, False, False]))
    assert bool((p[1] > 0).all())
    p = filtered_probs(logits, one, torch.zeros(2, dtype=torch.int32),
                       torch.tensor([0.5, 0.3]))
    assert int((p[0] > 0).sum()) == 1 and int((p[1] > 0).sum()) == 2


def test_engine_needs_a_device_choice():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    spec = RuntimeSpec(arch=CFG, memory=MemorySpec(cache_layout="paged"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(spec)


def test_launch_serve_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--requests", "3", "--max-new", "4",
          "--max-len", "32", "--block-size", "8", "--chunk-size", "8",
          "--cache-layout", "paged",
          "--kernels", "pallas", "--attn", "pallas"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "on cpu" in out


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_port_and_smoke_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.mark.cuda
def test_dispatch_never_waits_for_the_card():
    """ROADMAP Queue 3 fault B: with every kernel selected, a drain at
    ``sync_every=4`` runs each fused step, mixed and decode, under
    ``torch.cuda.set_sync_debug_mode("error")``, greedy and stochastic
    slots together: no host sync, and no staging buffer waited."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import chunked_prefill, paged_attention
    spec = RuntimeSpec(
        arch=CFG, execution=ExecutionSpec(matmul_backend="pallas",
                                          paged_attn_impl="pallas"),
        memory=MemorySpec(cache_layout="paged", max_batch=4, max_len=64,
                          block_size=8),
        scheduler=SchedulerSpec(chunk_size=8))
    eng = ServingEngine(spec)
    eng.load(Model.from_spec(spec, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0)).state_dict())
    sp = SamplingParams(temperature=0.9, top_k=20)
    for i, p in enumerate(PROMPTS):
        eng.submit(p, max_new_tokens=6, sampling=sp if i % 2 else None)
    dispatch = eng._dispatch

    def checked():
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    kernels = (chunked_prefill.chunked_prefill_attention,
               paged_attention.paged_decode_attention)
    before = [k.launches for k in kernels]
    with mock.patch.object(eng, "_dispatch", checked):
        done = eng.run_to_completion(sync_every=4)
    assert len(done) == len(PROMPTS)
    assert all(k.launches > n for k, n in zip(kernels, before))
    assert sum(s.waits for s in eng._stages.values()) == 0


@pytest.mark.cuda
def test_engine_serves_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import chunked_prefill, paged_attention
    from repro_torch.kernels import tiled_matmul
    spec = RuntimeSpec(
        arch=CFG, execution=ExecutionSpec(matmul_backend="pallas",
                                          paged_attn_impl="pallas"),
        memory=MemorySpec(cache_layout="paged", max_batch=4, max_len=64,
                          block_size=8),
        scheduler=SchedulerSpec(chunk_size=8))
    eng = ServingEngine(spec)
    eng.load(Model.from_spec(spec, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0)).state_dict())
    counts = [m.launches for m in (tiled_matmul.tiled_matmul,
                                   paged_attention.paged_decode_attention,
                                   chunked_prefill.chunked_prefill_attention)]
    streams, _ = _drain(eng, PROMPTS)
    assert all(len(s) == 5 for s in streams.values())
    after = [m.launches for m in (tiled_matmul.tiled_matmul,
                                  paged_attention.paged_decode_attention,
                                  chunked_prefill.chunked_prefill_attention)]
    assert all(b > a for a, b in zip(counts, after))
