"""The port's load harness (``repro_torch.harness``) against the reference's
``repro.harness`` on the CPU.

* Traces: each generator, with the same arguments and seed, gives a
  byte-identical ``dumps_trace`` in both packages, and each package's
  ``loads_trace`` reads the other's bytes back into an equal trace.
* Metrics: the reference suite's hand-computed event streams
  (``tests/test_harness.py``) reduce to equal ``deterministic_json()``
  bytes and equal wall views through both ``reduce_events``, and the port
  gives the hand-computed values.
* Replay parity: the same trace replayed on the port's engine and on the
  reference's, at float32 compute over a float32 pool with the reference's
  weights through ``from_jax_params``, gives identical
  ``deterministic_json()`` bytes and equal per-rid streams.  Modes on
  reduced qwen1.5-0.5b: paged + chunked on a bursty and a Poisson trace,
  the prefix cache on a shared-prefix trace, a pool small enough to
  preempt, a two-member fleet on a fleet trace, a self-draft at k = 3;
  then reduced granite-moe-1b-a400m and reduced deepseek-v3-671b (MLA).
* Every port replay's lifecycle is exactly once per request (one submit,
  first_token and finish; admits - preempts = 1; the step clock never
  runs backwards), and a second replay on the warm engine repeats the
  first (arrivals count from the replay's start).
* ``python -m repro_torch.launch.serve --device cpu --trace`` replays a
  trace the reference saved.
"""
import dataclasses
import functools
import json
import types

import numpy as np
import pytest
import torch

from repro_torch import harness
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.spec import (ExecutionSpec, MemorySpec, RuntimeSpec,
                                   SchedulerSpec, SpeculationSpec, maxima_for)
from repro_torch.harness.metrics import percentile
from repro_torch.harness.trace import dumps_trace, loads_trace
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.events import EngineEvent, EventLog

GENERATORS = {
    "poisson": ("poisson_trace", (12,), dict(rate=0.5, max_len=32,
                                             max_new=4)),
    "bursty": ("bursty_trace", (12,), dict(burst_size=4, gap_steps=6,
                                           max_len=32, max_new=4)),
    "shared-prefix": ("shared_prefix_trace", (12,),
                      dict(n_families=2, prefix_len=16, max_len=48,
                           max_new=4)),
    "fleet": ("fleet_trace", (12,), dict(n_models=3, max_len=32,
                                         max_new=4)),
    "scripted": ("scripted_trace",
                 ([(0, [1, 2], 3), (4, [5], 1), (4, [7, 8, 9], 2, 1)],),
                 {}),
}


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from repro import harness as j_harness
    from repro.configs import REGISTRY
    from repro.configs import reduced as j_reduced
    from repro.core import spec as j_spec
    from repro.harness import trace as j_trace
    from repro.models.model import Model as JModel
    from repro.serving.engine import ServingEngine as JServingEngine
    from repro.serving.events import EngineEvent as JEngineEvent

    @functools.cache
    def build(name: str, seed: int = 0, variant: str = ""):
        j_cfg = j_reduced(REGISTRY[name])
        cfg = reduced(get_config(name))
        if variant == "b":           # the fleet's second member
            kw = dict(name="adaptor-bert-shaped", num_layers=1, d_model=48,
                      num_heads=3, num_kv_heads=3, d_ff=96, vocab_size=96)
            j_cfg = dataclasses.replace(j_cfg, **kw)
            cfg = dataclasses.replace(cfg, **kw)
        if cfg.moe is not None:      # lossless capacity, as the MLA suite
            j_cfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=float(c.moe.num_experts)))
                for c in (j_cfg, cfg))
        params = JModel(j_cfg).init(jax.random.PRNGKey(seed))
        sd = from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
        return j_cfg, cfg, params, sd

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, harness=j_harness, trace=j_trace, spec=j_spec,
        engine=JServingEngine, Event=JEngineEvent, build=build)


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", list(GENERATORS))
@pytest.mark.parametrize("seed", [0, 7])
def test_traces_are_byte_identical_across_packages(ref, kind, seed):
    fn, args, kw = GENERATORS[kind]
    if kind != "scripted":
        kw = dict(kw, seed=seed)
    mine = getattr(harness, fn)(*args, **kw)
    theirs = getattr(ref.harness, fn)(*args, **kw)
    text = dumps_trace(mine)
    assert text == ref.trace.dumps_trace(theirs)
    # each package reads the other's bytes back into an equal trace
    assert loads_trace(ref.trace.dumps_trace(theirs)) == mine
    assert ref.trace.loads_trace(text) == theirs
    assert len(mine) == (len(args[0]) if kind == "scripted" else 12)


def test_trace_files_round_trip_across_packages(ref, tmp_path):
    t = harness.shared_prefix_trace(10, n_families=2, prefix_len=8,
                                    max_len=32, max_new=4, seed=1)
    harness.save_trace(t, tmp_path / "port.jsonl")
    assert ref.harness.load_trace(tmp_path / "port.jsonl") \
        == ref.harness.shared_prefix_trace(10, n_families=2, prefix_len=8,
                                           max_len=32, max_new=4, seed=1)
    ref.harness.save_trace(ref.harness.bursty_trace(
        6, burst_size=2, gap_steps=3, seed=4), tmp_path / "ref.jsonl")
    assert harness.load_trace(tmp_path / "ref.jsonl") \
        == harness.bursty_trace(6, burst_size=2, gap_steps=3, seed=4)
    assert (tmp_path / "port.jsonl").read_bytes().endswith(b"\n")


def test_trace_validation_is_the_references():
    for kw in (dict(arrival_step=-1, prompt=(1,), max_new_tokens=1),
               dict(arrival_step=0, prompt=(), max_new_tokens=1),
               dict(arrival_step=0, prompt=(1,), max_new_tokens=0)):
        with pytest.raises(ValueError):
            harness.TraceRequest(rid=0, **kw)
    with pytest.raises(ValueError, match="not the supported version"):
        loads_trace(json.dumps({"schema": 2}))
    with pytest.raises(ValueError, match="rate must be positive"):
        harness.poisson_trace(3, rate=0.0)


# ---------------------------------------------------------------------------
# metrics: the reference suite's hand-computed event streams
# ---------------------------------------------------------------------------
def _toy():
    """Three requests; r2 is preempted once and never finishes."""
    return [
        ("submit", 0, 0, 0.0, {}), ("submit", 1, 0, 0.0, {}),
        ("submit", 2, 0, 0.0, {}), ("admit", 0, 0, 0.0, {}),
        ("admit", 1, 1, 1.0, {}), ("admit", 2, 1, 1.0, {}),
        ("first_token", 0, 1, 0.5, {}),
        ("progress", 0, 1, 1.0, dict(count=1)),
        ("preempt", 2, 2, 2.0, dict(banked=0)),
        ("first_token", 1, 3, 2.5, {}),
        ("progress", 0, 3, 3.0, dict(count=3)),
        ("progress", 1, 3, 3.0, dict(count=1)),
        ("finish", 0, 3, 3.0, dict(n_generated=3)),
        ("admit", 2, 4, 4.0, {}),
        ("progress", 1, 4, 4.0, dict(count=2)),
        ("finish", 1, 4, 4.0, dict(n_generated=2)),
        ("first_token", 2, 5, 4.5, {}),
        ("progress", 2, 5, 5.0, dict(count=1)),
    ]


def _rebaseline():
    """Counts 2@s0 -> 1@s2 (a preemption: re-baseline) -> 3@s6."""
    return [
        ("submit", 0, 0, 0.0, {}), ("admit", 0, 0, 0.0, {}),
        ("progress", 0, 0, 0.0, dict(count=2)),
        ("progress", 0, 2, 2.0, dict(count=1)),
        ("progress", 0, 6, 6.0, dict(count=3)),
        ("finish", 0, 6, 6.0, dict(n_generated=3)),
    ]


def _spec():
    """Cumulative accepted / spec_steps with a preemption reset."""
    return [
        ("submit", 0, 0, 0.0, {}), ("admit", 0, 0, 0.0, {}),
        ("submit", 1, 0, 0.0, {}), ("admit", 1, 0, 0.0, {}),
        ("progress", 0, 1, 1.0, dict(count=3, accepted=2, spec_steps=1)),
        ("progress", 1, 1, 1.0, dict(count=2, accepted=0, spec_steps=2)),
        ("finish", 1, 1, 1.0, dict(n_generated=2)),
        ("progress", 0, 2, 2.0, dict(count=7, accepted=5, spec_steps=3)),
        ("preempt", 0, 3, 3.0, dict(banked=0)),
        ("admit", 0, 4, 4.0, {}),
        ("progress", 0, 5, 5.0, dict(count=2, accepted=1, spec_steps=1)),
        ("finish", 0, 5, 5.0, dict(n_generated=2)),
    ]


CASES = {"toy": (_toy, harness.SLO(ttft_steps=2)), "toy-no-slo": (_toy, None),
         "itl-rebaseline": (_rebaseline, None),
         "itl-slo": (_rebaseline, harness.SLO(itl_steps=1.5)),
         "speculation": (_spec, None)}


@pytest.mark.parametrize("case", list(CASES))
def test_reduce_events_matches_reference(ref, case):
    rows, slo = CASES[case]
    mine = harness.reduce_events([EngineEvent(*r) for r in rows()], slo)
    j_slo = None if slo is None else ref.harness.SLO(**dataclasses.asdict(slo))
    theirs = ref.harness.reduce_events([ref.Event(*r) for r in rows()],
                                       j_slo)
    assert mine.deterministic_json() == theirs.deterministic_json()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def test_hand_computed_values():
    """The reference suite's arithmetic (tests/test_harness.py), on the
    port's reduction."""
    m = harness.reduce_events([EngineEvent(*r) for r in _toy()],
                              harness.SLO(ttft_steps=2))
    assert (m.n_requests, m.n_finished, m.n_preemptions,
            m.peak_concurrency, m.steps) == (3, 2, 1, 3, 5)
    assert [m.per_request[u]["ttft_steps"] for u in range(3)] == [1, 3, 5]
    assert (m.ttft_steps_p50, m.ttft_steps_p99) == (3, 5)
    assert [m.per_request[u]["n_itl_samples"] for u in range(3)] == [2, 1, 0]
    assert (m.itl_steps_p50, m.total_new_tokens, m.n_slo_met) == (1.0, 5, 1)
    assert m.goodput_req_per_1k_steps == pytest.approx(200.0)
    assert m.ttft_s_p50 == pytest.approx(3.0)
    assert m.wall_s == pytest.approx(5.0)
    r = harness.reduce_events([EngineEvent(*e) for e in _rebaseline()])
    assert (r.per_request[0]["n_itl_samples"], r.itl_steps_p50) == (2, 2.0)
    s = harness.reduce_events([EngineEvent(*e) for e in _spec()])
    assert (s.spec_accepted_tokens, s.spec_steps,
            s.mean_accepted_len) == (6, 6, 1.0)
    assert percentile([4, 1, 3, 2], 50) == 2
    assert percentile([], 50) is None
    with pytest.raises(ValueError):
        harness.reduce_events([])
    log = EventLog()
    for e in _toy():
        log(EngineEvent(*e))
    assert len(log) == 18 and len(log.of_kind("admit")) == 4
    assert [e.kind for e in log.of_uid(2)][-2:] == ["first_token",
                                                    "progress"]


# ---------------------------------------------------------------------------
# replay parity against the reference engine
# ---------------------------------------------------------------------------
MEM = dict(cache_layout="paged", max_batch=4, max_len=64, block_size=8)
QWEN = "qwen1.5-0.5b"


def _traces():
    return {
        "bursty": harness.bursty_trace(12, burst_size=4, gap_steps=4,
                                       max_len=48, max_new=6, seed=13),
        "poisson": harness.poisson_trace(12, rate=0.5, max_len=48,
                                         max_new=6, seed=7),
        "shared-prefix": harness.shared_prefix_trace(
            10, n_families=2, prefix_len=20, max_len=48, max_new=4, seed=2),
        "fleet": harness.fleet_trace(10, n_models=2, max_len=48, max_new=4,
                                     seed=5),
    }


# mode: (arch, trace, memory overrides, speculation k, fleet)
MODES = {
    "bursty": (QWEN, "bursty", {}, 0, False),
    "poisson": (QWEN, "poisson", {}, 0, False),
    "prefix-cache": (QWEN, "shared-prefix", dict(prefix_cache=True), 0,
                     False),
    "preempting": (QWEN, "bursty", dict(num_blocks=8), 0, False),
    "fleet": (QWEN, "fleet", {}, 0, True),
    "self-draft": (QWEN, "bursty", {}, 3, False),
    "granite": ("granite-moe-1b-a400m", "bursty", {}, 0, False),
    "deepseek-mla": ("deepseek-v3-671b", "bursty", {}, 0, False),
}


def _f32_pool(ref, je, te):
    """Hand both engines a float32 pool of the same geometry (the
    reference stores its pool in bf16 even at float32 compute)."""
    je.cache = ref.jax.tree.map(lambda a: a.astype(ref.jnp.float32),
                                je.cache)
    te.cache = type(te.cache)(*(None if t is None else t.float()
                                for t in te.cache))


def _pair(ref, mode):
    """The reference engine and the port's for ``mode``, loaded with the
    same weights and a float32 pool."""
    name, _, mem, k, fleet = MODES[mode]
    j_cfg, cfg, params, sd = ref.build(name)
    mem = {**MEM, **mem}
    maxima = j_maxima = None
    if fleet:
        jb, cb, pb, sb = ref.build(name, 1, "b")
        maxima = maxima_for(cfg, cb, seq_max=MEM["max_len"])
        j_maxima = ref.spec.maxima_for(j_cfg, jb, seq_max=MEM["max_len"])
    s = ref.spec
    je = ref.engine(s.RuntimeSpec(
        arch=j_cfg, maxima=j_maxima,
        execution=s.ExecutionSpec(compute_dtype="fp32"),
        memory=s.MemorySpec(**mem), scheduler=s.SchedulerSpec(chunk_size=8),
        speculation=s.SpeculationSpec(draft_model=j_cfg, k=k) if k
        else None), **({"max_models": 2} if fleet else {}))
    te = ServingEngine(RuntimeSpec(
        arch=cfg, maxima=maxima,
        execution=ExecutionSpec(compute_dtype="fp32"),
        memory=MemorySpec(**mem), scheduler=SchedulerSpec(chunk_size=8),
        speculation=SpeculationSpec(draft_model=cfg, k=k) if k else None),
        max_models=2 if fleet else 4, device="cpu")
    if fleet:
        je.add_model(params, j_cfg)
        je.add_model(pb, jb)
        te.add_model(sd, cfg)
        te.add_model(sb, cb)
    elif k:
        je.load(params, draft=params)
        te.load(sd, draft=sd)
    else:
        je.load(params)
        te.load(sd)
    _f32_pool(ref, je, te)
    return je, te


def _streams(res) -> dict:
    return {res.uid_to_rid[r.uid]: r.generated for r in res.finished}


def _exactly_once(res, n: int) -> None:
    """Every request finished; each uid has one submit, first_token and
    finish, admits - preempts = 1, and its steps never run backwards."""
    assert res.metrics.n_finished == n
    by_uid: dict[int, list] = {}
    for e in res.events:
        by_uid.setdefault(e.uid, []).append(e)
    assert len(by_uid) == n
    for uid, evs in by_uid.items():
        kinds = [e.kind for e in evs]
        for kind in ("submit", "first_token", "finish"):
            assert kinds.count(kind) == 1, (uid, kinds)
        assert kinds.count("admit") - kinds.count("preempt") == 1
        assert kinds[0] == "submit" and kinds[-1] == "finish"
        assert [e.step for e in evs] == sorted(e.step for e in evs)
        assert all(type(v) in (int, float) for e in evs
                   for v in e.data.values()), (uid, kinds)


@pytest.mark.parametrize("mode", list(MODES))
def test_replay_matches_reference(ref, mode):
    trace = _traces()[MODES[mode][1]]
    je, te = _pair(ref, mode)
    want = ref.harness.replay(je, ref.trace.loads_trace(dumps_trace(trace)))
    got = harness.replay(te, trace)
    assert got.metrics.deterministic_json() \
        == want.metrics.deterministic_json()
    assert _streams(got) == _streams(want)
    assert got.rid_metrics == want.rid_metrics
    _exactly_once(got, len(trace))
    m = got.metrics
    if mode == "preempting":
        assert m.n_preemptions > 0
    if mode == "prefix-cache":
        assert m.prefix_hits > 0 and m.prefix_hit_tokens > 0
    if mode == "self-draft":
        assert m.spec_steps > 0 and m.spec_accepted_tokens > 0
    if mode == "fleet":
        assert {r.model for r in got.finished} == {0, 1}


def test_warm_replay_repeats_the_first(ref):
    """Arrivals count from the replay's start: a second replay on the same
    engine gives the same per-rid metrics and streams (uids differ, so
    the per-uid view is compared by rid)."""
    trace = _traces()["bursty"]
    _, te = _pair(ref, "bursty")
    first, second = harness.replay(te, trace), harness.replay(te, trace)
    assert second.rid_metrics == first.rid_metrics
    assert _streams(second) == _streams(first)
    a, b = first.metrics.deterministic(), second.metrics.deterministic()
    a.pop("per_request"), b.pop("per_request")
    assert a == b
    assert min(second.uid_to_rid) == max(first.uid_to_rid) + 1


def test_replay_refuses_to_spin(ref):
    trace = _traces()["bursty"]
    _, te = _pair(ref, "bursty")
    with pytest.raises(RuntimeError, match="exceeded max_steps=3"):
        harness.replay(te, trace, max_steps=3)
    assert not te.events.active       # the log unsubscribed


def test_serve_replays_a_saved_trace(ref, capsys, tmp_path):
    path = tmp_path / "t.jsonl"
    ref.harness.save_trace(ref.harness.shared_prefix_trace(
        6, n_families=1, prefix_len=12, max_len=32, max_new=3, seed=3), path)
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--trace", str(path), "--max-len", "32",
          "--block-size", "8", "--chunk-size", "8", "--temperature", "0",
          "--cache-layout", "paged",
          "--prefix-cache", "--slo-ttft-steps", "4"])
    out = capsys.readouterr().out
    assert "trace 'shared-prefix' (seed 3) on cpu: 6/6 finished" in out
    assert "TTFT p50/p99" in out and " ms)" in out
    assert "SLO (ttft<=4 steps)" in out
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--tuned"])
    assert "ROADMAP.md Queue 1 item 15" in capsys.readouterr().err


def test_progress_data_are_python_scalars():
    """The engine's event data reach ``deterministic_json()``: every
    value a Python int (the harvest's counts come over with .tolist())."""
    cfg = reduced(get_config(QWEN))
    eng = ServingEngine(RuntimeSpec(
        arch=cfg, memory=MemorySpec(**MEM),
        scheduler=SchedulerSpec(chunk_size=8),
        speculation=SpeculationSpec(draft_model=cfg, k=2)), device="cpu")
    from repro_torch.models.model import Model
    sd = Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict()
    eng.load(sd, draft=sd)
    res = harness.replay(eng, harness.bursty_trace(
        4, burst_size=2, gap_steps=2, max_len=32, max_new=4, seed=1))
    prog = [e for e in res.events if e.kind == "progress"]
    assert prog and all(type(v) is int for e in prog for v in e.data.values())
    assert set(prog[0].data) == {"count", "accepted", "spec_steps"}
    _exactly_once(res, 4)
    json.loads(res.metrics.deterministic_json())
