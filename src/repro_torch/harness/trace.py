"""Seeded synthetic request traces + a small versioned on-disk format.

The port's own copy of the reference's ``harness/trace.py``: the same
generators drawing from the same ``numpy.random.RandomState`` streams,
so one generator, its arguments and its seed give a byte-identical
``dumps_trace`` in both packages, and either package loads the other's
files.

A trace is the workload half of a benchmark: an ordered sequence of
requests, each with an arrival time in *engine steps* (fused dispatches,
the engine's logical clock — wall-clock arrivals would make every replay
machine-dependent).  Generators are seeded ``numpy.random.RandomState``
(whose streams are frozen by numpy's compatibility guarantee), so the
same ``(generator, seed)`` always yields byte-identical traces — and the
on-disk format serializes canonically (sorted keys, fixed separators) so
"byte-identical" survives a save/load round trip too.

Arrival semantics during replay: the driver submits a request once the
engine's step clock reaches ``arrival_step``.  If the engine goes
completely idle before then, the remaining arrivals are submitted as the
engine reaches them with the queue empty — idle wall time is not
simulated (steps only advance when the engine dispatches work).

Generators cover the scenario families the serving stack is built for:

* :func:`poisson_trace`       — memoryless arrivals at a target rate.
* :func:`bursty_trace`        — arrival bursts separated by quiet gaps
  (the adversarial case for admission + preemption).
* :func:`shared_prefix_trace` — system-prompt-style traffic where most
  requests extend one of a few shared prefixes (prefix-cache workloads).
* :func:`fleet_trace`         — multi-model request streams for the
  multi-topology fabric.
* :func:`scripted_trace`      — hand-written request tuples for tests.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

TRACE_SCHEMA = 1


@dataclass(frozen=True)
class TraceRequest:
    """One request of a trace.  ``rid`` is its stable identity within the
    trace (engine uids differ per replay; results are keyed by rid)."""

    rid: int
    arrival_step: int
    prompt: tuple[int, ...]
    max_new_tokens: int
    model: int = 0            # fleet member (multi-topology mode)

    def __post_init__(self) -> None:
        if self.arrival_step < 0:
            raise ValueError(f"request {self.rid}: arrival_step "
                             f"{self.arrival_step} < 0")
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens "
                             f"{self.max_new_tokens} < 1")


@dataclass(frozen=True)
class Trace:
    """An ordered, replayable request sequence."""

    name: str
    seed: int
    requests: tuple[TraceRequest, ...]
    meta: dict = field(default_factory=dict)   # generator parameters

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def max_prompt_len(self) -> int:
        return max(len(r.prompt) for r in self.requests)

    @property
    def mean_prompt_len(self) -> float:
        return sum(len(r.prompt) for r in self.requests) / len(self.requests)

    @property
    def mean_new_tokens(self) -> float:
        return sum(r.max_new_tokens for r in self.requests) / len(self.requests)

    @property
    def models(self) -> tuple[int, ...]:
        return tuple(sorted({r.model for r in self.requests}))


# ---------------------------------------------------------------------------
# On-disk format
# ---------------------------------------------------------------------------
def dumps_trace(trace: Trace) -> str:
    """Canonical serialization: sorted keys, fixed separators, trailing
    newline — byte-identical for equal traces, whatever dict order the
    generator produced."""
    obj = {
        "schema": TRACE_SCHEMA,
        "name": trace.name,
        "seed": trace.seed,
        "meta": trace.meta,
        "requests": [[r.rid, r.arrival_step, r.max_new_tokens, r.model,
                      list(r.prompt)] for r in trace.requests],
    }
    return json.dumps(obj, sort_keys=True, separators=(",", ":")) + "\n"


def loads_trace(text: str) -> Trace:
    try:
        obj = json.loads(text)
    except ValueError as e:
        raise ValueError(f"trace file is not valid JSON: {e}") from e
    if not isinstance(obj, dict) or obj.get("schema") != TRACE_SCHEMA:
        raise ValueError(
            f"trace schema {obj.get('schema') if isinstance(obj, dict) else obj!r} "
            f"is not the supported version {TRACE_SCHEMA}")
    reqs = tuple(TraceRequest(rid=r[0], arrival_step=r[1],
                              max_new_tokens=r[2], model=r[3],
                              prompt=tuple(r[4]))
                 for r in obj["requests"])
    return Trace(name=obj["name"], seed=obj["seed"], requests=reqs,
                 meta=obj.get("meta", {}))


def save_trace(trace: Trace, path: str | Path) -> None:
    Path(path).write_text(dumps_trace(trace))


def load_trace(path: str | Path) -> Trace:
    return loads_trace(Path(path).read_text())


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------
def _tokens(rng: np.random.RandomState, n: int, vocab: int) -> tuple[int, ...]:
    """Token ids in [1, vocab] — 0 is avoided (pad/garbage by convention
    in the engine buffers), and vocab=50 fits every reduced() arch."""
    return tuple(1 + int(t) for t in rng.randint(0, vocab, size=n))


def _mixed_len(rng: np.random.RandomState, max_len: int,
               short_frac: float) -> int:
    """Mixed prompt lengths: mostly short chat-style prompts with a long
    tail of document-style ones (the distribution chunked prefill and
    paged admission are designed around)."""
    if rng.random_sample() < short_frac:
        return int(rng.randint(4, max(max_len // 8, 5)))
    return int(rng.randint(max_len // 4, max(3 * max_len // 4, max_len // 4 + 1)))


def _budget(rng: np.random.RandomState, max_new: int) -> int:
    return int(rng.randint(max(2, max_new // 2), max_new + 1))


def poisson_trace(n: int, *, rate: float, max_len: int = 128,
                  max_new: int = 8, short_frac: float = 0.7,
                  vocab: int = 50, seed: int = 0,
                  name: str = "poisson") -> Trace:
    """Memoryless arrivals at ``rate`` requests per engine step."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.RandomState(seed)
    t, reqs = 0.0, []
    for rid in range(n):
        t += rng.exponential(1.0 / rate)
        plen = min(_mixed_len(rng, max_len, short_frac), max_len - max_new)
        reqs.append(TraceRequest(rid, int(t), _tokens(rng, plen, vocab),
                                 _budget(rng, max_new)))
    return Trace(name, seed, tuple(reqs),
                 meta={"kind": "poisson", "rate": rate, "max_len": max_len,
                       "max_new": max_new, "short_frac": short_frac})


def bursty_trace(n: int, *, burst_size: int, gap_steps: int,
                 max_len: int = 128, max_new: int = 8,
                 short_frac: float = 0.7, vocab: int = 50, seed: int = 0,
                 name: str = "bursty") -> Trace:
    """Bursts of ``burst_size`` simultaneous arrivals every ``gap_steps``
    engine steps — the admission-control stress case: each burst exceeds
    what a naive configuration can seat, so queueing (and with paging,
    preemption pressure) is part of the workload, not an accident."""
    if burst_size < 1 or gap_steps < 1:
        raise ValueError("burst_size and gap_steps must be >= 1, got "
                         f"{burst_size} and {gap_steps}")
    rng = np.random.RandomState(seed)
    reqs = []
    for rid in range(n):
        burst = rid // burst_size
        plen = min(_mixed_len(rng, max_len, short_frac), max_len - max_new)
        reqs.append(TraceRequest(rid, burst * gap_steps,
                                 _tokens(rng, plen, vocab),
                                 _budget(rng, max_new)))
    return Trace(name, seed, tuple(reqs),
                 meta={"kind": "bursty", "burst_size": burst_size,
                       "gap_steps": gap_steps, "max_len": max_len,
                       "max_new": max_new, "short_frac": short_frac})


def shared_prefix_trace(n: int, *, n_families: int, prefix_len: int,
                        max_len: int = 128, max_new: int = 8,
                        shared_frac: float = 0.8, vocab: int = 50,
                        seed: int = 0, arrival_every: int = 1,
                        name: str = "shared-prefix") -> Trace:
    """System-prompt traffic: ``shared_frac`` of requests extend one of
    ``n_families`` fixed prefixes with a unique suffix; the rest are
    fully unique prompts.  Family prefixes are deterministic in the seed,
    so two engines replaying the trace see identical sharing structure."""
    if not 0 <= shared_frac <= 1:
        raise ValueError(f"shared_frac must be in [0, 1], got {shared_frac}")
    if prefix_len + max_new >= max_len:
        raise ValueError(
            f"prefix_len={prefix_len} + max_new={max_new} must leave room "
            f"under max_len={max_len}")
    rng = np.random.RandomState(seed)
    families = [_tokens(rng, prefix_len, vocab) for _ in range(n_families)]
    reqs = []
    for rid in range(n):
        budget = _budget(rng, max_new)
        if rng.random_sample() < shared_frac:
            base = families[int(rng.randint(0, n_families))]
            room = max_len - prefix_len - budget
            sfx = int(rng.randint(1, max(room // 2, 2)))
            prompt = base + _tokens(rng, sfx, vocab)
        else:
            plen = min(_mixed_len(rng, max_len, 0.8), max_len - budget)
            prompt = _tokens(rng, plen, vocab)
        reqs.append(TraceRequest(rid, rid // max(arrival_every, 1),
                                 prompt, budget))
    return Trace(name, seed, tuple(reqs),
                 meta={"kind": "shared-prefix", "n_families": n_families,
                       "prefix_len": prefix_len, "shared_frac": shared_frac,
                       "max_len": max_len, "max_new": max_new})


def fleet_trace(n: int, *, n_models: int, max_len: int = 64,
                max_new: int = 6, vocab: int = 50, seed: int = 0,
                burst_size: int = 4, gap_steps: int = 4,
                name: str = "fleet") -> Trace:
    """Multi-model request stream: bursty arrivals round-robined (with
    seeded jitter) across ``n_models`` fleet members."""
    if n_models < 1:
        raise ValueError(f"n_models must be >= 1, got {n_models}")
    rng = np.random.RandomState(seed)
    reqs = []
    for rid in range(n):
        plen = min(_mixed_len(rng, max_len, 0.8), max_len - max_new)
        model = int(rng.randint(0, n_models)) if rng.random_sample() < 0.5 \
            else rid % n_models
        reqs.append(TraceRequest(rid, (rid // burst_size) * gap_steps,
                                 _tokens(rng, plen, vocab),
                                 _budget(rng, max_new), model=model))
    return Trace(name, seed, tuple(reqs),
                 meta={"kind": "fleet", "n_models": n_models,
                       "max_len": max_len, "max_new": max_new})


def scripted_trace(rows, *, name: str = "scripted", seed: int = 0) -> Trace:
    """Hand-written trace: rows of ``(arrival_step, prompt, max_new)`` or
    ``(arrival_step, prompt, max_new, model)`` — the toy-trace entry
    point for tests and examples."""
    reqs = []
    for rid, row in enumerate(rows):
        arrival, prompt, max_new = row[0], row[1], row[2]
        model = row[3] if len(row) > 3 else 0
        reqs.append(TraceRequest(rid, arrival, tuple(prompt), max_new,
                                 model=model))
    return Trace(name, seed, tuple(reqs), meta={"kind": "scripted"})
