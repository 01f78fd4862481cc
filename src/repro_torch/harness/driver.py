"""Replay a trace against a configured :class:`ServingEngine`.

The port's own copy of the reference's ``harness/driver.py``; it drives
the port's ``serving.engine.ServingEngine`` (one model or a fleet, with
or without the prefix cache or speculation, graphed or eager) through
the same surface.

The driver owns the outer serve loop every benchmark used to hand-roll:
submit requests when the engine's logical clock reaches their
``arrival_step``, call ``engine.step()`` otherwise, and collect the
lifecycle events the engine publishes.  It works unchanged across all
engine configurations — bucketed or chunked scheduler, dense or paged
cache, single model or fleet — because it only touches the public
surface (``submit`` / ``step`` / ``events`` / ``stats``).

Clock semantics: arrivals are relative to the engine's step count at
replay start, so a warm engine (already-compiled programs, nonzero
``decode_steps``) replays a trace identically to a cold one.  The
engine's clock only advances while it has work; if it drains completely
before the next arrival, the gap is collapsed — the next arrival batch
is submitted immediately.  Idle wall time is never simulated, which is
exactly what makes step metrics reproducible.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.harness.metrics import SLO, HarnessMetrics, reduce_events
from repro_torch.harness.trace import Trace
from repro_torch.serving.events import EngineEvent, EventLog


@dataclass(frozen=True)
class ReplayResult:
    """Everything one replay produced."""

    trace: Trace
    metrics: HarnessMetrics
    events: list[EngineEvent]
    finished: list                       # engine Request objects
    uid_to_rid: dict[int, int] = field(default_factory=dict)

    @property
    def rid_metrics(self) -> dict:
        """Per-request step metrics keyed by *trace* rid (uids are
        assigned per engine and differ across replays)."""
        return {self.uid_to_rid[uid]: m
                for uid, m in self.metrics.per_request.items()
                if uid in self.uid_to_rid}


def replay(engine, trace: Trace, *, slo: SLO | None = None,
           max_steps: int = 50_000) -> ReplayResult:
    """Drive ``engine`` through ``trace`` and reduce the event stream.

    ``max_steps`` bounds fused dispatches (a stuck replay raises rather
    than spinning).  The engine must be loaded (and in fleet mode, every
    model id the trace references must be added) before calling.
    """
    log = EventLog()
    engine.events.subscribe(log)
    # stable sort: equal arrival steps keep trace order, so uid
    # assignment (and therefore the whole replay) is deterministic
    reqs = sorted(trace.requests, key=lambda r: r.arrival_step)
    uid_to_rid: dict[int, int] = {}
    finished = []
    try:
        step0 = engine.stats["decode_steps"]
        i, n, steps = 0, len(reqs), 0

        def _submit_due(until: int) -> None:
            nonlocal i
            while i < n and reqs[i].arrival_step <= until:
                uid = engine.submit(list(reqs[i].prompt),
                                    max_new_tokens=reqs[i].max_new_tokens,
                                    model=reqs[i].model)
                uid_to_rid[uid] = reqs[i].rid
                i += 1

        while True:
            _submit_due(engine.stats["decode_steps"] - step0)
            if not engine.queue and all(r is None for r in engine.slot_req):
                if i >= n:
                    break               # drained and no arrivals left
                # engine fully idle before the next arrival: collapse the
                # idle gap (submit the whole next arrival batch now)
                _submit_due(reqs[i].arrival_step)
                continue
            if steps >= max_steps:
                raise RuntimeError(
                    f"replay of trace {trace.name!r} exceeded max_steps="
                    f"{max_steps} with {n - i} unsubmitted and "
                    f"{len(engine.queue)} queued requests")
            finished += engine.step()
            steps += 1
    finally:
        engine.events.unsubscribe(log)
    return ReplayResult(trace=trace, metrics=reduce_events(log.events, slo),
                        events=log.events, finished=finished,
                        uid_to_rid=uid_to_rid)
