"""Structured per-request lifecycle events emitted by the serving engine.

The port's copy of the reference's ``serving/events.py``: the engine
publishes one :class:`EngineEvent` per request lifecycle transition
through an :class:`EventBus`, and consumers (the load harness,
``repro_torch.harness``, through :class:`EventLog`) subscribe instead of
polling.

Lifecycle of one request::

    submit ──> admit ──> first_token ──> progress* ──> finish
                  └──────────── preempt ──> admit ...(re-entry)

``progress`` is published after the harvest's transfer has brought the
counts to the host, so its wall stamp is completion-honest (the harness's
wall-clock TTFT reads the first ``progress`` with ``count >= 1``); every
value in ``data`` is a Python scalar.

Every event carries the engine's logical clock (``step`` = fused
dispatches so far) and a ``time.perf_counter()`` wall stamp; step
arithmetic is reproducible, wall stamps are not.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

EVENT_KINDS = ("submit", "admit", "first_token", "progress", "finish",
               "preempt")


@dataclass(frozen=True)
class EngineEvent:
    """One lifecycle transition of one request."""

    kind: str                 # one of EVENT_KINDS
    uid: int                  # engine request uid
    step: int                 # engine logical clock (fused dispatches)
    t: float                  # wall stamp (time.perf_counter())
    data: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}; expected "
                             f"one of {EVENT_KINDS}")


class EventBus:
    """Tiny synchronous pub/sub: subscribers are called in order, on the
    engine's host thread, at emission time."""

    def __init__(self) -> None:
        self._subs: list[Callable[[EngineEvent], None]] = []

    @property
    def active(self) -> bool:
        """True when at least one subscriber would see an event — the
        engine skips event construction entirely otherwise."""
        return bool(self._subs)

    def subscribe(self, cb: Callable[[EngineEvent], None]) -> None:
        self._subs.append(cb)

    def unsubscribe(self, cb: Callable[[EngineEvent], None]) -> None:
        self._subs.remove(cb)

    def publish(self, event: EngineEvent) -> None:
        for cb in self._subs:
            cb(event)


class EventLog:
    """The standard subscriber: an append-only list with per-uid views."""

    def __init__(self) -> None:
        self.events: list[EngineEvent] = []

    def __call__(self, event: EngineEvent) -> None:
        self.events.append(event)

    def __len__(self) -> int:
        return len(self.events)

    def of_kind(self, kind: str) -> list[EngineEvent]:
        return [e for e in self.events if e.kind == kind]

    def of_uid(self, uid: int) -> list[EngineEvent]:
        return [e for e in self.events if e.uid == uid]


def now() -> float:
    return time.perf_counter()
