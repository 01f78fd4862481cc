"""Reduce engine lifecycle events to serving SLO metrics.

The port's own copy of the reference's ``harness/metrics.py``: the same
definitions, so the same event stream reduces to the same
:meth:`HarnessMetrics.deterministic_json` bytes in both packages.  Every
value the port's engine puts in an event is a Python scalar (the
harvest's counts come over with ``.tolist()``), which keeps those bytes
equal.

Every metric exists in two currencies, kept strictly separated:

* **steps** — the engine's logical clock (fused dispatches).  Step
  arithmetic is bit-reproducible across runs and machines, so the CI
  reproducibility smoke and all benchmark gates use the step view
  (:meth:`HarnessMetrics.deterministic`).
* **seconds** — ``time.perf_counter()`` wall stamps.  Honest for
  human-facing numbers, useless for gating.

Definitions (all hand-computable from an event list, and tested that
way in ``tests/test_harness.py``; ``tests/test_torch_harness.py`` runs
those cases through this copy too):

* **TTFT (steps)** — ``first_token.step - submit.step``: dispatches
  between entering the queue and the first generated token existing.
* **TTFT (seconds)** — first ``progress`` with ``count >= 1`` minus
  ``submit``.  ``first_token``'s own wall stamp is dispatch-side
  (async dispatch returns before the device finishes), so the wall
  view waits for the first *completion-honest* observation instead.
* **ITL** — for each consecutive ``progress`` pair of one request with
  counts ``c0 < c1`` at steps ``s0 < s1``, append ``c1 - c0`` samples
  of ``(s1 - s0) / (c1 - c0)`` steps per token (wall analogue from the
  stamps).  A count *decrease* is a preemption reset: re-baseline,
  no samples.
* **Percentiles** — nearest-rank: ``sorted(xs)[ceil(q/100 * n) - 1]``.
  No interpolation, so toy-trace expectations are exact.
* **Peak concurrency** — running sum over the event stream
  (``admit`` +1, ``finish``/``preempt`` -1), maxed.
* **Mean accepted draft length** — speculative decoding only: total
  accepted draft tokens over total speculative fused steps, both read
  from the cumulative ``accepted`` / ``spec_steps`` counters on
  ``progress`` events (a decrease in ``accepted`` is a preemption
  reset: the previous epoch's totals are banked and the counter
  re-baselines, mirroring the ITL rule).  ``None`` when no step
  speculated.  Tokens/step for a speculating slot is then
  ``1 + mean_accepted_len``.
* **SLO / goodput** — a request meets the :class:`SLO` iff it finished,
  its TTFT (steps) is within ``slo.ttft_steps``, and its worst
  per-token ITL (steps) is within ``slo.itl_steps`` (each bound
  optional).  ``slo_attainment`` is the met fraction of submitted
  requests; goodput counts only SLO-met finishes, per 1k steps and
  per wall second.  With no SLO, "met" degrades to "finished".
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass

from repro_torch.serving.events import EngineEvent

_WALL_FIELDS = ("wall_s", "ttft_s_p50", "ttft_s_p99", "itl_s_p50",
                "itl_s_p99", "goodput_req_s", "tokens_per_s")


@dataclass(frozen=True)
class SLO:
    """Service-level objective in engine steps.  ``None`` bounds are
    unconstrained."""

    ttft_steps: int | None = None
    itl_steps: float | None = None


@dataclass(frozen=True)
class HarnessMetrics:
    """Reduced view of one replay.  Step-based fields (everything not in
    ``_WALL_FIELDS``) are bit-reproducible for a fixed trace + spec."""

    n_requests: int
    n_finished: int
    n_preemptions: int
    peak_concurrency: int
    prefix_hits: int
    prefix_hit_tokens: int
    steps: int                      # event-stream step span
    total_new_tokens: int
    tokens_per_step: float
    spec_accepted_tokens: int       # accepted draft tokens (speculation)
    spec_steps: int                 # fused steps that speculated
    mean_accepted_len: float | None  # accepted/steps; None without spec
    ttft_steps_p50: float | None
    ttft_steps_p99: float | None
    itl_steps_p50: float | None
    itl_steps_p99: float | None
    n_slo_met: int
    slo_attainment: float
    goodput_req_per_1k_steps: float
    per_request: dict               # uid -> step-based summary
    # wall-clock view (machine-dependent; excluded from deterministic())
    wall_s: float
    ttft_s_p50: float | None
    ttft_s_p99: float | None
    itl_s_p50: float | None
    itl_s_p99: float | None
    goodput_req_s: float
    tokens_per_s: float

    def deterministic(self) -> dict:
        """The step-based view only — byte-comparable across runs."""
        d = asdict(self)
        for k in _WALL_FIELDS:
            del d[k]
        return d

    def deterministic_json(self) -> str:
        """Canonical serialization of :meth:`deterministic` — two replays
        of the same trace on the same spec must produce identical bytes."""
        return json.dumps(self.deterministic(), sort_keys=True,
                          separators=(",", ":")) + "\n"


def percentile(xs, q: float):
    """Nearest-rank percentile; ``None`` on an empty sample."""
    if not xs:
        return None
    ys = sorted(xs)
    return ys[max(math.ceil(q / 100.0 * len(ys)), 1) - 1]


class _ReqState:
    """Per-request accumulator while scanning the event stream."""

    __slots__ = ("submit_step", "submit_t", "ft_step", "ttft_s", "finished",
                 "n_generated", "itl_steps", "itl_s", "base",
                 "spec_acc", "spec_steps", "spec_base")

    def __init__(self) -> None:
        self.submit_step = None
        self.submit_t = None
        self.ft_step = None
        self.ttft_s = None
        self.finished = False
        self.n_generated = 0
        self.itl_steps: list[float] = []
        self.itl_s: list[float] = []
        self.base = None          # (count, step, t) ITL baseline
        self.spec_acc = 0         # accepted tokens banked across preemptions
        self.spec_steps = 0       # speculative steps banked likewise
        self.spec_base = None     # (accepted, spec_steps) cumulative epoch

    def on_progress(self, e: EngineEvent) -> None:
        a = e.data.get("accepted")
        if a is not None:
            ss = e.data.get("spec_steps", 0)
            if self.spec_base is not None and a < self.spec_base[0]:
                # preemption reset: bank the epoch, re-baseline
                self.spec_acc += self.spec_base[0]
                self.spec_steps += self.spec_base[1]
            self.spec_base = (a, ss)
        c = e.data["count"]
        if c >= 1 and self.ttft_s is None and self.submit_t is not None:
            self.ttft_s = e.t - self.submit_t
        if self.base is None:
            if c >= 1:
                self.base = (c, e.step, e.t)
            return
        c0, s0, t0 = self.base
        if c < c0:                # preemption reset: re-baseline, no samples
            self.base = (c, e.step, e.t) if c >= 1 else None
            return
        if c > c0:
            n = c - c0
            self.itl_steps.extend([(e.step - s0) / n] * n)
            self.itl_s.extend([(e.t - t0) / n] * n)
            self.base = (c, e.step, e.t)

    def ttft_steps(self):
        if self.ft_step is None or self.submit_step is None:
            return None
        return self.ft_step - self.submit_step

    def spec_totals(self) -> tuple[int, int]:
        """(accepted draft tokens, speculative steps) including the
        still-open epoch."""
        acc, steps = self.spec_acc, self.spec_steps
        if self.spec_base is not None:
            acc += self.spec_base[0]
            steps += self.spec_base[1]
        return acc, steps

    def meets(self, slo: SLO | None) -> bool:
        if not self.finished:
            return False
        if slo is None:
            return True
        ttft = self.ttft_steps()
        if slo.ttft_steps is not None and (ttft is None
                                           or ttft > slo.ttft_steps):
            return False
        if slo.itl_steps is not None and self.itl_steps \
                and max(self.itl_steps) > slo.itl_steps:
            return False
        return True


def reduce_events(events: list[EngineEvent],
                  slo: SLO | None = None) -> HarnessMetrics:
    """Scan an event stream (in emission order) into :class:`HarnessMetrics`."""
    if not events:
        raise ValueError("reduce_events needs a non-empty event stream")
    reqs: dict[int, _ReqState] = {}
    live = peak = 0
    n_preempt = prefix_hits = prefix_hit_tokens = 0
    for e in events:
        r = reqs.setdefault(e.uid, _ReqState())
        if e.kind == "submit":
            if r.submit_step is None:
                r.submit_step, r.submit_t = e.step, e.t
        elif e.kind == "admit":
            live += 1
            peak = max(peak, live)
            cached = e.data.get("cached_tokens", 0)
            if cached:
                prefix_hits += 1
                prefix_hit_tokens += cached
        elif e.kind == "first_token":
            if r.ft_step is None:
                r.ft_step = e.step
        elif e.kind == "progress":
            r.on_progress(e)
        elif e.kind == "finish":
            live -= 1
            r.finished = True
            r.n_generated = e.data.get("n_generated", 0)
        elif e.kind == "preempt":
            live -= 1
            n_preempt += 1

    steps = max(e.step for e in events) - min(e.step for e in events)
    wall_s = max(e.t for e in events) - min(e.t for e in events)
    ttfts = [r.ttft_steps() for r in reqs.values()
             if r.ttft_steps() is not None]
    ttfts_s = [r.ttft_s for r in reqs.values() if r.ttft_s is not None]
    itls = [x for r in reqs.values() for x in r.itl_steps]
    itls_s = [x for r in reqs.values() for x in r.itl_s]
    n_finished = sum(r.finished for r in reqs.values())
    n_met = sum(r.meets(slo) for r in reqs.values())
    total_new = sum(r.n_generated for r in reqs.values())
    spec_acc = sum(r.spec_totals()[0] for r in reqs.values())
    spec_steps = sum(r.spec_totals()[1] for r in reqs.values())
    per_request = {
        uid: {"ttft_steps": r.ttft_steps(), "finished": r.finished,
              "n_generated": r.n_generated,
              "n_itl_samples": len(r.itl_steps),
              "max_itl_steps": max(r.itl_steps) if r.itl_steps else None,
              "slo_met": r.meets(slo)}
        for uid, r in sorted(reqs.items())}
    return HarnessMetrics(
        n_requests=len(reqs),
        n_finished=n_finished,
        n_preemptions=n_preempt,
        peak_concurrency=peak,
        prefix_hits=prefix_hits,
        prefix_hit_tokens=prefix_hit_tokens,
        steps=steps,
        total_new_tokens=total_new,
        tokens_per_step=total_new / max(steps, 1),
        spec_accepted_tokens=spec_acc,
        spec_steps=spec_steps,
        mean_accepted_len=(spec_acc / spec_steps) if spec_steps else None,
        ttft_steps_p50=percentile(ttfts, 50),
        ttft_steps_p99=percentile(ttfts, 99),
        itl_steps_p50=percentile(itls, 50),
        itl_steps_p99=percentile(itls, 99),
        n_slo_met=n_met,
        slo_attainment=n_met / len(reqs),
        goodput_req_per_1k_steps=1000.0 * n_met / max(steps, 1),
        per_request=per_request,
        wall_s=wall_s,
        ttft_s_p50=percentile(ttfts_s, 50),
        ttft_s_p99=percentile(ttfts_s, 99),
        itl_s_p50=percentile(itls_s, 50),
        itl_s_p99=percentile(itls_s, 99),
        goodput_req_s=n_met / wall_s if wall_s > 0 else 0.0,
        tokens_per_s=total_new / wall_s if wall_s > 0 else 0.0,
    )
