"""Trace-driven load harness of the port (the reference's ``harness``).

* ``harness.trace``   — seeded synthetic request traces (Poisson, bursty,
  shared-prefix, multi-model fleet) with a versioned on-disk format, so
  every benchmark replays the exact same request sequence; byte-identical
  to the reference's for the same generator, arguments and seed.
* ``harness.driver``  — replay any trace against a configured
  ``ServingEngine`` via the engine's structured lifecycle events.
* ``harness.metrics`` — reduce lifecycle events to SLO metrics: TTFT and
  ITL p50/p99, goodput under an SLO, peak concurrency, preemption and
  prefix-hit counts.  Step-based metrics are bit-reproducible.
* ``harness.tune``    — the analytical autotuner (``DeviceProfile``,
  ``WorkloadProfile``, ``tune``, ``naive_default``): ranks runtime specs
  on an H100's figures before any engine is built
  (``RuntimeSpec.tuned``, ``serve --tuned``).
"""
from repro_torch.harness.driver import ReplayResult, replay
from repro_torch.harness.metrics import SLO, HarnessMetrics, reduce_events
from repro_torch.harness.trace import (Trace, TraceRequest, bursty_trace,
                                       fleet_trace, load_trace,
                                       poisson_trace, save_trace,
                                       scripted_trace, shared_prefix_trace)
from repro_torch.harness.tune import (DeviceProfile, WorkloadProfile,
                                      naive_default, tune)

__all__ = [
    "SLO", "DeviceProfile", "HarnessMetrics", "ReplayResult", "Trace",
    "TraceRequest", "WorkloadProfile", "bursty_trace",
    "fleet_trace", "load_trace", "naive_default", "poisson_trace",
    "reduce_events", "replay", "save_trace", "scripted_trace",
    "shared_prefix_trace", "tune",
]
