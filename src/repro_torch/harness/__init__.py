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

The reference's analytical autotuner (``harness.tune``: ``DeviceProfile``,
``WorkloadProfile``, ``tune``) is not here: its candidate grid proposes
the dense cache layout and the bucketed scheduler, which the port serves
only from ROADMAP.md Queue 1 item 12b, and its device model is a TPU's;
an H100 profile comes with item 15.
"""
from repro_torch.harness.driver import ReplayResult, replay
from repro_torch.harness.metrics import SLO, HarnessMetrics, reduce_events
from repro_torch.harness.trace import (Trace, TraceRequest, bursty_trace,
                                       fleet_trace, load_trace,
                                       poisson_trace, save_trace,
                                       scripted_trace, shared_prefix_trace)

__all__ = [
    "SLO", "HarnessMetrics", "ReplayResult", "Trace", "TraceRequest",
    "bursty_trace", "fleet_trace", "load_trace", "poisson_trace",
    "reduce_events", "replay", "save_trace", "scripted_trace",
    "shared_prefix_trace",
]
