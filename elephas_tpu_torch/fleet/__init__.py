"""SLO-aware multi-tenant serving fleet: a control plane over N
:class:`~elephas_tpu_torch.serving.engine.ServingEngine` partitions.

- :mod:`~elephas_tpu_torch.fleet.traffic` — seeded trace-driven load
  generation (bursty diurnal arrivals, heavy-tailed lengths, Zipf
  tenant skew) and the :class:`SimClock` replay drives.
- :mod:`~elephas_tpu_torch.fleet.policy` — fleet admission: priority tiers,
  per-tenant deficit-round-robin fairness, rate limits, deadline
  shedding.
- :mod:`~elephas_tpu_torch.fleet.router` — membership-governed placement,
  bitwise-identical in-flight migration on partition death, fleet
  ``snapshot()`` (p50/p99 TTFT + ITL, SLO attainment, per-tenant
  accounting), weight-rollover fan-out, and the :func:`run_trace`
  replay harness.
- :mod:`~elephas_tpu_torch.fleet.autoscaler` — grow/shrink the fleet against
  queue depth and deadline-miss rate on the injectable clock.

The port's package keeps the reference's ``__all__``.
"""

from .autoscaler import Autoscaler
from .policy import FleetPolicy
from .router import FleetRouter, router_sink, run_trace
from .traffic import SimClock, Trace, TraceRequest, TrafficModel

__all__ = [
    "Autoscaler",
    "FleetPolicy",
    "FleetRouter",
    "router_sink",
    "run_trace",
    "SimClock",
    "Trace",
    "TraceRequest",
    "TrafficModel",
]
