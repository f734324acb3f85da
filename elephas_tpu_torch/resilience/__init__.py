"""Resilience subsystem: failure as a first-class, testable input.

The paper's asynchronous/hogwild modes make worker failure and staleness a
*normal* operating condition (DeepSpark, arxiv 1602.08191, scales commodity
clusters only by tolerating stragglers and partial failure; SparkNet, arxiv
1511.06051, leans on iterative re-execution). This package makes that
condition injectable, policed, and recoverable across BOTH pipelines:

- :mod:`~elephas_tpu_torch.resilience.faults` — ``FaultPlan``: a seeded,
  deterministic fault-injection layer. It wraps parameter clients
  (``FaultyClient``: dropped/duplicated pushes, delayed pulls, transient
  socket errors, crash-after-N-pushes), worker partitions
  (``maybe_crash_partition``: kill a worker mid-partition, once), compiled
  fit chunks (``tick``), parameter servers (server-side drop hooks), and
  serving steps (deterministic clock stalls that push requests past their
  deadlines). Same seed → same faults, so chaos scenarios are pinnable
  tests, not flakes.
- :mod:`~elephas_tpu_torch.resilience.policy` — composable ``RetryPolicy``
  (exponential backoff + deterministic jitter, attempt caps, deadlines)
  and ``CircuitBreaker`` (closed → open → half-open), plus
  ``ResilientClient``, which routes any
  :class:`~elephas_tpu_torch.parameter.client.BaseParameterClient`'s pulls and
  pushes through both.
- :mod:`~elephas_tpu_torch.resilience.soak` — the randomized cross-stack chaos
  soak: each seeded schedule draws a random COMBINATION of fault rates
  (logical + wire-level under the checksummed socket framing) and applies
  it to a composed stack — sync/async/hogwild fit, streaming
  train-to-serve, the trace-driven fleet — with a global invariant check
  per run (``run_soak``; pinned in ``tests/resilience/test_soak.py``).
- :mod:`~elephas_tpu_torch.resilience.supervisor` — ``TrainingSupervisor``:
  wraps ``SparkModel.fit`` with periodic checkpointing
  (:mod:`elephas_tpu_torch.utils.checkpoint`) and auto-resume from the latest
  VALID checkpoint after a crash, bounded by ``max_restarts``. Task-level
  failures stay with the existing stage-scoped exactly-once machinery
  (``worker.py`` / ``parameter/client.py``); the supervisor handles the
  layer above it — whole-fit death.

Serving-side resilience (per-request deadlines, ``cancel(request_id)``,
O(1) slot reclamation on timeout, bounded result retention) lives in
:mod:`elephas_tpu_torch.serving.engine`; the chaos scenarios for all of it are
pinned in ``tests/resilience/``.

The port's package (``elephas_tpu/resilience`` ported to PyTorch) keeps
the reference's ``__all__``; the soak's runners take a trailing
``device``.
"""

from .faults import (
    FaultPlan,
    FaultyClient,
    InjectedFault,
    InjectedWorkerCrash,
    TransientFault,
)
from .membership import (
    HeartbeatRegistry,
    MembershipEvent,
    QuorumLostError,
    QuorumRunner,
    member_id_for,
)
from .policy import (
    CircuitBreaker,
    CircuitOpenError,
    FailoverClient,
    ResilientClient,
    RetryExhausted,
    RetryPolicy,
    default_is_transient,
)
from .soak import (
    SCENARIOS,
    SoakInvariantViolation,
    draw_fault_kwargs,
    run_schedule,
    run_soak,
)
from .supervisor import SupervisorAborted, SupervisorEvent, TrainingSupervisor

__all__ = [
    "SCENARIOS",
    "SoakInvariantViolation",
    "draw_fault_kwargs",
    "run_schedule",
    "run_soak",
    "CircuitBreaker",
    "CircuitOpenError",
    "FailoverClient",
    "FaultPlan",
    "FaultyClient",
    "HeartbeatRegistry",
    "InjectedFault",
    "InjectedWorkerCrash",
    "MembershipEvent",
    "QuorumLostError",
    "QuorumRunner",
    "ResilientClient",
    "RetryExhausted",
    "RetryPolicy",
    "SupervisorAborted",
    "SupervisorEvent",
    "TrainingSupervisor",
    "default_is_transient",
    "member_id_for",
]
