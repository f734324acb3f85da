"""Randomized cross-stack chaos soak: seeded fault schedules over COMPOSED
stacks, with a global invariant check per run.

The unit chaos scenarios (``tests/resilience/``, ``tests/fleet/``) each pin
one fault against one layer. The soak is the complement: for each schedule
a seed draws a random *combination* of fault rates over every injection
site the :class:`~elephas_tpu_torch.resilience.faults.FaultPlan` knows — logical
(dropped/duplicated pushes, transient errors, worker crashes) AND wire-level
(bit flips, garbage, truncation, duplication, mid-frame stalls under the
checksummed framing) — and applies it to a full training or serving stack.
Every decision is a pure function of the schedule seed, so a red schedule
replays exactly: ``run_schedule(name, seed)`` is the whole repro.

Schedules rotate through five stacks:

- ``sync-fit`` — host-path synchronous ``SparkModel.fit`` with a worker
  killed mid-partition: the task retry must make the final weights
  BIT-IDENTICAL to the fault-free run at the same seed (the sync path has
  no PS wire; recomputation is exact).
- ``async-fit`` / ``hogwild-fit`` — live socket parameter server with the
  full storm (logical + wire faults): training must finish (or die with a
  TYPED error), the weights must stay finite and bounded, and every
  destructive wire fire must be CAUGHT by the checksummed framing — never
  silently applied.
- ``fit-stream`` — streaming train-to-serve with live publication through
  a recording sink: exactly-once commits (every batch committed once, in
  order), monotone non-decreasing published versions, and — because the
  driver loop is single-threaded and every fault verdict is seeded — a
  same-seed replay must be bit-identical (weights, losses, publications).
- ``fleet-replay`` — the trace-driven serving fleet with a partition
  killed and a replacement joining mid-trace, on PAGED engines: every
  request terminal, token-identical to the undisturbed baseline run, and
  exact page accounting (``kv.check()``) at the end.

Honesty notes. Async/hogwild thread interleavings reorder PS applies, so
those stacks assert invariants (finiteness, typed failure, wire ledger),
not bit-identity — that guarantee belongs to the sync and stream stacks,
whose execution IS deterministic. And the wire ledger asserts
``fired > 0 ⇒ caught > 0`` rather than ``fired == caught``: once a
corrupt frame quarantines a connection, frames already in flight behind
it die with ordinary ``ConnectionError``s (counted as fired, caught as
generic resets), and a flipped LENGTH field surfaces as a stall rather
than a checksum mismatch. The per-fire 1:1 accounting lives in the wire
fuzz unit tests (``tests/utils/test_wire_fuzz.py``); the soak's job is
the end-to-end claim — no corrupted payload is ever APPLIED, because
every applied payload passed its CRC.

Wire-faulted stacks always set ``wire_stall_timeout_s``: a flipped length
field can otherwise park a receive forever (the reader waits for bytes
the sender never promised).

The port's soak runs without Keras or JAX: the classifier is the port's
:class:`~elephas_tpu_torch.models.adapters.KerasModelAdapter` over the
reference's Keras-3 model, written as a JSON dict, and initialized from
its own seeded generator (so its initial weights are not Keras's); the
fleet replay's parameters come from the port's ``TransformerLM.init``.
Every runner takes a trailing ``device`` (``"cuda"`` by default), where
the models, the fits and the engines run.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from .. import DeviceLike

from ..utils import sockets as socket_utils
from .faults import FaultPlan, InjectedFault, _unit
from .policy import RetryExhausted, RetryPolicy


class SoakInvariantViolation(AssertionError):
    """A soak run broke a cross-stack invariant (this is a real bug, not
    an acceptable typed failure)."""


#: Failures a schedule may legitimately end with: the fault plan made the
#: run impossible, and the stack said so with a NAMED error instead of
#: corrupting state or hanging. Anything outside this tuple fails the soak.
TYPED_FAILURES = (
    InjectedFault,
    socket_utils.FrameError,
    RetryExhausted,
    ConnectionError,
    TimeoutError,
)


def _check(condition: bool, message: str) -> None:
    if not condition:
        raise SoakInvariantViolation(message)


# -- schedule drawing ------------------------------------------------------

def draw_fault_kwargs(seed: int, scenario: str) -> Dict[str, Any]:
    """Seeded random fault-rate combination for one schedule.

    Pure function of ``(seed, scenario)`` via the same keyed hash the plan
    itself uses, so the schedule — not just the per-site verdicts — is
    pinned. Rates are kept in a band where most schedules complete and
    the rest die typed (the acceptance bar), not where every run is a
    retry-exhaustion trivially.
    """
    def rate(name: str, hi: float) -> float:
        return round(hi * _unit(seed, f"soak:{scenario}:{name}", 0), 4)

    kwargs: Dict[str, Any] = {
        "drop_push": rate("drop_push", 0.15),
        "dup_push": rate("dup_push", 0.10),
        "push_error_rate": rate("push_error", 0.10),
        "pull_error_rate": rate("pull_error", 0.05),
        "wire_flip_bits": rate("wire_flip", 0.06),
        "wire_garbage": rate("wire_garbage", 0.06),
        "wire_truncate": rate("wire_truncate", 0.04),
        "wire_duplicate": rate("wire_duplicate", 0.05),
    }
    if _unit(seed, f"soak:{scenario}:stall?", 0) < 0.3:
        kwargs["wire_stall_s"] = 0.1
        kwargs["wire_stall_prob"] = rate("wire_stall", 0.05)
    if _unit(seed, f"soak:{scenario}:crash?", 0) < 0.4:
        kwargs["crash_partition"] = int(
            _unit(seed, f"soak:{scenario}:crash_pid", 0) * 2)
        kwargs["crash_after_pushes"] = 1
    return kwargs


def _wire_ledger_check(plan: FaultPlan) -> None:
    """fired destructive wire faults ⇒ the stack caught typed frame errors
    (zero silently-applied corruption; see module docstring for why this
    is ``> 0``, not ``==``)."""
    destructive = plan.wire_fired_total()
    if destructive > 0:
        _check(
            plan.wire_caught_total() > 0,
            f"{destructive} destructive wire fault(s) fired but the stack "
            f"caught no typed FrameError — corruption may have been "
            f"silently applied (fired={dict(plan.fired)})",
        )


# -- shared fixtures (tiny, deterministic) ---------------------------------

def _toy_data(seed: int, n: int = 96, d: int = 10, c: int = 3):
    rng = np.random.default_rng(1000 + seed)
    x = rng.normal(size=(n, d)).astype("float32")
    w = rng.normal(size=(d, c))
    y = np.eye(c, dtype="float32")[(x @ w).argmax(axis=1)]
    return x, y


def _classifier(seed: int, input_dim: int = 10, nb_classes: int = 3,
                hidden: int = 6, device: DeviceLike = "cuda"):
    """The reference's Dense(relu) -> Dense(softmax) classifier, compiled
    with SGD and categorical cross-entropy, as the port's adapter over its
    Keras-3 JSON; deterministic initial weights per seed."""
    from ..models.adapters import KerasModelAdapter

    def dense(name, units, activation):
        return {"class_name": "Dense",
                "config": {"name": name, "units": units,
                           "activation": activation, "use_bias": True}}

    config = {
        "class_name": "Sequential",
        "config": {"name": "soak", "layers": [
            {"class_name": "InputLayer",
             "config": {"batch_shape": [None, input_dim]}},
            dense("dense", hidden, "relu"),
            dense("dense_1", nb_classes, "softmax"),
        ]},
        "compile_config": {"optimizer": "sgd",
                           "loss": "categorical_crossentropy"},
    }
    return KerasModelAdapter(config, seed=2000 + seed, device=device)


def _spark_context(seed: int):
    from ..data.rdd import SparkContext

    return SparkContext(master="local[4]", appName=f"soak-{seed}")


def _retry_policy() -> RetryPolicy:
    return RetryPolicy(max_attempts=6, base_delay_s=0.01, max_delay_s=0.05)


def _check_weights_sane(weights: Iterable[np.ndarray]) -> None:
    for w in weights:
        w = np.asarray(w)
        _check(bool(np.all(np.isfinite(w))), "non-finite weight after soak")
        _check(float(np.abs(w).max(initial=0.0)) < 1e3,
               "runaway weight magnitude after soak (double-apply?)")


# -- scenario runners ------------------------------------------------------

def soak_sync_fit(seed: int, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Worker killed mid-partition on the synchronous host path: the task
    retry recomputes the SAME delta, so faulted == fault-free, bitwise."""
    from ..spark_model import SparkModel
    from ..utils import to_simple_rdd

    x, y = _toy_data(seed)
    init = _classifier(seed, device=device).get_weights()
    sc = _spark_context(seed)

    def fit_once(plan: Optional[FaultPlan]) -> List[np.ndarray]:
        model = _classifier(seed, device=device)
        model.set_weights(init)
        sm = SparkModel(model, mode="synchronous", num_workers=2,
                        comm="host", fault_plan=plan, device=device)
        sm.fit(to_simple_rdd(sc, x, y), epochs=1, batch_size=16, verbose=0,
               validation_split=0.0, shuffle=False)
        return model.get_weights()

    clean = fit_once(None)
    plan = FaultPlan(seed=seed, crash_partition=int(
        _unit(seed, "soak:sync:crash_pid", 0) * 2))
    faulted = fit_once(plan)
    _check(bool(plan.fired), "the scheduled worker crash never fired")
    for w_clean, w_faulted in zip(clean, faulted):
        _check(np.array_equal(np.asarray(w_clean), np.asarray(w_faulted)),
               "sync fit diverged from the fault-free run after task retry")
    return {"fired": dict(plan.fired)}


def _soak_async(seed: int, mode: str,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The full storm against a live socket PS: logical faults through
    ``FaultyClient``, wire faults through ``FaultySocket`` under the v2
    checksummed framing, retries on top."""
    from ..spark_model import SparkModel
    from ..utils import to_simple_rdd

    x, y = _toy_data(seed)
    plan = FaultPlan(seed=seed, **draw_fault_kwargs(seed, mode))
    model = _classifier(seed, device=device)
    sc = _spark_context(seed)
    # frequency="batch": one push/pull round-trip per micro-batch, so the
    # per-frame wire fault rates get real opportunity counts (per-epoch
    # pushing would give the whole fit ~4 frames)
    sm = SparkModel(model, mode=mode, frequency="batch", num_workers=2,
                    comm="host", parameter_server_mode="socket", port=0,
                    fault_plan=plan, retry_policy=_retry_policy(),
                    wire_stall_timeout_s=2.0, ps_timeout=10.0, device=device)
    sm.fit(to_simple_rdd(sc, x, y), epochs=2, batch_size=16, verbose=0,
           validation_split=0.0, shuffle=False)
    _check_weights_sane(model.get_weights())
    _wire_ledger_check(plan)
    return {"fired": dict(plan.fired), "wire_caught": dict(plan.wire_caught)}


def soak_async_fit(seed: int, device: DeviceLike = "cuda") -> Dict[str, Any]:
    return _soak_async(seed, "asynchronous", device)


def soak_hogwild_fit(seed: int, device: DeviceLike = "cuda") -> Dict[str, Any]:
    return _soak_async(seed, "hogwild", device)


def soak_fit_stream(seed: int, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Streaming train-to-serve under the storm, twice: the driver loop is
    single-threaded and every fault verdict is seeded, so the same seed
    must reproduce the run bit-for-bit — commits, publications, weights."""
    from ..spark_model import SparkModel

    kwargs = draw_fault_kwargs(seed, "stream")
    kwargs.pop("crash_partition", None)  # no partitions in the driver loop
    kwargs.pop("crash_after_pushes", None)
    batches = [round(0.05 * (1 + (i % 5)), 3) for i in range(10)]

    def train_fn(weights, batch):
        return [w + np.float32(batch) * 1e-3 for w in weights], float(batch)

    def run_once():
        plan = FaultPlan(seed=seed, **kwargs)
        model = _classifier(seed, device=device)
        sm = SparkModel(model, mode="asynchronous",
                        parameter_server_mode="socket", port=0,
                        fault_plan=plan, retry_policy=_retry_policy(),
                        wire_stall_timeout_s=2.0, ps_timeout=10.0,
                        device=device)
        published: List[int] = []
        summary = sm.fit_stream(
            batches, train_fn,
            sink=lambda weights, version: published.append(int(version)),
            publish_every=3)
        return plan, summary, published, model.get_weights()

    plan, summary, published, weights = run_once()
    # exactly-once: every batch committed, once, in order
    _check(summary["commits"] == len(batches),
           f"{summary['commits']} commits for {len(batches)} batches")
    # committed-version monotonicity (non-decreasing: a dropped/corrupted
    # push legitimately leaves the version where it was)
    _check(published == sorted(published),
           f"published versions regressed: {published}")
    _check_weights_sane(weights)
    _wire_ledger_check(plan)

    _plan2, summary2, published2, weights2 = run_once()
    _check(published2 == published and summary2["commits"] == summary["commits"]
           and summary2["last_loss"] == summary["last_loss"],
           "same-seed stream replay diverged (commits/publications)")
    for w1, w2 in zip(weights, weights2):
        _check(np.array_equal(np.asarray(w1), np.asarray(w2)),
               "same-seed stream replay produced different weights")
    return {"fired": dict(plan.fired), "wire_caught": dict(plan.wire_caught),
            "published": published}


def soak_fleet_replay(seed: int, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Kill/join churn over a paged serving fleet mid-trace: nothing lost,
    tokens identical to the undisturbed run, page accounting exact."""
    from ..fleet import (FleetPolicy, FleetRouter, SimClock, TrafficModel,
                         run_trace)
    from ..models.transformer import TransformerLM
    from ..serving import ServingEngine

    model = TransformerLM(vocab=17, d_model=16, n_heads=4, n_layers=2,
                          d_ff=32, max_len=48, device=device)
    params = model.init(seed=1)
    trace = TrafficModel(seed=seed, base_rps=3.0, duration_s=5.0,
                         n_tenants=2, sampled_frac=0.5,
                         burst_amp=2.0).generate()
    kill_t = 0.5 + 2.0 * _unit(seed, "soak:fleet:kill_t", 0)
    chaos = [{"t": kill_t, "op": "kill", "pid": 0},
             {"t": kill_t + 0.5, "op": "join"}]

    def run(events):
        clock = SimClock()

        def factory(pid):
            return ServingEngine(model, params, n_slots=4, max_queue=8,
                                 paged=True, page_size=4, clock=clock,
                                 perf_clock=clock, device=device)

        router = FleetRouter(factory, 2, policy=FleetPolicy(), clock=clock,
                             lease_s=0.5)
        snap = run_trace(router, trace, clock=clock, step_dt=0.05,
                         chaos=events)
        for pid in router.partition_ids():
            router._engines[pid].kv.check()  # exact page accounting
        return router, snap

    base_router, _ = run(None)
    router, snap = run(chaos)
    fleet = snap["fleet"]
    _check(fleet["done"] == len(trace) and fleet["queued"] == 0,
           f"requests lost to the kill/join churn: {fleet}")
    chaos_results = router.results()
    for rid, st in base_router.results().items():
        _check(chaos_results[rid].tokens == st.tokens,
               f"stream {rid} diverged from the undisturbed run")
    return {"kill_t": round(kill_t, 3),
            "migrations": int(router.migrations),
            "requests": len(trace)}


SCENARIOS: Dict[str, Callable[..., Dict[str, Any]]] = {
    "sync-fit": soak_sync_fit,
    "async-fit": soak_async_fit,
    "hogwild-fit": soak_hogwild_fit,
    "fit-stream": soak_fit_stream,
    "fleet-replay": soak_fleet_replay,
}


# -- the soak loop ---------------------------------------------------------

def run_schedule(scenario: str, seed: int,
                 device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Run ONE seeded schedule. Returns its report; a schedule that dies
    with a member of :data:`TYPED_FAILURES` is an acceptable outcome and
    reported as such. :class:`SoakInvariantViolation` (and any untyped
    exception) propagates — that is a soak failure."""
    runner = SCENARIOS[scenario]
    base = {"scenario": scenario, "seed": seed}
    try:
        detail = runner(seed, device=device)
    except SoakInvariantViolation:
        raise
    except TYPED_FAILURES as err:
        return {**base, "outcome": f"typed:{type(err).__name__}",
                "error": str(err)[:300]}
    return {**base, "outcome": "completed", **detail}


def run_soak(n_schedules: int = 20, base_seed: int = 0,
             scenarios: Optional[Iterable[str]] = None,
             verbose: bool = False,
             device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Round-robin ``n_schedules`` seeded schedules across the scenario
    set. Never raises: invariant violations and untyped crashes land in
    ``report["failures"]`` (so one red seed does not hide the rest);
    callers assert ``not report["failures"]``."""
    names = list(scenarios) if scenarios is not None else list(SCENARIOS)
    runs: List[Dict[str, Any]] = []
    failures: List[Dict[str, Any]] = []
    for i in range(int(n_schedules)):
        scenario, seed = names[i % len(names)], base_seed + i
        try:
            run = run_schedule(scenario, seed, device=device)
            runs.append(run)
            if verbose:  # pragma: no cover - operator convenience
                print(f"[soak] {scenario} seed={seed}: {run['outcome']}")
        except Exception as err:  # noqa: BLE001 — soak collects, not dies
            failures.append({"scenario": scenario, "seed": seed,
                             "error": f"{type(err).__name__}: {err}"})
            if verbose:  # pragma: no cover
                print(f"[soak] {scenario} seed={seed}: FAILED {err}")
    return {
        "schedules": int(n_schedules),
        "completed": sum(r["outcome"] == "completed" for r in runs),
        "typed_failures": sum(
            r["outcome"].startswith("typed:") for r in runs),
        "runs": runs,
        "failures": failures,
    }
