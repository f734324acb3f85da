"""The port's resilience package (``elephas_tpu_torch/resilience``), the
engine's ``fault_plan`` and ``SparkModel``'s fault and membership options
against the JAX package's on the CPU.

- ``FaultPlan``: ``_unit`` and every fire schedule (client pushes and pulls,
  crash sites, ticks, host sites, serving stalls, the wire's byte-level
  sites on a recording socket) equal the reference's for the same seed;
  ``FaultyClient`` over a recording client makes the same calls.
- ``RetryPolicy``, ``CircuitBreaker``, ``ResilientClient`` and
  ``FailoverClient`` on fake clocks: the same delays, sleeps, states,
  failovers and registry events.
- ``HeartbeatRegistry`` over one script of joins, beats, expiries and
  observations: the same snapshots; ``QuorumRunner`` with dead partitions:
  the same committed subset and rounds.
- Fits, the same Keras model and weights in both packages: the synchronous
  host fit with 1 of 4 partitions dead and quorum 3 (the reference's
  ``tests/resilience/test_quorum.py`` scenario at 4 workers), the compiled path with an
  expired member masked out of the merges (``worker_valid``), and a
  ``TrainingSupervisor`` crash at the second compiled fit chunk resumed from
  the checkpoint; weights within atol 1e-6 + rtol 1e-5 (the host-fit pin)
  and 1e-5 on the compiled path (the engine pin).
- The host path's chaos: a dropped push, a crashed partition and a
  straggler whose backup wins with exactly one attempt's pushes applied;
  a hot-standby http and socket server whose primary is killed mid-fit
  (no committed update lost).
- The engine's ``fault_plan``: an injected stall pushes the same request
  past its deadline as in the reference's engine, with the other greedy
  streams unchanged.
- The soak: the reference's tier-1 share of ``tests/resilience/test_soak.py``
  and one schedule of each deterministic stack.

Every server binds port 0; the global generators are restored after each
test.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import threading

import jax.numpy as jnp
import keras
import numpy as np
import pytest

from elephas_tpu import SparkModel as JSparkModel
from elephas_tpu import resilience as JR
from elephas_tpu.data import SparkContext as JSparkContext
from elephas_tpu.resilience import faults as jfaults
from elephas_tpu.resilience import soak as jsoak
from elephas_tpu.utils import to_simple_rdd as j_to_simple_rdd
from elephas_tpu_torch import SparkModel
from elephas_tpu_torch import resilience as TR
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.parallel import engine as port_engine
from elephas_tpu_torch.resilience import faults as tfaults
from elephas_tpu_torch.resilience import soak as tsoak
from elephas_tpu_torch.utils import to_simple_rdd

from .conftest import make_classifier
from .test_torch_host_fit import restore_global_rngs  # noqa: F401 (autouse)
from .test_torch_spark_model import _jax_permutation

ATOL, RTOL = 1e-6, 1e-5
PACKAGES = {"reference": JR, "port": TR}


class Ctx:
    """A task context as the plan reads it."""

    def __init__(self, pid, attempt=0):
        self.pid, self.attempt = pid, attempt

    def partitionId(self):
        return self.pid

    def attemptNumber(self):
        return self.attempt


class RecordingSocket:
    def __init__(self):
        self.sent, self.closed = [], False

    def sendall(self, data):
        self.sent.append(bytes(data))

    def shutdown(self, how):
        pass

    def close(self):
        self.closed = True


# -- fault plans ---------------------------------------------------------------

PLANS = [
    dict(drop_push=0.3, dup_push=0.2, push_error_rate=0.1, pull_error_rate=0.15,
         pull_delay_s=0.5, pull_delay_prob=0.4),
    dict(crash_partition=1, crash_after_pushes=3, crash_sites={"fit_chunk": 2, "x": 0},
         dead_partitions=[4], straggler_stalls={2: 1.5}, server_drop_push=0.25,
         serving_stalls={3: 2.0}, kill_hosts={2: 1}, partition_hosts={3: 0},
         join_delay_rounds={5: 2}),
    dict(wire_flip_bits=0.2, wire_truncate=0.1, wire_garbage=0.15, wire_duplicate=0.2,
         wire_stall_s=0.25, wire_stall_prob=0.3),
]


def _schedule(R, seed, kw):
    sleeps = []
    plan = R.FaultPlan(seed, sleep=sleeps.append, **kw)
    log = []
    for _ in range(40):
        try:
            plan.pull_fault()
            log.append("pull")
        except R.TransientFault:
            log.append("pull-error")
        try:
            log.append(plan.push_fault())
        except R.TransientFault:
            log.append("push-error")
        log.append(plan.drop_server_push())
    for pid, attempt in [(1, 0)] * 5 + [(1, 1), (4, 0), (4, 1), (2, 0), (2, 1)]:
        for hook in (plan.record_push, plan.maybe_crash_partition, plan.straggler_stall):
            try:
                hook(Ctx(pid, attempt))
                log.append((hook.__name__, pid, attempt, "ok"))
            except R.InjectedWorkerCrash:
                log.append((hook.__name__, pid, attempt, "crash"))
    for site in ["fit_chunk"] * 4 + ["x", "x"]:
        try:
            plan.tick(site)
            log.append(("tick", site))
        except R.InjectedWorkerCrash:
            log.append(("tick-crash", site))
    log += [(plan.host_kill(r), plan.host_partition(r), plan.join_delay(r),
             plan.serving_stall(r)) for r in range(6)]
    sock = RecordingSocket()
    for n in range(30):
        plan.wire_send(sock, bytes(range(n % 7, n % 7 + 40)), f"site{n % 2}")
        plan.wire_send(sock, b"g", "site0")          # control bytes pass
    return (log, sleeps, sock.sent, sock.closed, dict(plan.fired),
            plan.wire_fired_total(), plan.has_wire_faults())


@pytest.mark.parametrize("kw", PLANS, ids=["client", "crash-sites", "wire"])
@pytest.mark.parametrize("seed", [0, 7])
def test_fault_plan_fire_schedules_match_reference(seed, kw):
    assert [tfaults._unit(seed, s, n) for s in ("a", "drop_push") for n in range(20)] == \
        [jfaults._unit(seed, s, n) for s in ("a", "drop_push") for n in range(20)]
    got, want = _schedule(TR, seed, kw), _schedule(JR, seed, kw)
    assert got == want
    assert got[4] or got[0]            # something fired


class RecordingClient:
    def __init__(self):
        self.calls = []

    def get_parameters(self):
        self.calls.append("pull")
        return [np.zeros(2, np.float32)]

    def update_parameters(self, delta):
        self.calls.append(("push", float(delta[0][0])))

    def update_parameters_tagged(self, task_id, delta, attempt=None):
        self.calls.append(("tagged", task_id, float(delta[0][0]), attempt))

    def get_version(self):
        return len(self.calls)

    def register_attempt(self, task_id, attempt):
        self.calls.append(("register", task_id, attempt))
        return True

    def commit_attempt(self, task_id):
        self.calls.append(("commit", task_id))

    def close(self):
        self.calls.append("close")


def test_faulty_client_makes_the_reference_calls():
    from elephas_tpu.data import TaskContext as JCtx
    from elephas_tpu_torch.data import TaskContext as TCtx

    out = []
    for R, TaskContext in ((JR, JCtx), (TR, TCtx)):
        inner = RecordingClient()
        plan = R.FaultPlan(3, drop_push=0.3, dup_push=0.3, push_error_rate=0.1,
                           pull_error_rate=0.1, crash_partition=0, crash_after_pushes=6)
        client = R.FaultyClient(inner, plan)
        TaskContext._set(TaskContext(0, 0, 0))
        log = []
        try:
            for i in range(12):
                for op in (client.get_parameters,
                           lambda: client.update_parameters([np.full(2, i, np.float32)]),
                           lambda: client.update_parameters_tagged(
                               "t", [np.full(2, -i, np.float32)], attempt=0)):
                    try:
                        op()
                        log.append("ok")
                    except R.TransientFault:
                        log.append("transient")
                    except R.InjectedWorkerCrash:
                        log.append("crash")
        finally:
            TaskContext._set(None)
        client.register_attempt("t", 1), client.commit_attempt("t"), client.close()
        out.append((inner.calls, log, dict(plan.fired), client.get_version()))
    assert out[1] == out[0]
    assert "crash" in out[1][1] and "transient" in out[1][1]


# -- policies ------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _policies(R):
    clock = FakeClock()
    policy = R.RetryPolicy(max_attempts=6, base_delay_s=0.1, max_delay_s=0.5, jitter=0.4,
                           seed=9, deadline_s=2.0, sleep=clock.sleep, clock=clock)
    log = [round(policy.delay(k), 12) for k in range(8)]
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] % 4:
            raise ConnectionError("blip")
        return calls["n"]

    for _ in range(3):
        try:
            log.append(("ok", policy.call(flaky)))
        except R.RetryExhausted as e:
            log.append(("exhausted", str(e)))
    try:
        policy.call(lambda: (_ for _ in ()).throw(ValueError("bug")))
    except ValueError:
        log.append("not-transient")
    breaker = R.CircuitBreaker(failure_threshold=2, reset_timeout_s=1.0, clock=clock)
    for ok in (False, False, True, None, False, None, True, True):
        if ok is None:
            clock.t += 1.5
            log.append(breaker.state)
            continue
        try:
            breaker.call((lambda: 1) if ok else (lambda: 1 / 0))
            log.append(("call", breaker.state))
        except ZeroDivisionError:
            log.append(("fail", breaker.state))
        except R.CircuitOpenError:
            log.append(("open", breaker.state))
    inner = RecordingClient()
    flips = iter([True, False, False, True] * 10)

    class Flaky(RecordingClient):
        def get_parameters(self):
            if next(flips):
                raise ConnectionError("reset")
            return super().get_parameters()

    inner = Flaky()
    resilient = R.ResilientClient(
        inner, policy=R.RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0),
        breaker=R.CircuitBreaker(failure_threshold=5, clock=clock))
    for _ in range(4):
        resilient.get_parameters()
    resilient.update_parameters_tagged("t", [np.ones(2, np.float32)], attempt=2)
    log += [inner.calls, round(clock.t, 9), R.default_is_transient(OSError()),
            R.default_is_transient(KeyError())]
    return log


def test_retry_breaker_and_resilient_client_match_reference():
    assert _policies(TR) == _policies(JR)


def _failover(R):
    clock = FakeClock()
    registry = R.HeartbeatRegistry(lease_s=10.0, clock=clock)

    class Endpoint(RecordingClient):
        def __init__(self, name, dies_after=None, version=0):
            super().__init__()
            self.name, self.dies_after, self.version = name, dies_after, version
            self.last_seen_version = -1

        def _op(self):
            if self.dies_after is not None and len(self.calls) >= self.dies_after:
                raise ConnectionError(f"{self.name} down")

        def get_parameters(self):
            self._op()
            self.version += 1
            self.last_seen_version = self.version
            return super().get_parameters()

        def get_version(self):
            self._op()
            return self.version

    primary, standby = Endpoint("p", dies_after=3), Endpoint("s", version=1)
    client = R.FailoverClient([primary, standby], registry=registry, staleness_wait_s=0.3,
                              poll_s=0.1, sleep=clock.sleep, clock=clock)
    got = [len(client.get_parameters()) for _ in range(6)]
    client.update_parameters([np.ones(2, np.float32)])
    snap = registry.snapshot()
    return (got, client.failovers, client.active_endpoint, primary.calls, standby.calls,
            round(clock.t, 9), snap["counters"], [e for e in snap["events"]])


def test_failover_client_matches_reference():
    got, want = _failover(TR), _failover(JR)
    assert got == want and got[1] == 1 and got[2] == 1


# -- membership ----------------------------------------------------------------


def _registry_script(R):
    clock = FakeClock()
    seen = []
    reg = R.HeartbeatRegistry(lease_s=2.0, straggler_after_s=0.5, clock=clock,
                              on_event=lambda e: seen.append(e.to_dict()), max_events=8)
    out = [reg.join("a"), reg.join("b")]
    reg.heartbeat("c")
    clock.t = 0.7
    reg.heartbeat("a")
    out += [reg.stragglers(), reg.live(), reg.is_live("zz", default=True)]
    clock.t = 2.1
    out += [reg.sweep(), reg.live(), reg.fence("b"), reg.epoch]
    reg.expire("a"), reg.leave("zz"), reg.join("b")
    reg.observe_backup("c", 1), reg.observe_failover(endpoint=1, version=4)
    reg.observe_late_reject("b", launch_epoch=1)
    reg.observe_round(expected=4, received=3, quorum=3, backups=1, deadline_hit=True)
    out += [reg.snapshot(), seen, R.member_id_for(7)]
    return out


def test_heartbeat_registry_matches_reference():
    assert _registry_script(TR) == _registry_script(JR)


def _quorum_round(R, TaskContext):
    registry = R.HeartbeatRegistry(lease_s=60.0, clock=lambda: 0.0)
    plan = R.FaultPlan(seed=3, dead_partitions=[2, 5], crash_partition=1)
    runner = R.QuorumRunner(registry, quorum=6, max_failures=3, poll_s=0.005)

    def task(it):
        ctx = TaskContext.get()
        rows = list(it)
        plan.maybe_crash_partition(ctx)
        yield (ctx.partitionId(), ctx.attemptNumber(), sum(rows))

    committed = runner.run([list(range(p, p + 5)) for p in range(8)], task, stage_id=4)
    snap = registry.snapshot()
    out = (committed, dict(plan.fired), snap["rounds"], snap["membership"]["live"],
           sorted(snap["membership"]["fences"]))
    lost = R.QuorumRunner(R.HeartbeatRegistry(lease_s=60.0, clock=lambda: 0.0), quorum=8,
                          max_failures=2, poll_s=0.005)
    with pytest.raises(R.QuorumLostError):
        lost.run([[1]] * 8, task, stage_id=5)
    return out


def test_quorum_runner_matches_reference():
    from elephas_tpu.data import TaskContext as JCtx
    from elephas_tpu_torch.data import TaskContext as TCtx

    got, want = _quorum_round(TR, TCtx), _quorum_round(JR, JCtx)
    assert got == want
    assert sorted(got[0]) == [0, 1, 3, 4, 6, 7] and got[0][1] == [(1, 1, 15)]


# -- fits ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def quorum_data():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(400, 10)).astype("float32")
    y = np.eye(3, dtype="float32")[(x @ rng.normal(size=(10, 3))).argmax(axis=1)]
    return x, y


def _pair_models(hidden=8, optimizer="sgd"):
    keras.utils.set_random_seed(5)
    jm = make_classifier(hidden=hidden, optimizer=optimizer)
    tm = make_classifier(hidden=hidden, optimizer=optimizer)
    tm.set_weights(jm.get_weights())
    return jm, tm


def _close(got, want, atol=ATOL, rtol=RTOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def test_sync_quorum_host_fit_matches_reference(quorum_data):
    """Partition 2 dies on every attempt (two attempts a task); quorum 3 of
    4 commits the received deltas in both packages, to the host-fit pin
    (the reference's scenario, 2 of 8 dead at quorum 6, at 4 workers)."""
    from elephas_tpu.data import SparkConf as JSparkConf
    from elephas_tpu_torch.data import SparkConf

    x, y = quorum_data
    x, y = x[:200], y[:200]
    jm, tm = _pair_models()
    fits, snaps = [], []
    for SM, R, sc, conf, rdd_of, model, extra in (
            (JSparkModel, JR, JSparkContext, JSparkConf, j_to_simple_rdd, jm, {}),
            (SparkModel, TR, SparkContext, SparkConf, to_simple_rdd, tm, {"device": "cpu"})):
        plan = R.FaultPlan(seed=3, dead_partitions=[2])
        sm = SM(model, mode="synchronous", num_workers=4, comm="host", fault_plan=plan,
                membership=R.HeartbeatRegistry(lease_s=120.0, clock=lambda: 0.0),
                quorum=3, **extra)
        context = sc(conf=conf().setMaster("local[4]").set("spark.task.maxFailures", 2))
        sm.fit(rdd_of(context, x, y), epochs=1, batch_size=16, verbose=0,
               validation_split=0.0, shuffle=False)
        assert any(k.startswith("dead-partition-") for k in plan.fired)
        fits.append(sm.master_network.get_weights())
        snap = sm.membership_snapshot()
        snaps.append((snap["rounds"], snap["membership"]["live"],
                      sorted(snap["membership"]["fences"])))
    _close(fits[1], fits[0])
    assert snaps[1] == snaps[0]
    assert snaps[1][0][-1]["received"] == 3 and "partition-2" not in snaps[1][1]


def test_compiled_membership_mask_fit_matches_reference(quorum_data, monkeypatch):
    """An expired member is masked out of every merge on the compiled path
    (``worker_valid``); the fit equals the reference's with the same mask."""
    monkeypatch.setattr(port_engine, "epoch_permutation", _jax_permutation)
    x, y = quorum_data
    jm, tm = _pair_models(optimizer="adam")
    out = []
    for SM, R, sc, rdd_of, model, extra in (
            (JSparkModel, JR, JSparkContext, j_to_simple_rdd, jm, {}),
            (SparkModel, TR, SparkContext, to_simple_rdd, tm, {"device": "cpu"})):
        registry = R.HeartbeatRegistry(lease_s=120.0, clock=lambda: 0.0)
        sm = SM(model, mode="synchronous", num_workers=4, comm="jax",
                membership=registry, quorum=2, **extra)
        assert sm._membership_mask(4) is None
        registry.join("partition-3")
        registry.expire("partition-3")
        assert sm._membership_mask(4) == [1.0, 1.0, 1.0, 0.0]
        sm.fit(rdd_of(sc("local[4]"), x[:200], y[:200]), epochs=2, batch_size=16,
               verbose=0, validation_split=0.0)
        out.append((sm.master_network.get_weights(), sm.training_histories[-1]["loss"]))
        for pid in (1, 2):
            registry.join(f"partition-{pid}")
            registry.expire(f"partition-{pid}")
        with pytest.raises(R.QuorumLostError):
            sm._membership_mask(4)
    _close(out[1][0], out[0][0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out[1][1], out[0][1], atol=1e-5, rtol=1e-5)


def test_supervisor_resume_matches_reference(quorum_data, tmp_path, monkeypatch):
    """The second compiled fit chunk crashes once; the supervisor resumes from
    the latest checkpoint, and the resumed fit equals the reference's
    supervised fit and the port's uninterrupted one (synchronous+epoch
    carries the replica stacks, so the chunks merge as one fit)."""
    monkeypatch.setattr(port_engine, "epoch_permutation", _jax_permutation)
    x, y = quorum_data
    jm, tm = _pair_models(optimizer="adam")
    w0 = [np.array(w) for w in tm.get_weights()]
    out = []
    for name, SM, R, sc, rdd_of, model, extra in (
            ("ref", JSparkModel, JR, JSparkContext, j_to_simple_rdd, jm, {}),
            ("port", SparkModel, TR, SparkContext, to_simple_rdd, tm, {"device": "cpu"})):
        plan = R.FaultPlan(seed=0, crash_sites={"fit_chunk": 1})
        sm = SM(model, mode="synchronous", num_workers=4, fault_plan=plan, **extra)
        sup = R.TrainingSupervisor(sm, str(tmp_path / name), checkpoint_frequency=1,
                                   max_restarts=2)
        sup.fit(rdd_of(sc("local[4]"), x[:128], y[:128]), epochs=2, batch_size=16,
                verbose=0, validation_split=0.0)
        out.append(([e.kind for e in sup.events], sup.restarts,
                    sm.master_network.get_weights()))
    assert out[1][:2] == out[0][:2] == (["start", "crash", "resume", "complete"], 1)
    _close(out[1][2], out[0][2], atol=1e-5, rtol=1e-5)
    plain = SparkModel(make_classifier(hidden=8, optimizer="adam"), mode="synchronous",
                       num_workers=4, device="cpu")
    plain.master_network.set_weights(w0)
    plain.fit(to_simple_rdd(SparkContext("local[4]"), x[:128], y[:128]), epochs=2,
              batch_size=16, verbose=0, validation_split=0.0)
    _close(out[1][2], plain.master_network.get_weights(), atol=1e-6, rtol=1e-5)


def test_host_supervisor_chunks_match_reference(quorum_data, tmp_path):
    """The supervisor chunks a host fit itself (weights + epoch are the
    state): the same checkpoints and weights as the reference's."""
    from elephas_tpu.utils.checkpoint import load_checkpoint as jload
    from elephas_tpu_torch.utils.checkpoint import load_checkpoint as tload

    x, y = quorum_data
    jm, tm = _pair_models()
    out = []
    for name, SM, R, sc, rdd_of, model, load, extra in (
            ("ref", JSparkModel, JR, JSparkContext, j_to_simple_rdd, jm, jload, {}),
            ("port", SparkModel, TR, SparkContext, to_simple_rdd, tm, tload,
             {"device": "cpu"})):
        sm = SM(model, mode="synchronous", num_workers=2, comm="host", **extra)
        sup = R.TrainingSupervisor(sm, str(tmp_path / name), checkpoint_frequency=1)
        sup.fit(rdd_of(sc("local[2]"), x[:160], y[:160]), epochs=2, batch_size=16,
                verbose=0, validation_split=0.0, shuffle=False)
        weights, meta, _ = load(str(tmp_path / name))
        out.append((meta, weights, [e.kind for e in sup.events]))
    assert out[1][0] == out[0][0] == {"epoch": 2, "epochs": 2, "mode": "synchronous"}
    assert out[1][2] == out[0][2]
    _close(out[1][1], out[0][1])


# -- the host path's chaos -----------------------------------------------------


def test_host_chaos_fit_under_a_fault_plan(quorum_data):
    """Asynchronous socket fit with a dropped push, a crashed partition (its
    retry rolls the attempt back) and duplicated pushes, through retries:
    training completes with finite weights and a falling loss, and the
    crash fired."""
    x, y = quorum_data
    tm = _pair_models()[1]
    sm = SparkModel(tm, mode="asynchronous", num_workers=4, comm="host",
                    parameter_server_mode="socket", port=0, device="cpu",
                    fault_plan=TR.FaultPlan(seed=1, drop_push=0.2, dup_push=0.1,
                                            crash_partition=2, crash_after_pushes=1),
                    retry_policy=TR.RetryPolicy(max_attempts=4, base_delay_s=0.0,
                                                jitter=0.0))
    before = sm.evaluate(x, y)[0]
    sm.fit(to_simple_rdd(SparkContext("local[4]"), x, y), epochs=2, batch_size=16,
           verbose=0, validation_split=0.0, shuffle=False)
    assert "crash-partition-2" in sm.fault_plan.fired
    assert "drop_push" not in sm.fault_plan.fired     # rates count, never "fire"
    for w in sm.master_network.get_weights():
        assert np.all(np.isfinite(w)) and np.abs(w).max() < 1e3
    assert sm.evaluate(x, y)[0] < before
    ps = sm.membership_snapshot()["parameter_servers"]["primary"]
    assert ps["applied_tagged"]


def test_straggler_backup_wins_and_server_applies_winner_only(quorum_data):
    """Partition 1 stalls before it registers; the registry flags its
    silence and a backup (attempt 1) races ahead; the server applies exactly
    the winner's pushes for that task, whenever the zombie wakes."""
    x, y = quorum_data
    tm = _pair_models()[1]
    release = threading.Event()
    plan = TR.FaultPlan(seed=7, straggler_stalls={1: 30.0}, sleep=lambda s: release.wait(s))
    registry = TR.HeartbeatRegistry(lease_s=120.0, straggler_after_s=1.0)
    sm = SparkModel(tm, mode="asynchronous", frequency="batch", num_workers=4, comm="host",
                    parameter_server_mode="http", port=0, fault_plan=plan,
                    membership=registry, device="cpu",
                    retry_policy=TR.RetryPolicy(max_attempts=2, base_delay_s=0.01,
                                                max_delay_s=0.02))
    try:
        sm.fit(to_simple_rdd(SparkContext("local[4]"), x[:200], y[:200]), epochs=1,
               batch_size=16, verbose=0, validation_split=0.0, shuffle=False)
    finally:
        release.set()
    assert "straggle-partition-1" in plan.fired
    snap = sm.membership_snapshot()
    assert snap["counters"].get("backup", 0) >= 1
    applied = snap["parameter_servers"]["primary"]["applied_tagged"]
    assert [v for k, v in applied.items() if k.endswith("partition-1")] == [3]


@pytest.mark.parametrize("ps_mode", ["http", "socket"])
def test_training_survives_primary_ps_kill(quorum_data, ps_mode):
    """The primary dies at its 13th request; clients fail over to the hot
    standby, training completes, and the standby holds every update the
    primary committed (over http, whose pushes are acknowledged, its
    version is the total pushes)."""
    x, y = quorum_data
    tm = _pair_models()[1]
    plan = TR.FaultPlan(seed=5, crash_sites={"kill-primary": 12})
    registry = TR.HeartbeatRegistry(lease_s=120.0)
    sm = SparkModel(tm, mode="asynchronous", num_workers=4, comm="host",
                    parameter_server_mode=ps_mode, port=0, fault_plan=plan,
                    membership=registry, hot_standby=True, device="cpu",
                    retry_policy=TR.RetryPolicy(max_attempts=4, base_delay_s=0.01,
                                                max_delay_s=0.05))
    before = sm.evaluate(x[:200], y[:200])[0]
    sm.fit(to_simple_rdd(SparkContext("local[4]"), x[:200], y[:200]), epochs=2,
           batch_size=16, verbose=0, validation_split=0.0, shuffle=False)
    assert "kill-primary" in plan.fired
    snap = sm.membership_snapshot()
    assert snap["counters"]["failovers"] >= 1
    ps = snap["parameter_servers"]
    assert ps["primary"]["version"] > 0
    assert ps["standby"]["version"] >= ps["primary"]["version"]
    if ps_mode == "http":       # every push is acknowledged: none is lost
        assert ps["standby"]["version"] == 8      # 4 workers x 2 epochs
    else:
        # a socket push is not acknowledged: one sent to the dying primary
        # is lost in both packages (the reference's standby also ends below
        # 8 on this scenario, ROADMAP §3), never applied twice
        assert ps["standby"]["version"] <= 8
    assert ps["primary"]["replication_errors"] == 0
    assert sm.evaluate(x[:200], y[:200])[0] < before


# -- the engine's fault plan ---------------------------------------------------


class TickingClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_engine_stall_pushes_the_reference_requests_past_deadlines():
    from elephas_tpu.models.transformer import TransformerLM as JaxLM
    from elephas_tpu.serving import ServingEngine as JaxEngine
    from elephas_tpu_torch.models import TransformerLM, from_jax_params
    from elephas_tpu_torch.serving import ServingEngine

    cfg = dict(vocab=17, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=48)
    jm = JaxLM(**cfg)
    np_params = {k: np.asarray(v) for k, v in jm.init(seed=1).items()}
    sides = [(JaxEngine, jm, {k: jnp.asarray(v) for k, v in np_params.items()}, JR, {}),
             (ServingEngine, TransformerLM(**cfg, device="cpu"),
              from_jax_params(np_params, device="cpu"), TR, {"device": "cpu"})]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 17, size=(t,)).astype(np.int32) for t in (4, 6, 5, 7)]
    out = []
    for Eng, model, params, R, extra in sides:
        plan = R.FaultPlan(seed=0, serving_stalls={4: 1000.0, 9: 30.0})
        eng = Eng(model, params, n_slots=2, clock=TickingClock(), fault_plan=plan,
                  fuse_k=4, **extra)
        ids = [eng.submit(prompts[0], 8, deadline_s=100.0),
               eng.submit(prompts[1], 8),
               eng.submit(prompts[2], 8, deadline_s=1500.0),
               eng.submit(prompts[3], 6, deadline_s=1040.0)]
        fin = eng.drain(max_steps=500)
        out.append([(fin[r].finish_reason, fin[r].tokens, fin[r].timing.finished_at)
                    for r in ids] + [eng.snapshot()["counters"]["cancelled"],
                                     eng.kv.active_slots])
    assert out[1] == out[0]
    assert [r[0] for r in out[1][:4]].count("deadline") >= 1


# -- the soak ------------------------------------------------------------------


def test_soak_harness_matches_reference(monkeypatch):
    for seed in (0, 3, 8):
        for scenario in ("asynchronous", "hogwild", "stream"):
            assert tsoak.draw_fault_kwargs(seed, scenario) == \
                jsoak.draw_fault_kwargs(seed, scenario)
    a = tsoak.draw_fault_kwargs(3, "asynchronous")
    assert any(tsoak.draw_fault_kwargs(s, "asynchronous") != a for s in range(4, 9))
    assert list(tsoak.SCENARIOS) == list(jsoak.SCENARIOS)
    plan = TR.FaultPlan(seed=0, wire_garbage=0.5)
    plan.fired["wire_garbage:client"] = 3
    with pytest.raises(TR.SoakInvariantViolation, match="silently applied"):
        tsoak._wire_ledger_check(plan)
    plan.wire_caught["server:CorruptFrameError"] = 1
    tsoak._wire_ledger_check(plan)

    def dies_typed(seed, device="cuda"):
        raise ConnectionError("server never came back")

    def dies_untyped(seed, device="cuda"):
        raise ValueError("this is a real bug")

    monkeypatch.setitem(tsoak.SCENARIOS, "dies-typed", dies_typed)
    monkeypatch.setitem(tsoak.SCENARIOS, "dies-untyped", dies_untyped)
    assert tsoak.run_schedule("dies-typed", 0, device="cpu")["outcome"] == \
        "typed:ConnectionError"
    with pytest.raises(ValueError, match="real bug"):
        tsoak.run_schedule("dies-untyped", 0, device="cpu")
    soak = tsoak.run_soak(n_schedules=2, scenarios=["dies-untyped", "dies-typed"],
                          device="cpu")
    assert soak["typed_failures"] == 1 and len(soak["failures"]) == 1


def test_soak_smoke_every_stack():
    """The reference's tier-1 canary (two fit-stream schedules, each run
    twice for the replay's bit-identity), and the two deterministic stacks
    (the synchronous fit's bitwise retry, the paged fleet replay) once
    each: every schedule completes or dies typed, no invariant breaks. The
    asynchronous and hogwild storms run on the card (``chip_smoke.py``
    ``soak``)."""
    report = tsoak.run_soak(n_schedules=2, scenarios=["fit-stream"], device="cpu")
    assert report["failures"] == []
    assert report["completed"] + report["typed_failures"] == 2
    report = tsoak.run_soak(n_schedules=2, base_seed=10,
                            scenarios=["sync-fit", "fleet-replay"], device="cpu")
    assert report["failures"] == [], report["failures"]
    assert report["completed"] + report["typed_failures"] == 2
