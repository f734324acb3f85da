"""Host-level chaos against the port's elastic control plane, pinned and
held to the JAX package's (``tests/elastic/test_chaos_elastic.py``,
``test_registry_process.py`` and ``test_pinned_scenario.py``).

Each scenario scripts its faults through the seeded ``FaultPlan``'s exact
round→host maps (``kill_hosts``, ``partition_hosts``, ``join_delay_rounds``);
the kills are real SIGKILLs of real host processes and the partitions cut
a real heartbeat channel while the host keeps computing. The same plan,
configuration, data and initial weights go through the reference's pool
and the port's, both with the numpy ``sgd_task``: the membership trace,
mesh history, commit log (without its times), stats, server version and
fence count and the final weights must be the same, bit for bit, and the
port's pool meets the reference's literal pins.

The pinned 2→4→3 ``SparkModel(elastic=...)`` fit runs in the port alone
(its hosts train ``KerasReplica`` on the CPU), held to the literal pins of
``tests/elastic/test_pinned_scenario.py``.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import json

import numpy as np
import pytest

from elephas_tpu.resilience.faults import FaultPlan as JFaultPlan
from elephas_tpu.resilience.membership import HeartbeatRegistry as JHeartbeatRegistry
from elephas_tpu_torch.parallel import ElasticConfig
from elephas_tpu_torch.resilience import FaultPlan, HeartbeatRegistry

from .test_torch_elastic import (HOST_ENV, assert_same_run, lsq_problem, run_pool,
                                 seeded_classifier)  # noqa: F401  (a fixture)


def chaos_pair(cfg_kw, plan_kw, sleep_s=0.3, x=None, y=None):
    """The reference's and the port's pools over one fault plan (each
    package's own ``FaultPlan`` from the same seed and maps); returns
    ``(port pool, port plan, reference pool)`` after checking they agree."""
    if x is None:
        x, y, _ = lsq_problem()
    runs = {}
    for pkg, plan_cls in (("ref", JFaultPlan), ("port", FaultPlan)):
        plan = plan_cls(**plan_kw)
        pool, w = run_pool(pkg, cfg_kw, x, y, plan=plan,
                           task_config={"lr": 0.5, "sleep_s": sleep_s})
        runs[pkg] = (pool, w, plan)
    (ref, ref_w, ref_plan), (port, port_w, plan) = runs["ref"], runs["port"]
    assert_same_run(port, ref, port_w, ref_w)
    assert plan.fired == ref_plan.fired
    return port, plan, ref


def test_kill_host_mid_round_reforms():
    pool, plan, _ = chaos_pair(dict(initial_hosts=3, rounds=4, lease_s=2.0,
                                    beat_interval_s=0.1),
                               dict(seed=11, kill_hosts={1: 2}))
    assert plan.fired.get("kill-host-2") == 1
    assert pool.stats["kills"] == 1
    assert pool.stats["reformations"] == 1
    assert pool.membership_trace == [
        ("join", "host-0"), ("join", "host-1"), ("join", "host-2"),
        ("expire", "host-2"),
    ]
    assert [(c["version"], c["round"], c["contributors"])
            for c in pool.commit_log] == [
        (1, 0, [0, 1, 2]), (2, 1, [0, 1]), (3, 2, [0, 1]), (4, 3, [0, 1]),
    ]
    assert pool.stats["discarded_reformation"] == 2
    assert pool.ps.rejected_stale == 0


def test_zombie_partition_delta_rejected_stale():
    """A heartbeat-channel partition: the host stays alive and computes,
    its lease lapses, the round re-forms, and its delta, pushed through the
    real server fence, lands in ``rejected_stale``."""
    pool, plan, ref = chaos_pair(dict(initial_hosts=3, rounds=3, lease_s=1.5,
                                      beat_interval_s=0.1),
                                 dict(seed=3, partition_hosts={1: 2}), sleep_s=0.1)
    assert plan.fired.get("partition-host-2") == 1
    assert pool.stats["partitions"] == 1
    assert pool.membership_trace == [
        ("join", "host-0"), ("join", "host-1"), ("join", "host-2"),
        ("expire", "host-2"),
    ]
    assert pool.ps.rejected_stale == 1
    assert pool.stats["rejected_stale"] == 1
    assert pool.ps.version == len(pool.commit_log) == 3
    assert [c["version"] for c in pool.commit_log] == [1, 2, 3]
    events = pool.registry.snapshot()["events"]
    rejects = [e for e in events if e["kind"] == "late_reject"]
    assert len(rejects) == 1 and rejects[0]["member"] == "host-2"
    # the registry's events in the same order, kinds, members and epochs
    strip = [[(e["kind"], e["member"], e["epoch"]) for e in p.registry.snapshot()["events"]]
             for p in (pool, ref)]
    assert strip[0] == strip[1]


def test_delayed_join_misses_boundaries_then_joins():
    pool, plan, _ = chaos_pair(dict(initial_hosts=2, rounds=4, lease_s=2.0,
                                    beat_interval_s=0.1, scale_schedule={1: 3}),
                               dict(seed=5, join_delay_rounds={2: 2}), sleep_s=0.0)
    assert plan.fired.get("delay-join-host-2") == 2
    assert [len(c["contributors"]) for c in pool.commit_log] == [2, 2, 2, 3]
    assert pool.membership_trace == [
        ("join", "host-0"), ("join", "host-1"), ("join", "host-2"),
    ]


def test_min_hosts_floor_is_enforced():
    """Both packages refuse to go on below ``min_hosts``."""
    x, y, _ = lsq_problem()
    cfg = dict(initial_hosts=2, rounds=3, lease_s=1.5, beat_interval_s=0.1,
               min_hosts=2)
    for pkg, plan_cls in (("ref", JFaultPlan), ("port", FaultPlan)):
        with pytest.raises(RuntimeError, match="min_hosts"):
            run_pool(pkg, cfg, x, y, plan=plan_cls(seed=9, kill_hosts={1: 0}),
                     task_config={"lr": 0.5, "sleep_s": 0.3})


def test_trace_deterministic_across_runs():
    """Same seed, same faults: the port's trace and commit shape are the
    same in two runs over fresh processes, and the reference's."""
    cfg = dict(initial_hosts=2, rounds=4, lease_s=2.0, beat_interval_s=0.1,
               scale_schedule={1: 3})
    plan = dict(seed=21, kill_hosts={2: 1})
    pool, _, ref = chaos_pair(cfg, plan)
    x, y, _ = lsq_problem()
    again, _ = run_pool("port", cfg, x, y, plan=FaultPlan(**plan),
                        task_config={"lr": 0.5, "sleep_s": 0.3})

    def shape(p):
        return (p.membership_trace,
                [(c["version"], c["round"], tuple(c["contributors"])) for c in p.commit_log])

    assert shape(again) == shape(pool) == shape(ref)


# -- test_registry_process.py ------------------------------------------------------


@pytest.fixture(scope="module")
def partition_pools():
    """A 3-host fleet with one heartbeat partition (the reference's
    ``_chaos_pool``: 200 rows, seed 2), run once per package and inspected
    by the tests below."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(200, 3))
    y = x @ np.array([1.0, -2.0, 3.0])
    pool, _, ref = chaos_pair(dict(initial_hosts=3, rounds=3, lease_s=1.5,
                                   beat_interval_s=0.1),
                              dict(seed=3, partition_hosts={1: 2}), sleep_s=0.1,
                              x=x, y=y)
    return pool, ref


def test_snapshot_json_round_trips_from_process_run(partition_pools):
    pool, ref = partition_pools
    snap = pool.registry.snapshot()
    restored = json.loads(json.dumps(snap))
    assert restored == snap
    assert restored["membership"]["live"] == ["host-0", "host-1"]
    assert restored["counters"]["join"] == 3
    assert restored["counters"]["expire"] == 1
    assert restored["counters"]["late_reject"] == 1
    assert restored["counters"] == ref.registry.snapshot()["counters"]


def test_epochs_strictly_monotonic_under_process_churn(partition_pools):
    pool, ref = partition_pools
    for p in (pool, ref):
        events = p.registry.snapshot()["events"]
        bumping = [e for e in events
                   if e["kind"] in ("join", "rejoin", "leave", "expire")]
        epochs = [e["epoch"] for e in bumping]
        assert epochs == sorted(epochs)
        assert len(set(epochs)) == len(epochs)
        assert max(e["epoch"] for e in events) == p.registry.epoch
    assert pool.registry.epoch == ref.registry.epoch


def test_fence_rejects_lease_expired_between_launch_and_commit():
    """The zombie interleaving against a fake clock, in both packages'
    registries: work launched at epoch E, the member's lease expires, the
    result shows up at commit time: ``fence()`` rejects it."""
    seen = []
    for cls in (JHeartbeatRegistry, HeartbeatRegistry):
        clock = {"now": 0.0}
        registry = cls(lease_s=1.0, clock=lambda: clock["now"])
        registry.join("host-0")
        registry.join("host-1")
        launch_epoch = registry.epoch
        clock["now"] = 1.5
        registry.heartbeat("host-1")
        assert registry.sweep() == ["host-0"]
        assert launch_epoch < registry.fence("host-0")
        assert not registry.is_live("host-0")
        assert launch_epoch >= registry.fence("host-1")
        seen.append((launch_epoch, registry.fence("host-0"), registry.fence("host-1")))
    assert seen[0] == seen[1]


def test_pool_registry_fence_reflects_partition(partition_pools):
    pool, ref = partition_pools
    assert pool.registry.fence("host-2") > 0
    assert pool.registry.fence("host-2") == ref.registry.fence("host-2")
    assert pool.ps.rejected_stale == 1
    snap = pool.registry.snapshot()
    fences = snap["membership"]["fences"]
    assert "host-2" in fences
    rejects = [e for e in snap["events"] if e["kind"] == "late_reject"]
    assert rejects and rejects[0]["detail"]["launch_epoch"] < fences["host-2"]


# -- test_pinned_scenario.py ---------------------------------------------------------

ROUNDS = 6
EXPECTED_TRACE = [
    ("join", "host-0"),
    ("join", "host-1"),
    ("join", "host-2"),
    ("join", "host-3"),
    ("expire", "host-1"),
]


def test_elastic_2_4_3_spark_fit(monkeypatch, seeded_classifier, toy_classification):
    """The pinned scenario in the port: an elastic 2→4→3-host
    ``SparkModel.fit`` whose hosts train ``KerasReplica`` on the CPU, scaled
    up mid-fit (one new host joining late), one host SIGKILLed mid-round;
    the reference's literal pins."""
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    for k, v in HOST_ENV.items():
        monkeypatch.setenv(k, v)    # the hosts inherit the environment
    x, y = toy_classification
    rdd = to_simple_rdd(SparkContext("local[8]"), x, y)
    model = seeded_classifier(hidden=8, optimizer="sgd")
    plan = FaultPlan(seed=1234, kill_hosts={4: 1}, join_delay_rounds={3: 1})
    sm = SparkModel(
        model, num_workers=4, batch_size=32, fault_plan=plan, device="cpu",
        elastic=ElasticConfig(initial_hosts=2, scale_schedule={2: 4}, min_hosts=1,
                              lease_s=4.0, beat_interval_s=0.2, round_timeout_s=180.0))
    sm.fit(rdd, epochs=ROUNDS, batch_size=32, validation_split=0.0)
    pool = sm._elastic_pool

    losses = pool.history["loss"]
    assert len(losses) == ROUNDS
    assert losses[-1] < losses[0], losses
    assert pool.membership_trace == EXPECTED_TRACE
    assert plan.fired.get("kill-host-1") == 4
    assert plan.fired.get("delay-join-host-3") == 1
    assert [m["num_hosts"] for m in pool.mesh_history] == [2, 3, 4, 3]
    versions = [c["version"] for c in pool.commit_log]
    assert versions == list(range(1, ROUNDS + 1))
    assert pool.ps.version == ROUNDS
    epochs = [c["epoch"] for c in pool.commit_log]
    assert epochs == sorted(epochs)
    assert [tuple(c["contributors"]) for c in pool.commit_log] == [
        (0, 1), (0, 1), (0, 1, 2), (0, 1, 2, 3), (0, 2, 3), (0, 2, 3),
    ]
    assert pool.stats["reformations"] == 1
    assert pool.stats["discarded_reformation"] == 3
    assert pool.ps.rejected_stale == 0
    snap = sm.membership_snapshot()
    assert snap["elastic"]["stats"]["rounds_committed"] == ROUNDS
    assert snap["elastic"]["commit_log"] == pool.snapshot()["commit_log"]
    hist = sm.training_histories[-1]
    assert hist["mode"] == "elastic" and hist["reformations"] == 1
    assert hist["loss"] == losses and hist["rounds_committed"] == ROUNDS
    np.testing.assert_array_equal(sm.master_network.get_weights()[0], pool.ps.weights[0])
