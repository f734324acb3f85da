"""The port's ``QuorumRunner`` round deadline and straggler options
(``resilience/membership.py``; ``SparkModel(round_deadline_s=,
backup_stragglers=)``) against the JAX package's.

- The reference's runner tests (``tests/resilience/test_membership.py``):
  a round deadline commits the received subset and abandons the rest; a
  result that arrives after the deadline's commit is fenced by epoch; a
  straggler's backup clone wins and only its result commits. Each runs in
  both packages with the same task and must give the same committed
  results, abandoned partitions, backups and registry counters. Beside
  them, ``backup_stragglers=False``: the straggler is waited for and no
  backup is launched.
- Synchronous host fits (``comm="host"``, the same Keras model and weights
  in both packages): with ``round_deadline_s`` a stalled partition is
  abandoned and the received deltas merge; with ``backup_stragglers=False``
  a slow partition is waited for. The weights match the reference's within
  the host path's pin (atol 1e-6, rtol 1e-5), and so do the registry's
  rounds.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import threading

import keras
import numpy as np
import pytest

from elephas_tpu import SparkModel as JSparkModel
from elephas_tpu import resilience as JR
from elephas_tpu.data import SparkContext as JSparkContext
from elephas_tpu.data.rdd import TaskContext as JTaskContext
from elephas_tpu.utils import to_simple_rdd as j_to_simple_rdd
from elephas_tpu_torch import SparkModel
from elephas_tpu_torch import resilience as TR
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.data.rdd import TaskContext as TTaskContext
from elephas_tpu_torch.utils import to_simple_rdd

from .conftest import make_classifier
from .test_torch_host_fit import restore_global_rngs  # noqa: F401 (autouse)

ATOL, RTOL = 1e-6, 1e-5
PACKAGES = [(JR, JTaskContext), (TR, TTaskContext)]


def _both(run):
    """``run(R, TaskContext)`` in the reference, then in the port."""
    return [run(R, ctx) for R, ctx in PACKAGES]


def test_round_deadline_commits_partial_and_abandons_the_rest():
    def run(R, TaskContext):
        reg = R.HeartbeatRegistry(lease_s=30.0)
        release = threading.Event()

        def task(it):
            if TaskContext.get().partitionId() == 2:
                release.wait(5.0)       # never finishes inside the deadline
            yield "ok"

        runner = R.QuorumRunner(reg, quorum=2, round_deadline_s=0.3)
        try:
            out = runner.run([[0], [0], [0]], task)
        finally:
            release.set()
        assert sorted(out) == [0, 1]
        assert runner.abandoned == [2]
        assert not reg.is_live(R.member_id_for(2))
        snap = reg.snapshot()
        assert snap["rounds"][-1]["deadline_hit"] is True
        return out, runner.abandoned, snap["counters"], snap["membership"]["fences"]

    ref, port = _both(run)
    assert port == ref


def test_late_result_after_deadline_commit_is_epoch_fenced():
    def run(R, TaskContext):
        reg = R.HeartbeatRegistry(lease_s=30.0)
        release = threading.Event()
        finished = threading.Event()

        def task(it):
            if TaskContext.get().partitionId() == 1:
                release.wait(5.0)
                finished.set()
            yield "late"

        runner = R.QuorumRunner(reg, quorum=1, round_deadline_s=0.2)
        out = runner.run([[0], [0]], task)
        assert sorted(out) == [0]
        release.set()
        assert finished.wait(5.0)
        assert reg.fence(R.member_id_for(1)) > 2    # launched at epoch <= 2
        return out, reg.fence(R.member_id_for(1)), runner.abandoned

    ref, port = _both(run)
    assert port == ref


@pytest.mark.parametrize("backup", [True, False], ids=["backup", "no_backup"])
def test_straggler_backup_first_finish_wins(backup):
    """With backups the clone (attempt 1) wins and only its result commits;
    with ``backup_stragglers=False`` no clone is launched and the stalled
    attempt's own result commits."""
    def run(R, TaskContext):
        reg = R.HeartbeatRegistry(lease_s=30.0, straggler_after_s=0.15)
        stalled = threading.Event()

        def task(it):
            ctx = TaskContext.get()
            if ctx.partitionId() == 0 and ctx.attemptNumber() == 0:
                stalled.wait(5.0 if backup else 0.5)    # the slow node
            yield f"attempt-{ctx.attemptNumber()}"

        runner = R.QuorumRunner(reg, backup_stragglers=backup)
        try:
            out = runner.run([[0], [0]], task)
        finally:
            stalled.set()
        counters = reg.snapshot()["counters"]
        assert out[1] == ["attempt-0"]
        if backup:
            assert out[0] == ["attempt-1"]
            assert runner.backups_launched == 1 and counters["backup"] == 1
        else:
            assert out[0] == ["attempt-0"]
            assert runner.backups_launched == 0 and "backup" not in counters
        return out, runner.backups_launched, counters

    ref, port = _both(run)
    assert port == ref


@pytest.fixture
def fit_data():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(200, 10)).astype("float32")
    y = np.eye(3, dtype="float32")[(x @ rng.normal(size=(10, 3))).argmax(axis=1)]
    return x, y


@pytest.mark.parametrize("option", ["round_deadline_s", "backup_stragglers"])
def test_sync_host_fit_with_round_options_matches_reference(option, fit_data):
    """``round_deadline_s=0.5``, quorum 3 of 4, partition 3 stalled until
    the round has committed (then it fails, so no zombie trains on): the
    three received deltas merge and partition 3 is abandoned.
    ``backup_stragglers=False`` with stragglers flagged after 0.05 s and
    partition 3 stalled 0.5 s: no backup, all four deltas merge. Both
    packages, the same weights and rounds."""
    x, y = fit_data
    keras.utils.set_random_seed(5)
    jm = make_classifier(hidden=8, optimizer="sgd")
    tm = make_classifier(hidden=8, optimizer="sgd")
    tm.set_weights(jm.get_weights())
    fits, rounds = [], []
    for SM, R, sc, rdd_of, model, extra in (
            (JSparkModel, JR, JSparkContext, j_to_simple_rdd, jm, {}),
            (SparkModel, TR, SparkContext, to_simple_rdd, tm, {"device": "cpu"})):
        release = threading.Event()
        if option == "round_deadline_s":
            def stall(_seconds, release=release):
                release.wait(30.0)
                raise RuntimeError("abandoned attempt ends here")

            plan = R.FaultPlan(seed=0, straggler_stalls={3: 1.0}, sleep=stall)
            registry = R.HeartbeatRegistry(lease_s=120.0)
            kw = dict(quorum=3, round_deadline_s=0.5)
        else:
            plan = R.FaultPlan(seed=0, straggler_stalls={3: 0.5})
            registry = R.HeartbeatRegistry(lease_s=120.0, straggler_after_s=0.05)
            kw = dict(backup_stragglers=False)
        sm = SM(model, mode="synchronous", num_workers=4, comm="host", fault_plan=plan,
                membership=registry, **kw, **extra)
        try:
            sm.fit(rdd_of(sc("local[4]"), x, y), epochs=1, batch_size=16, verbose=0,
                   validation_split=0.0, shuffle=False)
        finally:
            release.set()
        assert plan.fired.get("straggle-partition-3") == 0
        fits.append(sm.master_network.get_weights())
        snap = sm.membership_snapshot()
        rounds.append([{k: v for k, v in r.items() if k != "at"} for r in snap["rounds"]])
    for a, b in zip(fits[1], fits[0]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=RTOL)
    assert rounds[1] == rounds[0]
    last = rounds[1][-1]
    if option == "round_deadline_s":
        assert last["received"] == 3 and last["deadline_hit"] is True
    else:
        assert last["received"] == 4 and last["backups"] == 0
