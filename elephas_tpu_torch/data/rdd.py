"""Local Spark-core facade: ``SparkContext`` / ``RDD`` / ``Broadcast``.

A copy of ``elephas_tpu/data/rdd.py`` (framework-free, so the port keeps
its own copy instead of importing the JAX package).

The reference (b13n3rd/elephas) runs on a real Apache Spark cluster (JVM via
Py4J) purely as a *data plane*: ``parallelize`` → ``repartition`` →
``mapPartitions`` → ``collect`` plus driver ``broadcast`` (see SURVEY.md §1
"control-plane vs data-plane"). On TPU the heavy lifting — weight merging —
moves onto the chips as XLA collectives, so all that is needed from "Spark" is
a faithful local implementation of those five primitives for API parity with
user code written against the reference (e.g. the reference's
``examples/mnist_mlp_spark.py:~1`` builds an RDD with ``to_simple_rdd(sc, x,
y)`` and hands it to ``SparkModel.fit``).

This module deliberately reproduces observable Spark behaviors elephas relies
on:

- ``parallelize(seq, numSlices)`` slices like Spark: contiguous ranges of
  near-equal size.
- ``repartition(n)`` redistributes elements round-robin across ``n``
  partitions (Spark's repartition shuffles; round-robin gives the same
  "balanced partitions" property deterministically, which the reference's
  tests depend on only through balance, not order).
- ``mapPartitions(f)`` calls ``f`` once per partition with an *iterator* and
  expects an iterable back — elephas workers are generators consumed this way
  (reference ``elephas/worker.py:~25``).
- ``Broadcast.value`` — read-only driver-to-worker variable capture.

Partitions can optionally be evaluated in a thread pool (``local[N]``
masters), mirroring Spark local mode's concurrent task slots — this matters
for the asynchronous/hogwild modes where worker interleaving against the
parameter server is the whole point.
"""

from __future__ import annotations

import itertools
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence


class TaskContext:
    """Per-task execution context, ``pyspark.TaskContext``-shaped.

    Spark exposes the running task's identity to executor code via
    ``TaskContext.get()``; the reference never reads it, but its async workers
    *should have* (SURVEY.md §5.3 documents the retry non-idempotence hole this
    enables fixing). Set by :meth:`RDD.mapPartitions` around each partition
    function call, on the calling thread; ``get()`` returns ``None`` on the
    driver, exactly like pyspark.
    """

    _local = threading.local()

    def __init__(self, partition_id: int, attempt_number: int, stage_id: int):
        self._partition_id = int(partition_id)
        self._attempt_number = int(attempt_number)
        self._stage_id = int(stage_id)

    @classmethod
    def get(cls) -> Optional["TaskContext"]:
        return getattr(cls._local, "ctx", None)

    def partitionId(self) -> int:
        return self._partition_id

    def attemptNumber(self) -> int:
        """0 for the first attempt, incremented per retry (pyspark semantics)."""
        return self._attempt_number

    def stageId(self) -> int:
        return self._stage_id

    def taskAttemptId(self) -> int:
        """Unique-per-(stage, partition, attempt) id, Spark-style.

        40/24-bit fields: unique for partition counts < 2**24 and attempt
        counts < 2**16 (Python ints don't overflow above that; collisions
        would need a quinticillion-partition RDD).
        """
        return (
            (self._stage_id << 40)
            | (self._partition_id << 16)
            | self._attempt_number
        )

    @classmethod
    def _set(cls, ctx: Optional["TaskContext"]) -> None:
        cls._local.ctx = ctx


class TaskFailedError(RuntimeError):
    """A partition function exhausted ``spark.task.maxFailures`` attempts.

    Mirrors Spark's "Task failed N times; aborting job" stage failure — the
    L0 behavior the reference inherits (SURVEY.md §5.3).
    """

    def __init__(self, partition_id: int, attempts: int, cause: BaseException):
        super().__init__(
            f"Task over partition {partition_id} failed {attempts} times; "
            f"aborting job. Most recent failure: {cause!r}"
        )
        self.partition_id = partition_id
        self.attempts = attempts
        self.cause = cause


class Broadcast:
    """Read-only shared variable, Spark-``Broadcast``-shaped (``.value``)."""

    def __init__(self, value):
        self._value = value

    @property
    def value(self):
        return self._value

    def unpersist(self):  # parity no-op
        pass

    def destroy(self):  # parity no-op
        self._value = None


def _slice(seq: Sequence, num_slices: int) -> List[List]:
    """Spark-style contiguous slicing of a sequence into ``num_slices`` parts."""
    n = len(seq)
    num_slices = max(1, int(num_slices))
    parts = []
    for i in range(num_slices):
        start = (i * n) // num_slices
        end = ((i + 1) * n) // num_slices
        parts.append(list(seq[start:end]))
    return parts


class RDD:
    """A local, eagerly-stored, partitioned dataset.

    Implements the subset of ``pyspark.RDD`` the reference exercises
    (SURVEY.md §2.1 "RDD utils" and §3 call stacks): ``map``,
    ``mapPartitions``, ``filter``, ``collect``, ``count``, ``repartition``,
    ``getNumPartitions``, ``first``, ``take``, ``zip``, ``cache``/``persist``
    (no-ops), and exposes ``.context`` (:class:`SparkContext`) for
    ``rdd.context.broadcast(...)`` as used at reference
    ``elephas/spark_model.py:~130``.

    Transformations here are *eager* (each returns a new RDD with materialized
    partitions). Elephas only ever builds shallow chains ending in
    ``collect``, so laziness buys nothing and eagerness keeps worker-generator
    semantics obvious.
    """

    def __init__(self, partitions: List[List], context: "SparkContext"):
        self._partitions = [list(p) for p in partitions]
        self._context = context

    # -- info ------------------------------------------------------------
    @property
    def context(self) -> "SparkContext":
        return self._context

    def getNumPartitions(self) -> int:
        return len(self._partitions)

    def glom(self) -> "RDD":
        return RDD([[list(p)] for p in self._partitions], self._context)

    def partitions(self) -> List[List]:
        """Non-Spark helper: direct (copied) view of partition contents."""
        return [list(p) for p in self._partitions]

    # -- transformations -------------------------------------------------
    def map(self, f: Callable[[Any], Any]) -> "RDD":
        return RDD([[f(x) for x in p] for p in self._partitions], self._context)

    def filter(self, f: Callable[[Any], bool]) -> "RDD":
        return RDD([[x for x in p if f(x)] for p in self._partitions], self._context)

    def mapPartitions(self, f: Callable[[Iterator], Iterable]) -> "RDD":
        """Apply ``f`` to an iterator over each partition, concurrently.

        Concurrency across partitions mirrors Spark ``local[N]`` task slots —
        required for asynchronous/hogwild parameter-server semantics where
        workers genuinely interleave (reference ``elephas/worker.py:~60``).

        Each partition call is a *task*: it runs under a :class:`TaskContext`
        and is retried up to ``spark.task.maxFailures`` attempts (Spark
        default 4) on exception, matching the Spark task-retry behavior the
        reference inherits from L0 (SURVEY.md §5.3). After the last attempt
        the job aborts with :class:`TaskFailedError`.
        """
        max_failures = self._context.maxTaskFailures
        stage_id = self._context._next_stage_id()

        def run_task(args):
            pid, part = args
            last_err: Optional[BaseException] = None
            for attempt in range(max_failures):
                # Restore (not clear) on exit: a partition function may itself
                # run a nested local mapPartitions on this thread and must get
                # its own TaskContext back afterwards.
                outer_ctx = TaskContext.get()
                TaskContext._set(TaskContext(pid, attempt, stage_id))
                try:
                    return list(f(iter(part)))
                except Exception as err:  # noqa: BLE001 — task isolation
                    last_err = err
                finally:
                    TaskContext._set(outer_ctx)
            raise TaskFailedError(pid, max_failures, last_err)

        indexed = list(enumerate(self._partitions))
        n_threads = self._context.defaultParallelism
        if n_threads > 1 and len(self._partitions) > 1:
            with ThreadPoolExecutor(max_workers=n_threads) as pool:
                results = list(pool.map(run_task, indexed))
        else:
            results = [run_task(a) for a in indexed]
        return RDD(results, self._context)

    def repartition(self, num_partitions: int) -> "RDD":
        """Round-robin rebalance into ``num_partitions`` partitions."""
        num_partitions = max(1, int(num_partitions))
        out: List[List] = [[] for _ in range(num_partitions)]
        for i, x in enumerate(itertools.chain.from_iterable(self._partitions)):
            out[i % num_partitions].append(x)
        return RDD(out, self._context)

    coalesce = repartition

    def zip(self, other: "RDD") -> "RDD":
        mine = list(itertools.chain.from_iterable(self._partitions))
        theirs = list(itertools.chain.from_iterable(other._partitions))
        if len(mine) != len(theirs):
            raise ValueError("Can only zip RDDs with the same number of elements")
        zipped = list(zip(mine, theirs))
        return self._context.parallelize(zipped, self.getNumPartitions())

    def cache(self) -> "RDD":
        return self

    def persist(self, *_args) -> "RDD":
        return self

    def unpersist(self) -> "RDD":
        return self

    # -- actions ---------------------------------------------------------
    def collect(self) -> List:
        return list(itertools.chain.from_iterable(self._partitions))

    def count(self) -> int:
        return sum(len(p) for p in self._partitions)

    def first(self):
        for p in self._partitions:
            if p:
                return p[0]
        raise ValueError("RDD is empty")

    def take(self, n: int) -> List:
        out: List = []
        for p in self._partitions:
            for x in p:
                if len(out) == n:
                    return out
                out.append(x)
        return out

    def foreach(self, f: Callable[[Any], None]) -> None:
        for p in self._partitions:
            for x in p:
                f(x)


class SparkContext:
    """Driver-side context: partitioned-data factory + broadcast registry.

    Accepts the reference's construction idioms (``SparkContext(conf=conf)``
    with a ``SparkConf``-alike, or ``master=/appName=`` kwargs) so user
    scripts written for the reference run unchanged. ``local[N]`` masters set
    ``defaultParallelism = N`` (``local[*]`` → CPU count), which also caps
    ``mapPartitions`` thread concurrency.
    """

    def __init__(self, master: Optional[str] = None, appName: str = "elephas-tpu",
                 conf: Optional["SparkConf"] = None):
        if conf is not None:
            master = conf.get("spark.master", master)
            appName = conf.get("spark.app.name", appName)
        self._conf = conf if conf is not None else SparkConf()
        # Spark's spark.task.maxFailures default is 4 = total attempts per task.
        self.maxTaskFailures = int(self._conf.get("spark.task.maxFailures", 4))
        self._stage_counter = itertools.count()
        self.master = master or "local[4]"
        self.appName = appName
        self._stopped = False
        m = re.fullmatch(r"local\[(\d+|\*)\]", self.master)
        if m:
            if m.group(1) == "*":
                import os

                self.defaultParallelism = os.cpu_count() or 4
            else:
                self.defaultParallelism = int(m.group(1))
        elif self.master == "local":
            self.defaultParallelism = 1
        else:
            # Non-local masters have no JVM here; treat as 4 local slots.
            self.defaultParallelism = 4

    def parallelize(self, seq: Sequence, numSlices: Optional[int] = None) -> RDD:
        if numSlices is None:
            numSlices = self.defaultParallelism
        if not isinstance(seq, (list, tuple)):
            seq = list(seq)
        return RDD(_slice(seq, numSlices), self)

    def broadcast(self, value) -> Broadcast:
        return Broadcast(value)

    def getConf(self) -> "SparkConf":
        return self._conf

    def _next_stage_id(self) -> int:
        return next(self._stage_counter)

    def stop(self) -> None:
        self._stopped = True

    # pyspark-API compat niceties
    def setLogLevel(self, _level: str) -> None:
        pass

    @property
    def version(self) -> str:
        return "elephas-tpu-local"


class SparkConf:
    """Minimal ``pyspark.SparkConf`` facade (``setMaster``/``setAppName``)."""

    def __init__(self):
        self._conf = {}

    def set(self, key: str, value) -> "SparkConf":
        self._conf[key] = value
        return self

    def setMaster(self, master: str) -> "SparkConf":
        return self.set("spark.master", master)

    def setAppName(self, name: str) -> "SparkConf":
        return self.set("spark.app.name", name)

    def get(self, key: str, default=None):
        return self._conf.get(key, default)
