"""Local Spark-SQL facade: ``Row`` / ``DataFrame`` / ``SparkSession``.

The reference's ML-pipeline skin (``elephas/ml_model.py:~40``,
``elephas/ml/adapter.py:~10``; SURVEY.md §3.3) consumes a
``pyspark.sql.DataFrame`` only through a narrow surface: column selection,
``df.rdd`` row iteration, appending a prediction column, and
``SparkSession.createDataFrame``. This module provides exactly that surface
over the local :class:`~elephas_tpu_torch.data.rdd.RDD`, so pipeline user
code written against the reference runs unchanged without a JVM.

A copy of ``elephas_tpu/data/dataframe.py`` (framework-free, so the port
keeps its own copy instead of importing the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .rdd import RDD, SparkContext


class Row:
    """``pyspark.sql.Row`` facade: ordered fields, attr & index access."""

    def __init__(self, *args, **kwargs):
        if args and kwargs:
            raise ValueError("Row takes either positional or keyword args, not both")
        if args and len(args) == 1 and isinstance(args[0], dict):
            kwargs = args[0]
            args = ()
        if args:
            # Positional rows carry values only; fields come from the schema.
            self.__dict__["_fields"] = [f"_{i + 1}" for i in range(len(args))]
            self.__dict__["_values"] = list(args)
        else:
            self.__dict__["_fields"] = list(kwargs.keys())
            self.__dict__["_values"] = list(kwargs.values())

    def __getattr__(self, name):
        try:
            fields = self.__dict__["_fields"]
            return self.__dict__["_values"][fields.index(name)]
        except (ValueError, KeyError):
            raise AttributeError(name)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._values[key]
        return self._values[self._fields.index(key)]

    def __contains__(self, key):
        return key in self._fields

    def asDict(self) -> Dict[str, Any]:
        return dict(zip(self._fields, self._values))

    def __len__(self):
        return len(self._values)

    def __iter__(self):
        return iter(self._values)

    def __eq__(self, other):
        return (
            isinstance(other, Row)
            and self._fields == other._fields
            and self._values == other._values
        )

    def __hash__(self):
        # pyspark Row is a tuple subclass: hashable when its values are
        # (raises TypeError otherwise) — reproduce that contract.
        return hash((tuple(self._fields), tuple(self._values)))

    def __repr__(self):
        kv = ", ".join(f"{f}={v!r}" for f, v in zip(self._fields, self._values))
        return f"Row({kv})"


class DataFrame:
    """Columnar-ish local DataFrame: a partitioned list of :class:`Row`.

    Facade over the ``pyspark.sql.DataFrame`` calls the reference makes
    (``select``, ``.rdd``, ``withColumn``, ``collect``, ``count``,
    ``take``/``first``/``show``, ``randomSplit``) — see reference
    ``elephas/ml/adapter.py:~10`` and ``elephas/ml_model.py:~150``.
    """

    def __init__(self, rdd: RDD, columns: List[str]):
        self._rdd = rdd
        self._columns = list(columns)

    # -- schema ----------------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    # -- access ----------------------------------------------------------
    @property
    def rdd(self) -> RDD:
        return self._rdd

    def collect(self) -> List[Row]:
        return self._rdd.collect()

    def count(self) -> int:
        return self._rdd.count()

    def first(self) -> Row:
        return self._rdd.first()

    def take(self, n: int) -> List[Row]:
        return self._rdd.take(n)

    def head(self, n: int = 1):
        rows = self.take(n)
        return rows[0] if n == 1 else rows

    def show(self, n: int = 20, truncate: bool = True) -> None:
        rows = self.take(n)
        print(" | ".join(self._columns))
        for r in rows:
            cells = []
            for c in self._columns:
                s = str(r[c])
                if truncate and len(s) > 20:
                    s = s[:17] + "..."
                cells.append(s)
            print(" | ".join(cells))

    # -- transformations -------------------------------------------------
    def select(self, *cols: str) -> "DataFrame":
        names = [c for c in cols]
        new = self._rdd.map(lambda r: Row(**{c: r[c] for c in names}))
        return DataFrame(new, names)

    def withColumn(self, name: str, values_or_fn) -> "DataFrame":
        """Append/replace a column.

        Accepts a callable ``Row -> value`` (closest local analog of a Spark
        ``Column`` expression).
        """
        if not callable(values_or_fn):
            raise TypeError("withColumn expects a callable Row -> value")
        fn = values_or_fn
        cols = self._columns + ([name] if name not in self._columns else [])

        def add(r: Row) -> Row:
            d = r.asDict()
            d[name] = fn(r)
            return Row(**d)

        return DataFrame(self._rdd.map(add), cols)

    def drop(self, *names: str) -> "DataFrame":
        keep = [c for c in self._columns if c not in names]
        return self.select(*keep)

    def repartition(self, n: int) -> "DataFrame":
        return DataFrame(self._rdd.repartition(n), self._columns)

    def randomSplit(self, weights: Sequence[float], seed: Optional[int] = None):
        import random

        rows = self.collect()
        rng = random.Random(seed)
        rng.shuffle(rows)
        total = float(sum(weights))
        splits, start = [], 0
        acc = 0.0
        for w in weights:
            acc += w / total
            end = int(round(acc * len(rows)))
            part = rows[start:end]
            start = end
            sc = self._rdd.context
            splits.append(DataFrame(sc.parallelize(part, sc.defaultParallelism), self._columns))
        return splits

    def toPandas(self):
        import pandas as pd  # pandas ships with the baked-in stack

        return pd.DataFrame([r.asDict() for r in self.collect()], columns=self._columns)


class SparkSession:
    """``pyspark.sql.SparkSession`` facade with the ``builder`` idiom."""

    _active: Optional["SparkSession"] = None

    def __init__(self, sc: SparkContext):
        self.sparkContext = sc
        SparkSession._active = self

    class Builder:
        def __init__(self):
            self._master = None
            self._app = "elephas-tpu"

        def master(self, m: str) -> "SparkSession.Builder":
            self._master = m
            return self

        def appName(self, a: str) -> "SparkSession.Builder":
            self._app = a
            return self

        def config(self, *_a, **_k) -> "SparkSession.Builder":
            return self

        def getOrCreate(self) -> "SparkSession":
            if SparkSession._active is not None and self._master is None:
                return SparkSession._active
            return SparkSession(SparkContext(master=self._master, appName=self._app))

    # ``SparkSession.builder`` must be a fresh Builder per access (pyspark
    # returns a class attribute; fresh instances avoid shared state).
    class _BuilderDescriptor:
        def __get__(self, obj, objtype=None):
            return SparkSession.Builder()

    builder = _BuilderDescriptor()

    def createDataFrame(self, data, schema: Optional[Sequence[str]] = None) -> DataFrame:
        """Build a DataFrame from rows.

        ``data``: list of :class:`Row`, dicts, or tuples (tuples require
        ``schema`` column names) — the idioms elephas examples use.
        """
        rows: List[Row] = []
        for item in data:
            if isinstance(item, Row):
                if schema is not None and item._fields[0].startswith("_"):
                    rows.append(Row(**dict(zip(schema, item._values))))
                else:
                    rows.append(item)
            elif isinstance(item, dict):
                rows.append(Row(**item))
            elif isinstance(item, (tuple, list)):
                if schema is None:
                    raise ValueError("tuple rows require a schema (column names)")
                rows.append(Row(**dict(zip(schema, item))))
            else:
                raise TypeError(f"Unsupported row type: {type(item)}")
        if not rows:
            raise ValueError("cannot create an empty DataFrame")
        columns = schema if schema is not None else rows[0]._fields
        sc = self.sparkContext
        rdd = sc.parallelize(rows, sc.defaultParallelism)
        return DataFrame(rdd, list(columns))

    def stop(self) -> None:
        self.sparkContext.stop()
        SparkSession._active = None
