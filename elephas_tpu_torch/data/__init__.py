"""The local Spark facade: the core (a copy of ``elephas_tpu/data/rdd.py``)
and Spark SQL's ``Row`` / ``DataFrame`` / ``SparkSession`` (a copy of
``elephas_tpu/data/dataframe.py``), and the native prefetching batch loader
(``native_loader.py``)."""

from .dataframe import DataFrame, Row, SparkSession
from .native_loader import NativeBatchLoader
from .rdd import (RDD, Broadcast, SparkConf, SparkContext, TaskContext,
                  TaskFailedError)

__all__ = ["RDD", "Broadcast", "SparkConf", "SparkContext", "TaskContext",
           "TaskFailedError", "DataFrame", "Row", "SparkSession", "NativeBatchLoader"]
