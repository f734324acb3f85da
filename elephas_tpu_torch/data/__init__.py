"""The local Spark-core facade (a copy of ``elephas_tpu/data/rdd.py``)."""

from .rdd import (RDD, Broadcast, SparkConf, SparkContext, TaskContext,
                  TaskFailedError)

__all__ = ["RDD", "Broadcast", "SparkConf", "SparkContext", "TaskContext",
           "TaskFailedError"]
