"""Minimal ML ``Pipeline`` facade.

The reference's pipeline examples compose ``ElephasEstimator`` inside a
``pyspark.ml.Pipeline`` (SURVEY.md §3.3). This module provides the Pipeline /
PipelineModel shape plus the two feature stages the reference's examples lean
on (``StringIndexer``, ``StandardScaler``), so those scripts run against the
local facade unchanged in structure.

A copy of ``elephas_tpu/ml/pipeline.py`` (framework-free, so the port keeps
its own copy instead of importing the JAX package).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..data.dataframe import DataFrame
from ..mllib.linalg import DenseVector


class Pipeline:
    """Ordered stages; estimators are fit, transformers pass through."""

    def __init__(self, stages: Sequence):
        self.stages = list(stages)

    def fit(self, df: DataFrame) -> "PipelineModel":
        fitted = []
        current = df
        for stage in self.stages:
            if hasattr(stage, "fit"):
                model = stage.fit(current)
                fitted.append(model)
                current = model.transform(current)
            else:
                fitted.append(stage)
                current = stage.transform(current)
        return PipelineModel(fitted)


class PipelineModel:
    def __init__(self, stages: List):
        self.stages = stages

    def transform(self, df: DataFrame) -> DataFrame:
        current = df
        for stage in self.stages:
            current = stage.transform(current)
        return current


class _ColumnStage:
    def _replace_column(self, df: DataFrame, col: str, fn) -> DataFrame:
        return df.withColumn(col, fn)


class StringIndexer(_ColumnStage):
    """Label → index by descending frequency (pyspark semantics)."""

    def __init__(self, inputCol: str, outputCol: str):
        self.inputCol = inputCol
        self.outputCol = outputCol

    def fit(self, df: DataFrame) -> "StringIndexerModel":
        values = [r[self.inputCol] for r in df.collect()]
        uniq, counts = np.unique(np.asarray(values, dtype=object), return_counts=True)
        order = sorted(zip(uniq, counts), key=lambda t: (-t[1], str(t[0])))
        mapping = {v: float(i) for i, (v, _) in enumerate(order)}
        return StringIndexerModel(self.inputCol, self.outputCol, mapping)


class StringIndexerModel(_ColumnStage):
    def __init__(self, inputCol: str, outputCol: str, mapping: dict):
        self.inputCol = inputCol
        self.outputCol = outputCol
        self.labels = mapping

    def transform(self, df: DataFrame) -> DataFrame:
        return self._replace_column(
            df, self.outputCol, lambda r: self.labels[r[self.inputCol]]
        )


class StandardScaler(_ColumnStage):
    """Feature standardization over a vector column (pyspark semantics)."""

    def __init__(self, inputCol: str, outputCol: str, withMean: bool = True,
                 withStd: bool = True):
        self.inputCol = inputCol
        self.outputCol = outputCol
        self.withMean = withMean
        self.withStd = withStd

    def fit(self, df: DataFrame) -> "StandardScalerModel":
        from .adapter import _to_array

        feats = np.stack([_to_array(r[self.inputCol]) for r in df.collect()])
        mean = feats.mean(axis=0) if self.withMean else np.zeros(feats.shape[1])
        std = feats.std(axis=0, ddof=1) if self.withStd else np.ones(feats.shape[1])
        std = np.where(std == 0, 1.0, std)
        return StandardScalerModel(self.inputCol, self.outputCol, mean, std)


class StandardScalerModel(_ColumnStage):
    def __init__(self, inputCol, outputCol, mean, std):
        self.inputCol = inputCol
        self.outputCol = outputCol
        self.mean = mean
        self.std = std

    def transform(self, df: DataFrame) -> DataFrame:
        from .adapter import _to_array

        return self._replace_column(
            df, self.outputCol,
            lambda r: DenseVector((_to_array(r[self.inputCol]) - self.mean) / self.std),
        )
