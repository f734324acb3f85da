"""The Spark-ML skin's helpers: the DataFrame adapter, the typed
parameter mixins and the pipeline stages (copies of ``elephas_tpu/ml/``)."""

from .adapter import df_to_simple_rdd
from .pipeline import Pipeline, PipelineModel, StandardScaler, StringIndexer

__all__ = [
    "df_to_simple_rdd",
    "Pipeline",
    "PipelineModel",
    "StandardScaler",
    "StringIndexer",
]
