"""DL4J bridge aliases (port of ``elephas_tpu/dl4j.py``).

The reference's legacy path (``elephas/dl4j.py`` ``ParameterAveragingModel``
/ ``ParameterSharingModel``) drives deeplearning4j's Spark training over
JNI. The JAX package does not port it and keeps the two names as aliases of
its ``SparkModel``; so does this package, over its own:

- ``ParameterAveragingTrainingMaster`` ≡ ``SparkModel(mode='synchronous')``;
- ``SharedTrainingMaster`` (asynchronous gradient sharing) ≡
  ``SparkModel(mode='asynchronous')``.

User code importing the DL4J names gets the equivalent behaviour, with a
warning, instead of an ImportError.
"""

from __future__ import annotations

import warnings

from .spark_model import SparkModel


def _deprecated(name: str, mode: str):
    class _Alias(SparkModel):
        def __init__(self, model, *args, **kwargs):
            warnings.warn(
                f"{name} is the legacy DL4J path; elephas_tpu_torch subsumes it "
                f"with SparkModel(mode='{mode}') on the GPU.",
                stacklevel=2,
            )
            kwargs.setdefault("mode", mode)
            kwargs.pop("java_spark_context", None)
            super().__init__(model, *args, **kwargs)

    _Alias.__name__ = name
    return _Alias


ParameterAveragingModel = _deprecated("ParameterAveragingModel", "synchronous")
ParameterSharingModel = _deprecated("ParameterSharingModel", "asynchronous")
