"""Typed parameter mixins for the ML-pipeline skin.

Rebuild of reference ``elephas/ml/params.py:~1``: one ``Has<X>`` mixin per
knob, each contributing a ``Param`` descriptor plus getter/setter, composed by
``ElephasEstimator``. The reference builds these on ``pyspark.ml.param.Params``;
there is no JVM/pyspark here, so a minimal ``Params`` base reproduces the
observable behavior: named params with docs, defaults, ``set``/``get``,
keyword construction, ``explainParams``, and dict round-trip for persistence.

A copy of ``elephas_tpu/ml/params.py`` (framework-free, so the port keeps
its own copy instead of importing the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class Param:
    """A named, documented parameter attached to a Params instance."""

    def __init__(self, parent: "Params", name: str, doc: str):
        self.parent = parent
        self.name = name
        self.doc = doc

    def __repr__(self):
        return f"Param({self.name})"


class Params:
    """Mini ``pyspark.ml.param.Params``: a registry of Param + values."""

    def __init__(self):
        self._params: Dict[str, Param] = {}
        self._paramMap: Dict[str, Any] = {}
        self._defaultParamMap: Dict[str, Any] = {}
        # Continue the cooperative chain so Has* mixins after Params in the
        # MRO declare their params once the registries exist.
        super().__init__()

    def _declare(self, name: str, doc: str, default: Any = None) -> Param:
        p = Param(self, name, doc)
        self._params[name] = p
        self._defaultParamMap[name] = default
        return p

    # -- pyspark-shaped accessors ---------------------------------------
    @property
    def params(self) -> List[Param]:
        return list(self._params.values())

    def hasParam(self, name: str) -> bool:
        return name in self._params

    def getOrDefault(self, name: str) -> Any:
        if name in self._paramMap:
            return self._paramMap[name]
        return self._defaultParamMap.get(name)

    def _set(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            if k not in self._params:
                raise ValueError(f"Unknown param: {k}")
            self._paramMap[k] = v
        return self

    def setParams(self, **kwargs) -> "Params":
        return self._set(**kwargs)

    def copy(self, extra: Dict[str, Any] = None) -> "Params":
        """Shallow copy with ``extra`` params overlaid — pyspark's
        ``fit(df, params)`` semantics apply params to a copy, leaving the
        original untouched."""
        import copy as _copy

        new = _copy.copy(self)
        new._paramMap = dict(self._paramMap)
        if extra:
            new._set(**extra)
        return new

    def explainParams(self) -> str:
        lines = []
        for name, p in sorted(self._params.items()):
            lines.append(f"{name}: {p.doc} (current: {self.getOrDefault(name)})")
        return "\n".join(lines)

    def param_values(self) -> Dict[str, Any]:
        """All effective values (defaults overlaid with set values)."""
        out = dict(self._defaultParamMap)
        out.update(self._paramMap)
        return out


def _mixin(name: str, doc: str, default: Any = None, snake: Optional[str] = None):
    """Build a ``Has<X>`` mixin class with get_/set_ accessors.

    The reference's mixins expose ``set_<snake>`` / ``get_<snake>`` methods
    (e.g. ``set_keras_model_config``); generated here from a template.
    """
    snake = snake or name

    class Mixin:
        def __init__(self):
            setattr(self, snake, self._declare(snake, doc, default))
            super().__init__()

    def setter(self, value):
        self._set(**{snake: value})
        return self

    def getter(self):
        return self.getOrDefault(snake)

    setattr(Mixin, f"set_{snake}", setter)
    setattr(Mixin, f"get_{snake}", getter)
    Mixin.__name__ = f"Has{''.join(w.capitalize() for w in snake.split('_'))}"
    return Mixin


HasKerasModelConfig = _mixin(
    "keras_model_config", "Serialized Keras model architecture (JSON)", None
)
HasOptimizerConfig = _mixin(
    "optimizer_config", "Serialized Keras optimizer config", None
)
HasMode = _mixin("mode", "Training mode: synchronous|asynchronous|hogwild",
                 "asynchronous")
HasFrequency = _mixin("frequency", "Merge frequency: epoch|batch", "epoch")
HasParameterServerMode = _mixin(
    "parameter_server_mode", "Weight transport: jax|http|socket", "http"
)
HasNumberOfClasses = _mixin("nb_classes", "Number of output classes", 10)
HasNumberOfWorkers = _mixin("num_workers", "Number of data-parallel workers", None)
HasEpochs = _mixin("epochs", "Training epochs", 10)
HasBatchSize = _mixin("batch_size", "Per-worker batch size", 32)
HasVerbosity = _mixin("verbose", "Verbosity level", 0)
HasValidationSplit = _mixin(
    "validation_split", "Fraction of each worker's data held out", 0.1
)
HasCategoricalLabels = _mixin(
    "categorical", "Whether labels are categorical (one-hot encoded)", True
)
HasLoss = _mixin("loss", "Keras loss identifier", None)
HasMetrics = _mixin("metrics", "Keras metric identifiers", None)
HasFeaturesCol = _mixin("features_col", "Features column name", "features")
HasLabelCol = _mixin("label_col", "Label column name", "label")
HasOutputCol = _mixin("output_col", "Prediction output column name", "prediction")
HasCustomObjects = _mixin(
    "custom_objects", "Custom Keras objects for deserialization", None
)
