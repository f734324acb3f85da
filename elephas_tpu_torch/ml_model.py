"""Spark-ML-pipeline skin: ``ElephasEstimator`` / ``ElephasTransformer``
(port of ``elephas_tpu/ml_model.py``).

An Estimator configured with the ``Has*`` param mixins (``ml/params.py``),
whose ``_fit(df)`` converts the DataFrame to a simple RDD and trains the
model's Keras JSON through the port's
:class:`~elephas_tpu_torch.spark_model.SparkModel` (the Keras-free adapter
interprets the JSON), and returns a Transformer carrying the trained config
and weights that appends a prediction column on ``_transform``.

Kept from the reference: the params, their defaults and ``fit(df, params)``
on a copy; the transformer predicts with the trained network and appends
``output_col`` cast to float (the argmax class index for a categorical
model with more than one output, else the first output column), keeping
the partition count.

Without Keras:

- ``set_keras_model(model)`` reads the model duck-typed: its JSON from
  ``to_json()``, the optimizer as the dict ``keras.optimizers.serialize``
  gives (built from the class name and ``get_config()``), the loss as a
  string or the same kind of dict.
- The transformer's ``get_model()`` is a
  :class:`~elephas_tpu_torch.models.adapters.KerasModelAdapter`, whose
  ``predict(x, verbose=0)`` the transform calls as the reference calls
  Keras's.
- ``save`` writes the reference's layout (``elephas_kind``,
  ``params_json``, the weights ``w0…``) into an npz file, not HDF5 (the
  card has no h5py). ``load_ml_estimator`` / ``load_ml_transformer`` read
  it, and read an HDF5 file the JAX package wrote when h5py is installed.

The estimator, the transformer and the loaders take a trailing ``device``
(not a param: it never enters ``param_values()`` or a saved file).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np

from . import DeviceLike, resolve_device
from .data.dataframe import DataFrame, Row
from .ml.adapter import _to_array, df_to_simple_rdd
from .ml.params import (
    HasBatchSize,
    HasCategoricalLabels,
    HasCustomObjects,
    HasEpochs,
    HasFeaturesCol,
    HasFrequency,
    HasKerasModelConfig,
    HasLabelCol,
    HasLoss,
    HasMetrics,
    HasMode,
    HasNumberOfClasses,
    HasNumberOfWorkers,
    HasOptimizerConfig,
    HasOutputCol,
    HasParameterServerMode,
    HasValidationSplit,
    HasVerbosity,
    Params,
)
from .models.adapters import KerasModelAdapter
from .models.optimizers import keras_compiled_spec
from .spark_model import SparkModel


def _serialize(obj, module: str) -> Any:
    """What ``keras.<module>.serialize`` gives for a built-in Keras object,
    read duck-typed: a dict of its class name and ``get_config()``; a plain
    function by its name."""
    if hasattr(obj, "get_config"):
        return {"module": module, "class_name": type(obj).__name__,
                "config": obj.get_config(), "registered_name": None}
    return {"module": "builtins", "class_name": "function",
            "config": getattr(obj, "__name__", str(obj)), "registered_name": "function"}


class _Estimator:
    """pyspark ``Estimator`` shape: public ``fit`` delegates to ``_fit``.

    ``params`` apply to a copy (pyspark semantics) — the estimator itself is
    not mutated."""

    def fit(self, df: DataFrame, params: Optional[dict] = None):
        if params:
            return self.copy(params)._fit(df)
        return self._fit(df)


class _Transformer:
    """pyspark ``Transformer`` shape: public ``transform`` → ``_transform``."""

    def transform(self, df: DataFrame, params: Optional[dict] = None):
        if params:
            return self.copy(params)._transform(df)
        return self._transform(df)


class ElephasEstimator(
    Params, _Estimator,
    HasKerasModelConfig, HasOptimizerConfig, HasMode, HasFrequency,
    HasParameterServerMode, HasNumberOfClasses, HasNumberOfWorkers, HasEpochs,
    HasBatchSize, HasVerbosity, HasValidationSplit, HasCategoricalLabels,
    HasLoss, HasMetrics, HasFeaturesCol, HasLabelCol, HasOutputCol,
    HasCustomObjects,
):
    """Trains a Keras model's JSON on a DataFrame inside an ML ``Pipeline``,
    on ``device``."""

    def __init__(self, *, device: DeviceLike = "cuda", **kwargs):
        super().__init__()
        if kwargs:
            self.setParams(**kwargs)
        self.device = resolve_device(device)

    def set_keras_model(self, model) -> "ElephasEstimator":
        """Convenience: capture the config and the optimizer and loss of a
        compiled model (a Keras model, read duck-typed)."""
        self.set_keras_model_config(model.to_json())
        if getattr(model, "optimizer", None) is not None:
            self.set_optimizer_config(_serialize(model.optimizer, "keras.optimizers"))
        if getattr(model, "loss", None) is not None and self.get_loss() is None:
            loss = model.loss
            self.set_loss(loss if isinstance(loss, str) else _serialize(loss, "keras.losses"))
        return self

    def _fit(self, df: DataFrame) -> "ElephasTransformer":
        simple_rdd = df_to_simple_rdd(
            df,
            categorical=self.get_categorical(),
            nb_classes=self.get_nb_classes() if self.get_categorical() else None,
            features_col=self.get_features_col(),
            label_col=self.get_label_col(),
        )
        loss = self.get_loss()
        if loss is None:
            raise ValueError("ElephasEstimator requires loss (set_loss or loss=)")
        spark_model = SparkModel(
            self.get_keras_model_config(),
            mode=self.get_mode(),
            frequency=self.get_frequency(),
            parameter_server_mode=self.get_parameter_server_mode(),
            num_workers=self.get_num_workers(),
            custom_objects=self.get_custom_objects(),
            batch_size=self.get_batch_size(),
            master_optimizer=keras_compiled_spec(self.get_optimizer_config() or "sgd"),
            master_loss=loss,
            master_metrics=list(self.get_metrics() or []),
            device=self.device,
        )
        spark_model.fit(
            simple_rdd,
            epochs=self.get_epochs(),
            batch_size=self.get_batch_size(),
            verbose=self.get_verbose(),
            validation_split=self.get_validation_split(),
        )
        return ElephasTransformer(
            keras_model_config=spark_model.master_network.to_json(),
            weights=spark_model.master_network.get_weights(),
            categorical=self.get_categorical(),
            features_col=self.get_features_col(),
            label_col=self.get_label_col(),
            output_col=self.get_output_col(),
            custom_objects=self.get_custom_objects(),
            loss=self.get_loss() if isinstance(self.get_loss(), str) else None,
            device=self.device,
        )

    def save(self, path: str) -> None:
        _save_params(path, "estimator", self.param_values())


class ElephasTransformer(
    Params, _Transformer,
    HasKerasModelConfig, HasCategoricalLabels, HasFeaturesCol, HasLabelCol,
    HasOutputCol, HasCustomObjects, HasLoss,
):
    """Carries a trained model; appends predictions to DataFrames."""

    def __init__(self, weights=None, *, device: DeviceLike = "cuda", **kwargs):
        super().__init__()
        if kwargs:
            self.setParams(**kwargs)
        self.weights = [np.asarray(w) for w in (weights or [])]
        self.device = resolve_device(device)
        self._model = None

    def get_model(self) -> KerasModelAdapter:
        """The trained model on ``device`` (rebuilt lazily from the config
        and the weights)."""
        if self._model is None:
            self._model = KerasModelAdapter.from_json(
                self.get_keras_model_config(), self.weights or None,
                custom_objects=self.get_custom_objects(), device=self.device)
        return self._model

    def _transform(self, df: DataFrame) -> DataFrame:
        """Append ``output_col`` with model predictions: the features
        collected to one dense array, predicted on the device, zipped back
        as a new column."""
        model = self.get_model()
        features_col = self.get_features_col()
        output_col = self.get_output_col()
        rows = df.collect()
        features = np.stack([_to_array(r[features_col]) for r in rows])
        predictions = model.predict(features, verbose=0)
        if self.get_categorical() and predictions.ndim > 1 and predictions.shape[-1] > 1:
            values = predictions.argmax(axis=-1).astype("float64")
        else:
            values = predictions.reshape(len(rows), -1)[:, 0].astype("float64")
        new_rows = []
        for r, v in zip(rows, values):
            d = r.asDict()
            d[output_col] = float(v)
            new_rows.append(Row(**d))
        columns = df.columns + ([output_col] if output_col not in df.columns else [])
        sc = df.rdd.context
        return DataFrame(sc.parallelize(new_rows, df.rdd.getNumPartitions()), columns)

    def save(self, path: str) -> None:
        _save_params(path, "transformer", self.param_values(), self.weights)


# -- persistence: the reference's layout in an npz file ------------------------

_HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def _save_params(path: str, kind: str, params: Dict[str, Any], weights=None):
    from .utils.checkpoint import atomic_write

    clean = {
        k: v for k, v in params.items()
        if not callable(v) and k != "custom_objects"
    }
    with atomic_write(path) as f:
        np.savez(f, elephas_kind=np.array(kind), params_json=np.array(json.dumps(clean)),
                 **{f"w{i}": np.asarray(w) for i, w in enumerate(weights or [])})


def _load_params_h5(path: str):
    """A file the JAX package's ``save`` wrote (HDF5 attributes and a
    ``weights`` group)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{path} is an HDF5 file (the JAX package's format); reading it "
            f"needs h5py, which is not installed") from e

    with h5py.File(path, "r") as f:
        kind = f.attrs["elephas_kind"]
        params = json.loads(f.attrs["params_json"])
        weights = None
        if "weights" in f:
            grp = f["weights"]
            weights = [np.array(grp[f"w{i}"]) for i in range(len(grp.keys()))]
    return kind, params, weights


def _load_params(path: str):
    with open(path, "rb") as f:
        if f.read(len(_HDF5_SIGNATURE)) == _HDF5_SIGNATURE:
            return _load_params_h5(path)
    with np.load(path, allow_pickle=False) as data:
        kind = str(data["elephas_kind"])
        params = json.loads(str(data["params_json"]))
        n = sum(1 for k in data.files if k.startswith("w"))
        weights = [data[f"w{i}"] for i in range(n)] or None
    return kind, params, weights


def load_ml_estimator(path: str, custom_objects: Optional[dict] = None,
                      device: DeviceLike = "cuda") -> ElephasEstimator:
    """Reference ``load_ml_estimator``, on ``device``.

    ``custom_objects`` cannot be serialized into the file (they are live
    Python objects) — resupply them here when the model uses custom layers.
    """
    kind, params, _ = _load_params(path)
    if kind != "estimator":
        raise ValueError(f"{path} holds a {kind}, not an estimator")
    est = ElephasEstimator(device=device, **params)
    if custom_objects is not None:
        est.set_custom_objects(custom_objects)
    return est


def load_ml_transformer(path: str, custom_objects: Optional[dict] = None,
                        device: DeviceLike = "cuda") -> ElephasTransformer:
    """Reference ``load_ml_transformer``, on ``device``."""
    kind, params, weights = _load_params(path)
    if kind != "transformer":
        raise ValueError(f"{path} holds a {kind}, not a transformer")
    tr = ElephasTransformer(weights=weights, device=device, **params)
    if custom_objects is not None:
        tr.set_custom_objects(custom_objects)
    return tr
