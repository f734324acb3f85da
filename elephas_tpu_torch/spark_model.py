"""``SparkModel`` and ``SparkMLlibModel`` on the device path (port of
``elephas_tpu/spark_model.py``).

The public surface is the reference's (constructor signature, ``fit(rdd,
epochs, batch_size, verbose, validation_split)``, ``predict``,
``evaluate``, ``master_network``), run by the port's engine
(:class:`~elephas_tpu_torch.parallel.engine.CompiledTrainer`) over a
Keras-free adapter: ``model`` is a Keras-3 model's JSON (a string or its
dict), ``model_to_dict``'s ``{'model', 'weights'}``, the port's
:class:`~elephas_tpu_torch.models.adapters.KerasModelAdapter`, or any
object with ``to_json()`` and ``get_weights()`` (a Keras model, read
duck-typed). ``master_network`` is the adapter; it holds the trained
weights (``get_weights()``).

Kept from the reference: ``parameter_server_mode='jax'`` / ``comm='jax'``
select this path (the default for synchronous), ``rdd.repartition(
num_workers)`` before training, partitions ``<= batch_size`` skipped,
sync merge = delta averaging, async merge = full-delta application. Not
ported yet, each raising :class:`NotImplementedError` with its ROADMAP
item: the host parameter-server paths (``'http'``, ``'socket'``,
``'native'``, ``comm='host'``) and delta compression (item 8);
checkpoints, ``save`` and ``load_spark_model`` (items 8 and 12: they
write a Keras file); fault plans, retry policies, membership, quorum, hot
standby, elastic hosts and ``fit_stream`` (item 10); ``profile_dir``; and
``evaluate`` with metrics other than accuracy, which the reference hands
to Keras.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from . import DeviceLike
from .data.rdd import RDD
from .mllib.adapter import from_matrix, from_vector, to_matrix, to_vector
from .mllib.linalg import DenseMatrix, DenseVector
from .models.adapters import KerasModelAdapter, _is_accuracy_name
from .parallel.engine import CHECKPOINT_ITEM, CompiledTrainer
from .parallel.mesh import build_mesh
from .utils.rdd_utils import lp_to_simple_rdd

HOST_PATH_ITEM = "ROADMAP queue 1 item 8 (the host parameter-server path)"
RESILIENCE_ITEM = "ROADMAP queue 1 item 10 (resilience, streaming and fleet)"
METRICS_ITEM = "ROADMAP queue 1 item 13 (Keras metrics beyond accuracy)"
SAVE_ITEM = ("ROADMAP queue 1 items 8 and 12 (checkpoints; a Keras file needs "
             "Keras or its format ported)")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} waits for {item}")


class SparkModel:
    """Distributed data-parallel trainer for a compiled Keras model."""

    def __init__(self, model, mode: str = "asynchronous", frequency: str = "epoch",
                 parameter_server_mode: str = "http",
                 num_workers: Optional[int] = None,
                 custom_objects: Optional[dict] = None, batch_size: int = 32,
                 port: int = 4000, mesh=None, merge: str = "auto",
                 comm: Optional[str] = None, remat: bool = False,
                 compression: Optional[str] = None,
                 master_optimizer=None, master_loss=None, master_metrics=None,
                 fault_plan=None, retry_policy=None,
                 ps_timeout: float = 60.0,
                 membership=None, quorum: Optional[int] = None,
                 round_deadline_s: Optional[float] = None,
                 backup_stragglers: bool = True,
                 hot_standby: bool = False,
                 elastic=None,
                 wire_stall_timeout_s: Optional[float] = None,
                 device: DeviceLike = "cuda",
                 *args, **kwargs):
        if mode not in ("synchronous", "asynchronous", "hogwild"):
            raise ValueError(f"Unknown mode: {mode}")
        if parameter_server_mode not in ("http", "socket", "native", "jax"):
            raise ValueError(
                f"Unknown parameter_server_mode: {parameter_server_mode}"
            )
        # comm overrides: 'jax' = on-device engine, 'host' = reference-shaped
        # host path. Default: sync → jax; async → per parameter_server_mode.
        if comm is None:
            if mode == "synchronous":
                comm = "jax"
            else:
                comm = "jax" if parameter_server_mode == "jax" else "host"
        if comm != "jax":
            raise _not_ported(
                f"comm={comm!r} (parameter_server_mode={parameter_server_mode!r}; "
                f"pass parameter_server_mode='jax' for the device path)", HOST_PATH_ITEM)
        if compression:
            raise _not_ported("compression of parameter-server pushes", HOST_PATH_ITEM)
        for name, value in (("fault_plan", fault_plan), ("retry_policy", retry_policy),
                            ("membership", membership), ("quorum", quorum),
                            ("round_deadline_s", round_deadline_s),
                            ("elastic", elastic)):
            if value is not None:
                raise _not_ported(f"{name}=", RESILIENCE_ITEM)
        if hot_standby:
            raise _not_ported("hot_standby=True", RESILIENCE_ITEM)
        self.mode = mode
        self.frequency = frequency
        self.parameter_server_mode = parameter_server_mode
        self.comm = comm
        self.num_workers = num_workers
        self.custom_objects = custom_objects
        self.batch_size = batch_size
        self.port = port
        self.merge = merge
        self.mesh = mesh if mesh is not None else build_mesh(device=device)
        self.remat = remat
        self.compression = compression
        self.master_optimizer = master_optimizer
        self.master_loss = master_loss
        self.master_metrics = master_metrics
        self._master_network = self._adapter(model)
        self.training_histories: List[Dict[str, Any]] = []
        self.timings: List[Dict[str, float]] = []
        self._trainer: Optional[CompiledTrainer] = None
        self._trainer_model = None

    def _adapter(self, model) -> KerasModelAdapter:
        if isinstance(model, KerasModelAdapter):
            if model.device != self.mesh.device:
                raise ValueError(f"the model is on {model.device}, the mesh on "
                                 f"{self.mesh.device}")
            return model
        return KerasModelAdapter(model, loss=self.master_loss,
                                 optimizer=self.master_optimizer,
                                 metrics=self.master_metrics,
                                 custom_objects=self.custom_objects,
                                 device=self.mesh.device)

    # -- properties ------------------------------------------------------
    @property
    def master_network(self) -> KerasModelAdapter:
        return self._master_network

    @master_network.setter
    def master_network(self, network):
        self._master_network = self._adapter(network)

    def get_config(self) -> Dict[str, Any]:
        return {
            "mode": self.mode,
            "frequency": self.frequency,
            "parameter_server_mode": self.parameter_server_mode,
            "num_workers": self.num_workers,
            "batch_size": self.batch_size,
            "port": self.port,
            "merge": self.merge,
            "comm": self.comm,
            "remat": self.remat,
            "compression": self.compression,
        }

    # -- training --------------------------------------------------------
    def fit(self, rdd: RDD, epochs: int = 10, batch_size: Optional[int] = None,
            verbose: int = 0, validation_split: float = 0.1,
            checkpoint_dir: Optional[str] = None,
            checkpoint_frequency: int = 1, resume: bool = False,
            profile_dir: Optional[str] = None, **kwargs) -> None:
        """Train on an RDD of ``(x, y)`` sample pairs: repartition to
        ``num_workers`` and run the mode's schedule on the device. Extra
        keyword arguments (Keras ``fit`` options of the host path) are
        ignored, as on the reference's compiled path."""
        if checkpoint_dir is not None or resume:
            raise _not_ported("checkpoint_dir / resume", CHECKPOINT_ITEM)
        if profile_dir is not None:
            raise NotImplementedError(
                "profile_dir: the reference writes a jax.profiler trace; wrap the "
                "call in torch.profiler.profile instead")
        batch_size = self.batch_size if batch_size is None else batch_size
        num_workers = self._resolve_num_workers()
        if rdd.getNumPartitions() != num_workers:
            rdd = rdd.repartition(num_workers)
        self._fit(rdd, epochs, batch_size, verbose, validation_split)

    def _resolve_num_workers(self) -> int:
        if self.num_workers is not None:
            return int(self.num_workers)
        return self.mesh.size

    def _partition_blocks(self, rdd: RDD, batch_size: int):
        """Partitions → dense per-worker blocks, skipping ``<= batch_size``
        partitions (the reference worker guard). Cached per (rdd identity,
        batch_size), so a refit reuses the blocks and the engine the data
        it already staged on the device."""
        key = (id(rdd), batch_size)
        cached = getattr(self, "_block_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        blocks = []
        for part in rdd.partitions():
            if not part:
                continue
            xs = np.stack([np.asarray(x) for x, _ in part])
            ys = np.stack([np.asarray(y) for _, y in part])
            if xs.shape[0] <= batch_size:
                continue
            blocks.append((xs, ys))
        self._block_cache = (key, blocks)
        return blocks

    def _get_trainer(self) -> CompiledTrainer:
        if self._trainer is None or self._trainer_model is not self._master_network:
            self._trainer = CompiledTrainer(
                self._master_network, self.mesh, mode=self.mode,
                frequency=self.frequency, merge=self.merge, remat=self.remat)
            self._trainer_model = self._master_network
        return self._trainer

    def _fit(self, rdd, epochs, batch_size, verbose, validation_split):
        blocks = self._partition_blocks(rdd, batch_size)
        if not blocks:
            raise ValueError(
                "All partitions were skipped (each needs > batch_size samples)"
            )
        result = self._get_trainer().fit(
            blocks, epochs=epochs, batch_size=batch_size,
            validation_split=validation_split, verbose=verbose)
        self.training_histories.append(result.history)
        self.timings.append(result.timings)

    def fit_stream(self, *args, **kwargs):
        raise _not_ported("fit_stream", RESILIENCE_ITEM)

    # -- inference -------------------------------------------------------
    def predict(self, data, batch_size: Optional[int] = None):
        """Predict on a numpy array, or on an RDD of feature rows (an RDD
        comes back with the partitioning preserved)."""
        batch_size = self.batch_size if batch_size is None else batch_size
        trainer = self._get_trainer()
        if isinstance(data, RDD):
            parts = data.partitions()
            rows = [np.asarray(r) for part in parts for r in part]
            if not rows:
                return RDD([[] for _ in parts], data.context)
            preds = trainer.predict(np.stack(rows), batch_size=batch_size)
            out_parts, i = [], 0
            for part in parts:
                out_parts.append(list(preds[i:i + len(part)]))
                i += len(part)
            return RDD(out_parts, data.context)
        return trainer.predict(np.asarray(data), batch_size=batch_size)

    def evaluate(self, x, y, **kwargs):
        """Loss (and accuracy) on held-out data: a scalar loss, or ``[loss,
        accuracy]`` when an accuracy metric is compiled in, as Keras
        returns it. Other metrics raise: the reference evaluates them
        through Keras."""
        names, weighted = self._master_network.compile_metric_names()
        if weighted or not all(_is_accuracy_name(n) for n in names):
            raise NotImplementedError(
                f"evaluate with metrics {names + weighted}: the reference hands "
                f"metrics other than accuracy to Keras ({METRICS_ITEM})")
        res = self._get_trainer().evaluate(
            np.asarray(x), np.asarray(y),
            batch_size=kwargs.get("batch_size", self.batch_size))
        if "accuracy" in res:
            return [res["loss"], res["accuracy"]]
        return res["loss"]

    # -- persistence -----------------------------------------------------
    def save(self, path: str) -> None:
        raise _not_ported("SparkModel.save", SAVE_ITEM)

    @property
    def training_histories_(self):
        return self.training_histories


def load_spark_model(path: str, custom_objects: Optional[dict] = None) -> SparkModel:
    raise _not_ported("load_spark_model", SAVE_ITEM)


class SparkMLlibModel(SparkModel):
    """LabeledPoint-RDD skin (reference ``spark_model.py:~200``)."""

    def fit(self, labeled_points: RDD, epochs: int = 10,
            batch_size: Optional[int] = None, verbose: int = 0,
            validation_split: float = 0.1, categorical: bool = False,
            nb_classes: Optional[int] = None, **kwargs) -> None:
        rdd = lp_to_simple_rdd(labeled_points, categorical, nb_classes)
        batch_size = self.batch_size if batch_size is None else batch_size
        num_workers = self._resolve_num_workers()
        rdd = rdd.repartition(num_workers)
        self._fit(rdd, epochs, batch_size, verbose, validation_split)

    def predict(self, mllib_data):
        """Predict on an MLlib ``Vector``/``Matrix``, returning the same type."""
        if isinstance(mllib_data, DenseMatrix):
            return to_matrix(self._master_network.predict(from_matrix(mllib_data)))
        if isinstance(mllib_data, DenseVector):
            features = from_vector(mllib_data)[None, :]
            return to_vector(self._master_network.predict(features)[0])
        return super().predict(mllib_data)
