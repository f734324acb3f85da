"""``SparkModel`` and ``SparkMLlibModel`` (port of ``elephas_tpu/spark_model.py``).

The public surface is the reference's: the constructor signature, ``fit(rdd,
epochs, batch_size, verbose, validation_split)``, ``predict``, ``evaluate``,
``master_network``, ``save`` / ``load_spark_model``. ``model`` is a Keras-3
model's JSON (a string or its dict), ``model_to_dict``'s ``{'model',
'weights'}``, the port's
:class:`~elephas_tpu_torch.models.adapters.KerasModelAdapter`, or any
object with ``to_json()`` and ``get_weights()`` (a Keras model, read
duck-typed); an object with ``get_weights()`` and ``set_weights()`` but no
``to_json()`` is kept as it is, a holder of another model's PS wire-order
weights for :meth:`SparkModel.fit_stream` (an LM's sorted-key params).
``master_network`` is the adapter; it holds the trained weights
(``get_weights()``).

Two paths, selected as the reference selects them:

- **compiled path** (``comm='jax'``: ``parameter_server_mode='jax'``, and
  the default for synchronous): the port's engine
  (:class:`~elephas_tpu_torch.parallel.engine.CompiledTrainer`) runs every
  worker's replica as one stack on the device; with ``checkpoint_dir`` it
  fits in epoch chunks, checkpointing weights, optimizer state and (for
  synchronous+epoch, which stays merge-faithful) the replica stacks.
- **host path** (``comm='host'``: ``'http'``, ``'socket'`` or ``'native'``
  with an asynchronous mode — the reference's defaults — or
  ``mode='synchronous', comm='host'``): the reference's architecture.
  Worker generators run through ``rdd.mapPartitions`` (threads), each
  training a replica on the device with ``model.fit``'s contract
  (:mod:`elephas_tpu_torch.worker`); synchronous deltas merge in the
  calling process, asynchronous and hogwild workers pull from and push to a live
  HTTP, socket or native parameter server (:mod:`elephas_tpu_torch.parameter`),
  optionally through a delta codec (``compression``).

Kept from the reference: ``rdd.repartition(num_workers)`` before training,
partitions ``<= batch_size`` skipped, sync merge = delta averaging, async
merge = full-delta application. Beyond it, the asynchronous host workers'
per-epoch histories are appended to ``training_histories`` (one per
partition, in partition order), as the synchronous ones are.

``save(path)`` writes an npz at ``path`` holding the model's JSON
(``model``) and its weights (``w0…``) instead of a Keras file, beside the
reference's ``path + '.elephas.json'`` sidecar.

Resilience, as the reference wires it (:mod:`elephas_tpu_torch.resilience`):
a seeded ``fault_plan`` reaches the workers (straggler stalls, partition
crashes), the clients (dropped, duplicated and failed pushes, the wire's
byte-level sites) and the servers (dropped applies, injected kills), and
ticks once per compiled fit chunk; ``retry_policy`` routes host-PS traffic
through backoff; ``membership`` (a
:class:`~elephas_tpu_torch.resilience.membership.HeartbeatRegistry`) runs
the host paths' rounds K-of-N (``quorum``, ``round_deadline_s``, straggler
backups) and masks expired workers out of the compiled path's merges;
``hot_standby`` replicates the http or socket server to a standby the
clients fail over to. :meth:`SparkModel.fit_stream` is the streaming
train-to-serve loop over the host parameter server
(:mod:`elephas_tpu_torch.streaming`). ``elastic`` (an
:class:`~elephas_tpu_torch.parallel.elastic.ElasticConfig`) routes ``fit``
through an :class:`~elephas_tpu_torch.parallel.elastic.ElasticHostPool` of
real host processes, each training a
:class:`~elephas_tpu_torch.worker.KerasReplica` on ``device``.

Not ported yet, raising :class:`NotImplementedError`: ``profile_dir`` (the
reference writes a ``jax.profiler`` trace). ``evaluate`` with metrics other
than accuracy runs the port's Keras fall-back, as the reference hands it to
Keras.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from . import DeviceLike
from .data.rdd import RDD, TaskContext
from .mllib.adapter import from_matrix, from_vector, to_matrix, to_vector
from .mllib.linalg import DenseMatrix, DenseVector
from .models.adapters import KerasModelAdapter, _is_accuracy_name, compile_metric_names
from .parallel.engine import CompiledTrainer
from .parallel.mesh import build_mesh
from .parameter.client import BaseParameterClient
from .parameter.server import HttpServer, SocketServer
from .utils.rdd_utils import lp_to_simple_rdd
from .worker import AsynchronousSparkWorker, SparkWorker


class SparkModel:
    """Distributed data-parallel trainer for a compiled Keras model.

    Beyond the reference's parameters, the keyword ``ps_bind_host`` (default
    ``"127.0.0.1"``) is the address the host path's http and socket
    parameter servers listen on; the native server's unchanged C++ binds
    every interface."""

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
        # Delta compression for host PS pushes ('int8' | 'topk:F' | None):
        # only the host async paths have PS traffic to compress; reject the
        # knob anywhere it would be silently ignored.
        if compression:
            if comm != "host" or mode == "synchronous":
                raise ValueError(
                    "compression applies to the host parameter-server "
                    "paths (asynchronous/hogwild with http/socket/native); "
                    f"mode={mode!r} with comm={comm!r} has no PS "
                    "traffic to compress"
                )
            from .parameter.compression import make_codec

            make_codec(compression)  # validate the spec eagerly
        # Elastic-membership options: a HeartbeatRegistry drives K-of-N
        # quorum rounds with straggler backups on the host paths and masks
        # expired workers out of the compiled path's merges; hot_standby
        # adds a replicated standby server the clients fail over to.
        self.quorum = None if quorum is None else int(quorum)
        if self.quorum is not None and self.quorum < 1:
            raise ValueError("quorum must be >= 1")
        if self.quorum is not None and membership is None:
            raise ValueError(
                "quorum requires a membership registry "
                "(membership=HeartbeatRegistry(...))"
            )
        self.hot_standby = bool(hot_standby)
        if self.hot_standby:
            if comm != "host" or mode == "synchronous":
                raise ValueError(
                    "hot_standby needs a live parameter server: use an "
                    "asynchronous/hogwild mode with comm='host' "
                    f"(got mode={mode!r}, comm={comm!r})"
                )
            if parameter_server_mode not in ("http", "socket"):
                raise ValueError(
                    "hot_standby supports the http/socket parameter servers "
                    f"(got {parameter_server_mode!r})"
                )
        self.membership = membership
        # Elastic HOST training (parallel/elastic.py): an ElasticConfig
        # routes fit through a pool of real worker processes leasing
        # membership from this process; orthogonal to `membership`, which
        # governs the thread-level partitions of one host.
        self.elastic = elastic
        self._elastic_pool = None
        self.round_deadline_s = round_deadline_s
        self.backup_stragglers = bool(backup_stragglers)
        # a seeded FaultPlan injects failures into workers, clients and
        # servers; a RetryPolicy routes host-PS traffic through backoff
        self.fault_plan = fault_plan
        self.retry_policy = retry_policy
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
        # the bound of every parameter-server wire operation, and the socket
        # wire's mid-frame progress deadline (slow-loris guard)
        self.ps_timeout = float(ps_timeout)
        self.wire_stall_timeout_s = (
            None if wire_stall_timeout_s is None else float(wire_stall_timeout_s))
        self._master_network = self._adapter(model)
        self.training_histories: List[Dict[str, Any]] = []
        self.timings: List[Dict[str, float]] = []
        self._trainer: Optional[CompiledTrainer] = None
        self._trainer_model = None
        self.ps_bind_host = str(kwargs.pop("ps_bind_host", "127.0.0.1"))
        self._server = None
        self._standby_server = None
        self._server_port: Optional[int] = None
        self._ps_stats: Dict[str, Any] = {}
        self._fit_kwargs: Dict[str, Any] = {}
        self._checkpoint = (None, 1, False)

    def _adapter(self, model) -> KerasModelAdapter:
        if (not isinstance(model, (str, dict, KerasModelAdapter))
                and not hasattr(model, "to_json")
                and hasattr(model, "get_weights") and hasattr(model, "set_weights")):
            # a holder of a non-Keras model's wire-order weights (an LM's
            # sorted-key params for fit_stream): the host servers and
            # fit_stream read and write it, as the reference's duck-typed
            # master network; the Keras fit paths do not take it
            return model
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
        ``num_workers`` and run the mode's schedule. ``checkpoint_dir``
        checkpoints the compiled path every ``checkpoint_frequency`` epochs
        with its optimizer state; ``resume=True`` continues from the latest
        checkpoint. Extra keyword arguments (Keras ``fit`` options such as
        ``shuffle=False``) ride along to the host path's workers; the
        compiled path ignores them."""
        if profile_dir is not None:
            raise NotImplementedError(
                "profile_dir: the reference writes a jax.profiler trace; wrap the "
                "call in torch.profiler.profile instead")
        batch_size = self.batch_size if batch_size is None else batch_size
        num_workers = self._resolve_num_workers()
        if rdd.getNumPartitions() != num_workers:
            rdd = rdd.repartition(num_workers)
        self._checkpoint = (checkpoint_dir, checkpoint_frequency, resume)
        self._fit_kwargs = dict(kwargs)
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

    def _fit(self, rdd: RDD, epochs: int, batch_size: int, verbose: int,
             validation_split: float) -> None:
        if self.elastic is not None:
            self._fit_elastic(rdd, epochs, batch_size, verbose)
        elif self.comm == "jax":
            self._fit_jax(rdd, epochs, batch_size, verbose, validation_split)
        elif self.mode == "synchronous":
            self._fit_host_sync(rdd, epochs, batch_size, verbose, validation_split)
        else:
            self._fit_host_async(rdd, epochs, batch_size, verbose, validation_split)

    def _get_trainer(self) -> CompiledTrainer:
        if self._trainer is None or self._trainer_model is not self._master_network:
            self._trainer = CompiledTrainer(
                self._master_network, self.mesh, mode=self.mode,
                frequency=self.frequency, merge=self.merge, remat=self.remat)
            self._trainer_model = self._master_network
        return self._trainer

    def _membership_mask(self, n: int):
        """K-of-N mask for the compiled path: ``worker_valid`` floats for
        :meth:`CompiledTrainer.fit`, or ``None`` when every worker is live.
        Membership here models external liveness (workers the registry saw
        die between chunks); unknown members default to live."""
        if self.membership is None:
            return None
        from .resilience.membership import QuorumLostError, member_id_for

        self.membership.sweep()
        mask = [1.0 if self.membership.is_live(member_id_for(i), default=True)
                else 0.0 for i in range(n)]
        live = int(sum(mask))
        if self.quorum is not None and live < self.quorum:
            raise QuorumLostError(
                f"{live} of {n} workers live, quorum is {self.quorum}")
        if live == n:
            return None
        return mask

    # -- compiled path: every replica as one stack on the device ---------
    def _fit_jax(self, rdd, epochs, batch_size, verbose, validation_split):
        blocks = self._partition_blocks(rdd, batch_size)
        if not blocks:
            raise ValueError(
                "All partitions were skipped (each needs > batch_size samples)"
            )
        trainer = self._get_trainer()
        checkpoint_dir, checkpoint_frequency, resume = self._checkpoint
        if checkpoint_dir is None:
            if self.fault_plan is not None:
                self.fault_plan.tick("fit_chunk")
            result = trainer.fit(
                blocks, epochs=epochs, batch_size=batch_size,
                validation_split=validation_split, verbose=verbose,
                worker_valid=self._membership_mask(len(blocks)))
            self.training_histories.append(result.history)
            self.timings.append(result.timings)
            return

        # Checkpointed path: epoch-chunked fits carrying optimizer state.
        # Synchronous+epoch mode also carries the replica stacks across
        # chunks (engine worker_state), so the chunked sequence merges ONCE,
        # like the uninterrupted fit; each checkpoint's weights are the
        # merged preview of the stacks at that boundary.
        from .utils.checkpoint import (has_checkpoint, load_checkpoint, load_pytree,
                                       params_by_name, params_by_position,
                                       save_checkpoint, save_pytree)

        sync_faithful = self.mode == "synchronous" and self.frequency == "epoch"
        ws_path = os.path.join(checkpoint_dir, "worker_state")
        start_epoch, opt_state, worker_state = 0, None, None
        # the trainable and the non-trainable names (BatchNormalization's
        # moving statistics), each stack keyed by its own
        names = [list(d) for d in self._master_network.state_values()]
        if resume and has_checkpoint(checkpoint_dir):
            weights, meta, opt_state = load_checkpoint(checkpoint_dir)
            self._master_network.set_weights(weights)
            opt_state = params_by_name(opt_state, *names)
            start_epoch = int(meta.get("epoch", 0))
            if sync_faithful and start_epoch > 0:
                # worker_state is written in a separate step from meta.json,
                # so validate its epoch stamp: a crash between the two writes
                # must not silently continue from mismatched replica stacks.
                ws_epoch = -1
                if os.path.isdir(ws_path):
                    worker_state = params_by_name(load_pytree(ws_path), *names)
                    ws_epoch = int(worker_state.pop("epoch", -1))
                if ws_epoch != start_epoch:
                    import warnings

                    warnings.warn(
                        f"checkpoint {checkpoint_dir}: worker_state is "
                        f"{'missing' if worker_state is None else f'stamped epoch {ws_epoch}'}"
                        f" but meta says epoch {start_epoch}; resuming from "
                        "the merged checkpoint weights with fresh worker "
                        "stacks (merge-faithfulness to the uninterrupted "
                        "fit is lost for this run)",
                        RuntimeWarning,
                    )
                    worker_state = None
        merged: Dict[str, List[float]] = {}
        epoch = start_epoch
        while epoch < epochs:
            chunk = min(checkpoint_frequency, epochs - epoch)
            if self.fault_plan is not None:
                # one crash opportunity per chunk, after the previous
                # chunk's checkpoint is durable (the supervisor's resume)
                self.fault_plan.tick("fit_chunk")
            if sync_faithful:
                # seed stays 0 and the GLOBAL epoch index drives the orders
                # and dropout masks, as in the uninterrupted fit
                result = trainer.fit(
                    blocks, epochs=chunk, batch_size=batch_size,
                    validation_split=validation_split, verbose=verbose,
                    seed=0, epoch_offset=epoch, opt_state=opt_state,
                    keep_opt_state=True, worker_state=worker_state,
                    keep_worker_state=True,
                    worker_valid=self._membership_mask(len(blocks)))
                worker_state = result.worker_state
            else:
                result = trainer.fit(
                    blocks, epochs=chunk, batch_size=batch_size,
                    validation_split=validation_split, verbose=verbose,
                    seed=epoch, opt_state=opt_state, keep_opt_state=True,
                    worker_valid=self._membership_mask(len(blocks)))
            opt_state = result.opt_state
            for k, v in result.history.items():
                merged.setdefault(k, []).extend(v)
            epoch += chunk
            if sync_faithful:
                # stacks first, meta last: meta.json is the commit point, and
                # resume validates the stamp against meta's epoch
                save_pytree(ws_path, params_by_position(
                    {**worker_state, "epoch": np.int64(epoch)}, *names))
            save_checkpoint(checkpoint_dir, result.weights,
                            {"epoch": epoch, "epochs": epochs, "mode": self.mode},
                            params_by_position(opt_state, *names))
            self.timings.append(result.timings)
        self.training_histories.append(merged)

    # -- host path: reference-shaped synchronous -------------------------
    def _train_config(self, epochs, batch_size, verbose, validation_split):
        return {"epochs": epochs, "batch_size": batch_size, "verbose": verbose,
                "validation_split": validation_split, **self._fit_kwargs}

    def _worker_model_args(self):
        """``(json, optimizer, loss, metrics)`` each worker builds its
        replica from: the master network's optimizer and loss, overrides
        included, and ``master_metrics`` (none by default, as the
        reference's workers compile with)."""
        net = self._master_network
        return net.to_json(), net.optimizer_spec, net.loss_spec, self.master_metrics

    def _fit_host_sync(self, rdd, epochs, batch_size, verbose, validation_split):
        model = self._master_network
        json_config, opt, loss, metrics = self._worker_model_args()
        parameters = rdd.context.broadcast(model.get_weights())
        worker = SparkWorker(
            json_config, parameters,
            self._train_config(epochs, batch_size, verbose, validation_split),
            opt, loss, metrics, self.custom_objects, fault_plan=self.fault_plan,
            device=self.mesh.device)
        if self.membership is not None:
            # K-of-N round with straggler backups; the mean below is over
            # the RECEIVED deltas only
            committed = self._quorum_runner(rdd).run(
                rdd.partitions(), worker.train,
                stage_id=rdd.context._next_stage_id())
            results = [item for pid in sorted(committed) for item in committed[pid]]
        else:
            results = rdd.mapPartitions(worker.train).collect()
        deltas = [r[0] for r in results]
        self.training_histories.extend(r[1] for r in results if r[1])
        if not deltas:
            raise ValueError(
                "All partitions were skipped (each needs > batch_size samples)"
            )
        new_parameters = [np.array(w) for w in model.get_weights()]
        merge = "mean" if self.merge == "auto" else self.merge
        scale = 1.0 / len(deltas) if merge == "mean" else 1.0
        for delta in deltas:
            new_parameters = [
                p - scale * np.asarray(d) for p, d in zip(new_parameters, delta)
            ]
        model.set_weights(new_parameters)

    def _quorum_runner(self, rdd):
        from .resilience.membership import QuorumRunner

        return QuorumRunner(
            self.membership, quorum=self.quorum,
            round_deadline_s=self.round_deadline_s,
            backup_stragglers=self.backup_stragglers,
            max_failures=rdd.context.maxTaskFailures)

    # -- elastic host path: this process as control plane over hosts ----
    def _fit_elastic(self, rdd, epochs, batch_size, verbose) -> None:
        """Train over an elastic pool of real host processes.

        One elastic round = one global pass over the densified data: the
        pool recuts the batch over the CURRENT host formation each round,
        every host runs one local ``fit`` epoch of its
        :class:`~elephas_tpu_torch.worker.KerasReplica` on its shard (on
        this model's device), and the sample-weighted merged delta commits
        through the versioned, epoch-fenced parameter store. ``epochs``
        maps to rounds; ``validation_split`` is not consumed (hosts see
        training shards only)."""
        from .parallel.elastic import ElasticHostPool

        model = self._master_network
        blocks = self._partition_blocks(rdd, batch_size)
        if not blocks:
            raise ValueError(
                "All partitions were skipped (each needs > batch_size samples)"
            )
        x = np.concatenate([b[0] for b in blocks])
        y = np.concatenate([b[1] for b in blocks])
        json_config, opt, loss, metrics = self._worker_model_args()
        task_config = {
            "model_json": json_config,
            "optimizer": opt,
            "loss": loss,
            "metrics": metrics or [],
            "local_epochs": 1,
            "batch_size": batch_size,
            "device": str(self.mesh.device),
        }
        pool = ElasticHostPool(
            model.get_weights(), self.elastic,
            task={"builtin": "keras_fit_task"},
            task_config=task_config,
            fault_plan=self.fault_plan,
        )
        self._elastic_pool = pool
        weights = pool.fit(x, y, rounds=epochs)
        model.set_weights(weights)
        self.training_histories.append({
            "mode": "elastic",
            "loss": list(pool.history["loss"]),
            "rounds_committed": int(pool.stats["rounds_committed"]),
            "reformations": int(pool.stats["reformations"]),
        })

    # -- host path: reference-shaped async/hogwild against a live PS -----
    def start_server(self) -> None:
        weights = self._master_network.get_weights()
        if self.parameter_server_mode == "native":
            from .parameter.native import NativeServer

            cls = NativeServer
        elif self.parameter_server_mode == "http":
            cls = HttpServer
        else:
            cls = SocketServer
        server_kwargs = {}
        if cls is SocketServer and self.wire_stall_timeout_s is not None:
            server_kwargs["stall_timeout_s"] = self.wire_stall_timeout_s
        self._server = cls(weights, mode=self.mode, port=self.port,
                           fault_plan=self.fault_plan, name="primary",
                           host=self.ps_bind_host, **server_kwargs)
        self._server.start()
        # the port it bound (port=0 resolves to the OS's); self.port stays
        # the one asked for, so the next fit binds afresh
        self._server_port = self._server.port
        if self.hot_standby:
            # the standby gets NO fault plan: it is the recovery target, and
            # the primary's plan would re-consult server-side drops on
            # replicated deltas
            self._standby_server = cls(weights, mode=self.mode, port=0,
                                       name="standby", host=self.ps_bind_host,
                                       **server_kwargs)
            self._standby_server.start()
            self._server.attach_standby(self._standby_server)

    def _make_client(self) -> BaseParameterClient:
        if self.parameter_server_mode == "native":
            from .parameter.compression import make_codec
            from .parameter.native import NativeClient

            weights = self._master_network.get_weights()
            # fresh codec per client: top-k error-feedback residual is
            # per-worker state
            client = NativeClient([w.shape for w in weights],
                                  [w.dtype for w in weights], self._server_port,
                                  codec=make_codec(self.compression))
        else:
            # the fault plan goes in twice, as in the reference: here it
            # corrupts the bytes on the wire (socket transport only), and
            # FaultyClient below injects at the logical request level
            client = BaseParameterClient.get_client(
                self.parameter_server_mode, self._server_port, host="127.0.0.1",
                timeout=self.ps_timeout, fault_plan=self.fault_plan,
                stall_timeout_s=self.wire_stall_timeout_s)
            if self._standby_server is not None:
                from .resilience.policy import FailoverClient

                # bottom of the stack: transport selection, so injected
                # faults (FaultyClient, above) stay retryable without
                # tripping a failover; only genuine endpoint death does
                standby = BaseParameterClient.get_client(
                    self.parameter_server_mode, self._standby_server.port,
                    host="127.0.0.1", timeout=self.ps_timeout,
                    fault_plan=self.fault_plan,
                    stall_timeout_s=self.wire_stall_timeout_s)
                client = FailoverClient([client, standby], registry=self.membership)
            if self.fault_plan is not None:
                from .resilience.faults import FaultyClient

                client = FaultyClient(client, self.fault_plan)
            if self.compression:
                from .parameter.compression import CompressingClient, make_codec

                client = CompressingClient(client, make_codec(self.compression))
        if self.retry_policy is not None:
            from .resilience.policy import ResilientClient

            client = ResilientClient(client, policy=self.retry_policy)
        return client

    def stop_server(self) -> None:
        if self._server is not None:
            if self._standby_server is not None:
                # let in-flight replication land before reading counters
                self._server.flush_replication()
            self._ps_stats = {
                name: {
                    "version": int(getattr(server, "version", -1)),
                    "pulls": int(getattr(server, "pulls", -1)),
                    "rejected_stale": int(getattr(server, "rejected_stale", 0)),
                    "replication_errors": int(
                        getattr(server, "replication_errors", 0)),
                    "applied_tagged": {k: int(v) for k, v in
                                       getattr(server, "applied_tagged", {}).items()},
                }
                for name, server in (("primary", self._server),
                                     ("standby", self._standby_server))
                if server is not None
            }
            self._server.stop()
            self._server = None
        if self._standby_server is not None:
            self._standby_server.stop()
            self._standby_server = None

    def _fit_host_async(self, rdd, epochs, batch_size, verbose, validation_split):
        model = self._master_network
        json_config, opt, loss, metrics = self._worker_model_args()
        train_config = self._train_config(epochs, batch_size, verbose, validation_split)
        histories: Dict[int, Dict[str, List[float]]] = {}
        self.start_server()
        try:
            def run(iterator):
                # each partition gets its OWN client (thread), as one client
                # per executor in the reference
                client = self._make_client()
                try:
                    worker = AsynchronousSparkWorker(
                        json_config, client, train_config, self.frequency,
                        opt, loss, metrics, self.custom_objects,
                        fault_plan=self.fault_plan, registry=self.membership,
                        device=self.mesh.device)
                    yield from worker.train(iterator)
                    if worker.history:
                        histories[TaskContext.get().partitionId()] = worker.history
                finally:
                    # task retries re-enter run(): a raising attempt must not
                    # leak its TCP connection until GC
                    client.close()

            if self.membership is not None:
                # K-of-N round: "reporting" means the worker finished its
                # pushes; partitions abandoned at the deadline get their
                # task fenced at the server (a superseding register rolls
                # back their uncommitted pushes and rejects later ones)
                runner = self._quorum_runner(rdd)
                stage_id = rdd.context._next_stage_id()
                runner.run(rdd.partitions(), run, stage_id=stage_id)
                if runner.abandoned:
                    fencer = self._make_client()
                    try:
                        for pid in runner.abandoned:
                            fencer.register_attempt(
                                f"stage-{stage_id}-partition-{pid}", 1 << 20)
                    finally:
                        fencer.close()
            else:
                rdd.mapPartitions(run).collect()
            client = self._make_client()
            try:
                new_parameters = client.get_parameters()
            finally:
                client.close()
            model.set_weights(new_parameters)
        finally:
            self.stop_server()
        self.training_histories.extend(histories[p] for p in sorted(histories))

    def membership_snapshot(self) -> Dict[str, Any]:
        """JSON-able membership observability: the registry's snapshot
        (joins, expiries, epochs, backups, failovers, per-round shortfall)
        plus the last fit's parameter-server counters (version, pulls,
        fencing, replication) under ``parameter_servers``, and the last
        elastic fit's host-level control plane (epochs, commits, mesh
        formations) under ``elastic``."""
        snap: Dict[str, Any] = {
            "membership": None, "counters": {}, "rounds": [], "events": [],
        }
        if self.membership is not None:
            snap = self.membership.snapshot()
        snap["parameter_servers"] = dict(self._ps_stats)
        if self._elastic_pool is not None:
            snap["elastic"] = self._elastic_pool.snapshot()
        return snap

    # -- streaming train-to-serve ----------------------------------------
    def fit_stream(self, batches, train_fn, *, sink=None,
                   publish_every: int = 1,
                   max_interval_s: Optional[float] = None,
                   eval_fn=None, eval_batch=None,
                   regression_margin: float = 0.0, ring_size: int = 4,
                   checkpoint_dir: Optional[str] = None,
                   checkpoint_every: int = 1) -> Dict[str, Any]:
        """Streaming ingest with live weight publication (host PS path).

        Drains ``batches`` through a
        :class:`~elephas_tpu_torch.streaming.trainer.StreamTrainer` against
        this model's own parameter server, started and stopped as
        ``fit``'s asynchronous host path does (standby replication and the
        client wrapper stack included). ``train_fn(weights, batch) ->
        (new_weights, loss)`` runs in the calling process in PS wire order.
        With ``sink`` (e.g. :func:`~elephas_tpu_torch.streaming.publisher.
        engine_sink` over a live engine) a
        :class:`~elephas_tpu_torch.streaming.publisher.WeightPublisher`
        publishes every ``publish_every`` commits / ``max_interval_s``
        seconds behind the optional eval gate. With ``checkpoint_dir`` the
        stream runs under a
        :class:`~elephas_tpu_torch.resilience.supervisor.TrainingSupervisor`
        (a checkpoint every ``checkpoint_every`` commits, crash resume with
        exactly-once batch consumption).

        Returns a JSON-able summary (commit count, publisher history); the
        master network ends holding the final PS weights."""
        from .streaming import StreamTrainer, WeightPublisher

        if self.mode not in ("asynchronous", "hogwild"):
            raise ValueError(
                "fit_stream needs a live parameter server "
                f"(mode 'asynchronous' or 'hogwild', got {self.mode!r})")
        if self.parameter_server_mode not in ("http", "socket", "native"):
            raise ValueError(
                "fit_stream runs against the host parameter servers "
                f"(http/socket/native, got {self.parameter_server_mode!r})")
        self.start_server()
        try:
            client = self._make_client()
            try:
                trainer = StreamTrainer(client, train_fn)
                publisher = None
                if sink is not None:
                    publisher = WeightPublisher(
                        client, sink, publish_every=publish_every,
                        max_interval_s=max_interval_s, eval_fn=eval_fn,
                        eval_batch=eval_batch,
                        regression_margin=regression_margin,
                        ring_size=ring_size)
                if checkpoint_dir is not None:
                    from .resilience.supervisor import TrainingSupervisor

                    TrainingSupervisor(
                        self, checkpoint_dir,
                        checkpoint_frequency=checkpoint_every,
                    ).fit_stream(batches, trainer, publisher=publisher)
                else:
                    trainer.run(batches, publisher=publisher)
                self._master_network.set_weights(client.get_parameters())
                summary: Dict[str, Any] = {
                    "commits": trainer.commits,
                    "last_loss": trainer.last_loss,
                    "last_version": int(getattr(client, "last_seen_version", -1)),
                }
                if publisher is not None:
                    summary["publisher"] = publisher.state_dict()
                return summary
            finally:
                client.close()
        finally:
            self.stop_server()

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

    def _compiled_eval_representable(self) -> bool:
        """True when the compiled evaluation returns what Keras ``evaluate``
        would: the loss plus (only) an accuracy metric. Weighted metrics,
        other metrics, or a ``master_metrics`` override that disagrees with
        the compiled ones go to the Keras fall-back, as in the reference."""
        names, weighted = compile_metric_names(self._master_network)
        if weighted or not all(_is_accuracy_name(n) for n in names):
            return False
        return self._get_trainer().adapter.wants_accuracy == bool(names)

    def evaluate(self, x, y, **kwargs):
        """Loss (and accuracy) on held-out data: a scalar loss, or ``[loss,
        accuracy]`` when an accuracy metric is compiled in, as Keras
        returns it. Where the reference hands evaluation to Keras (the host
        path, or metrics the compiled path does not compute) it is Keras's
        ``evaluate`` as the adapter runs it
        (:meth:`~elephas_tpu_torch.models.adapters.KerasModelAdapter.keras_evaluate`):
        ``[loss, *metrics, *weighted_metrics]`` over batches of 32."""
        if self.comm == "jax" and self._compiled_eval_representable():
            res = self._get_trainer().evaluate(
                np.asarray(x), np.asarray(y),
                batch_size=kwargs.get("batch_size", self.batch_size))
            if "accuracy" in res:
                return [res["loss"], res["accuracy"]]
            return res["loss"]
        return self._master_network.keras_evaluate(np.asarray(x), np.asarray(y))

    # -- persistence -----------------------------------------------------
    def save(self, path: str) -> None:
        """Whole-model save: an npz at ``path`` holding the model's JSON
        (``model``) and its weights (``w0…``), written atomically, plus the
        reference's sidecar ``path + '.elephas.json'`` with the elephas
        config. (The reference writes a Keras file at ``path``; the port
        has no Keras.)"""
        from .utils.checkpoint import atomic_write

        net = self._master_network
        with atomic_write(path) as f:
            np.savez(f, model=np.array(net.to_json()),
                     **{f"w{i}": w for i, w in enumerate(net.get_weights())})
        with atomic_write(path + ".elephas.json") as f:
            f.write(json.dumps(self.get_config()).encode("utf-8"))

    @property
    def training_histories_(self):
        return self.training_histories


def load_spark_model(path: str, custom_objects: Optional[dict] = None,
                     device: DeviceLike = "cuda") -> SparkModel:
    """Inverse of :meth:`SparkModel.save`: the model and weights at ``path``
    and the elephas config of its sidecar, on ``device``."""
    with np.load(path) as data:
        model = {"model": str(data["model"]),
                 "weights": [data[f"w{i}"] for i in range(len(data.files) - 1)]}
    config: Dict[str, Any] = {}
    sidecar = path + ".elephas.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            config = json.load(f)
    return SparkModel(
        model,
        mode=config.get("mode", "asynchronous"),
        frequency=config.get("frequency", "epoch"),
        parameter_server_mode=config.get("parameter_server_mode", "http"),
        num_workers=config.get("num_workers"),
        custom_objects=custom_objects,
        batch_size=config.get("batch_size", 32),
        port=config.get("port", 4000),
        merge=config.get("merge", "auto"),
        comm=config.get("comm"),
        remat=config.get("remat", False),
        compression=config.get("compression"),
        device=device,
    )


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
