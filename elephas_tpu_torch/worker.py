"""Host-path workers (port of ``elephas_tpu/worker.py``): the executor code
of the reference elephas.

``SparkWorker.train`` (synchronous mode) and ``AsynchronousSparkWorker.train``
(asynchronous and hogwild modes) are generators consumed through
``rdd.mapPartitions(worker.train)``. The RDD facade runs partitions on a
thread pool, so asynchronous workers genuinely interleave against the live
parameter server, and each thread launches the port's kernels on the
card for its own batches.

The reference's workers build a Keras replica from the model's JSON and
call ``model.fit`` / ``train_on_batch``. The card has no Keras, so each
worker builds a :class:`KerasReplica` instead: the port's
:class:`~elephas_tpu_torch.models.adapters.KerasModelAdapter` over the same
JSON, on the worker's device, trained with ``model.fit``'s contract:

- ``validation_split`` holds out the last ``n - floor(n * (1 - split))``
  rows before any shuffle, and the validation loss is evaluated after each
  epoch;
- each epoch shuffles (from the global ``np.random``, as Keras's array
  adapter draws its permutation) unless ``shuffle=False``; a replica's
  first shuffled fit draws one permutation more, first, which Keras 3
  spends on the batch its first fit peeks at to build its metrics, so
  a seeded ``np.random`` gives Keras's orders;
- the last, partial batch is trained; the history's ``loss`` and metrics
  are the sample-weighted means over the epoch, under Keras's keys;
- each step moves BatchNormalization's statistics over that batch's rows
  (the last batch short, unpadded), and ``get_weights()`` / ``set_weights``
  carry them as Keras's do, so the deltas a worker yields or pushes
  include them;
- the optimizer follows Keras's own update rule (Adam and SGD;
  :func:`~elephas_tpu_torch.models.optimizers.to_keras_optimizer`), with
  one state a replica: fresh for each partition, kept across that
  partition's epochs and batches, as a compiled Keras model keeps it.

Dropout masks come from a ``torch.Generator`` on the worker's device keyed
by the task's (stage, partition, attempt).

Reference behaviors reproduced deliberately:

- partitions are materialized to dense arrays per worker;
- partitions with ``<= batch_size`` samples are SKIPPED (the reference's
  ``if x_train.shape[0] > batch_size:`` guard);
- synchronous workers yield ``delta = weights_before - weights_after``;
- asynchronous workers pull → train one epoch or batch → push the delta,
  per ``frequency``; ``frequency="batch"`` draws each epoch's order from
  the global ``np.random.permutation`` and drops the last partial batch.

The deltas on the wire are numpy arrays, never torch tensors.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from . import DeviceLike
from .data.rdd import TaskContext
from .models.adapters import KerasModelAdapter, stats_row
from .models.losses import metric_results, resolve_metric
from .models.stateful_metrics import result_value
from .models.optimizers import to_keras_optimizer
from .parameter.client import BaseParameterClient
from .utils.functional_utils import subtract_params_np


def task_id_for(ctx) -> str:
    """Parameter-server task id for a :class:`~elephas_tpu_torch.data.TaskContext`.

    Stage-scoped, not just partition-scoped: against a long-lived external
    server, an aborted prior job's uncommitted "partition-N" record would
    otherwise mark a NEW job's attempt 0 as stale and silently disable
    rollback for that task id.
    """
    return f"stage-{ctx.stageId()}-partition-{ctx.partitionId()}"


def round_task_id(round_index: int) -> str:
    """Parameter-server task id for one elastic host round: round-scoped,
    so the server's attempt fence rejects any contribution launched under a
    superseded membership epoch."""
    return f"round-{int(round_index)}"


def _materialize(data_iterator: Iterator) -> Optional[tuple]:
    """Partition iterator of ``(x, y)`` pairs → dense ``(x, y)`` arrays."""
    xs, ys = [], []
    for pair in data_iterator:
        x, y = pair
        xs.append(np.asarray(x))
        ys.append(np.asarray(y))
    if not xs:
        return None
    return np.stack(xs), np.stack(ys)


def _on_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host block on the device; floating data as float32, as the engine
    stages it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(device)


def _task_generator(ctx, device: DeviceLike) -> torch.Generator:
    """The dropout generator of one task attempt: a ``torch.Generator`` on
    ``device`` seeded from (stage, partition, attempt), (0, 0, 0) outside
    a task."""
    key = (0, 0, 0) if ctx is None else (
        ctx.stageId(), ctx.partitionId(), ctx.attemptNumber())
    seed = int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


class History:
    """What Keras's ``model.fit`` returns, as far as the workers read it:
    ``history`` (metric name → one value per epoch) and ``epoch`` (the
    epochs run)."""

    def __init__(self, history: Dict[str, List[float]], epochs: List[int]):
        self.history = history
        self.epoch = list(epochs)


# the model.fit options the workers take beyond the reference's own
FIT_OPTIONS = ("class_weight", "callbacks", "initial_epoch", "validation_freq",
               "validation_batch_size", "steps_per_epoch")


def class_weights(y: np.ndarray, class_weight: Dict[int, float]) -> np.ndarray:
    """Keras's per-sample weights for ``class_weight``: each row's class is
    the argmax of a one-hot ``y``, else its (rounded) id; a class the dict
    does not name weighs 1."""
    y = np.asarray(y)
    if y.ndim > 1:
        y = np.argmax(y, axis=-1) if y.shape[-1] != 1 else np.squeeze(y, axis=-1)
    y = np.round(y).astype(np.int32)
    return np.array([class_weight.get(int(c), 1.0) for c in y], dtype=np.float32)


def _should_eval(epoch: int, validation_freq) -> bool:
    """Keras's rule: validate after epoch ``epoch`` (0-based) when its
    number is a multiple of an int ``validation_freq`` or in a list of
    them."""
    if isinstance(validation_freq, int):
        return (epoch + 1) % validation_freq == 0
    return (epoch + 1) in validation_freq


def _call(callbacks, hook: str, *args, **kwargs) -> None:
    """Each callback's ``hook`` (read duck-typed; a missing one is Keras's
    no-op), called as Keras's ``CallbackList`` calls it: the batch hooks
    take ``logs`` by keyword, the others by position; no logs are ``{}``."""
    for cb in callbacks:
        fn = getattr(cb, hook, None)
        if fn is not None:
            fn(*args, **kwargs)


class KerasReplica:
    """One worker's model: the adapter over the model's JSON on ``device``,
    trained with Keras ``model.fit`` / ``train_on_batch``'s contract and
    Keras's optimizer rule (see the module docstring). The optimizer state
    is created at the first step and kept for the replica's life.

    ``metrics`` are the compiled ones (the reference's workers compile with
    ``master_metrics``): each is computed as Keras computes it
    (:func:`~elephas_tpu_torch.models.losses.resolve_metric`) on every
    training batch, and logged under its name, with a ``val_`` copy under
    validation. The replica is the ``model`` its callbacks see:
    ``get_weights``, ``set_weights`` and ``stop_training``."""

    def __init__(self, json_config: str, weights, optimizer, loss, metrics,
                 custom_objects: Optional[dict] = None, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        self.adapter = KerasModelAdapter(
            json_config, loss=loss, optimizer=optimizer, metrics=[],
            custom_objects=custom_objects, weights=weights, device=device)
        self.device = self.adapter.device
        self.optimizer = to_keras_optimizer(self.adapter.optimizer_spec)
        self.generator = generator if generator is not None else \
            _task_generator(None, self.device)
        resolved = [resolve_metric(m) for m in (metrics or [])]
        self.metric_names = [name for name, _ in resolved]
        self._metric_fns = [fn for _, fn in resolved]
        self._train_step, self._eval_step = self.adapter.build_metric_steps(
            self.optimizer, self._metric_fns)
        self._opt_state = None
        self._peeked = False
        self.stop_training = False

    def get_weights(self) -> List[np.ndarray]:
        return self.adapter.get_weights()

    def set_weights(self, weights) -> None:
        self.adapter.set_weights(weights)

    def _stacked(self):
        """``(tv, ntv)`` as one-replica stacks."""
        return tuple({k: v[None] for k, v in d.items()} for d in self.adapter.state_values())

    def _step(self, x: torch.Tensor, y: torch.Tensor, cw: Optional[torch.Tensor] = None):
        """One optimizer step on the batch ``x`` ``[B, ...]`` (a short last
        batch as it is, unpadded, as Keras trains it), moving the
        BatchNormalization statistics; ``cw`` the rows' class weights, the
        loss then ``sum(l * w) / B`` as Keras's. Returns ``[loss * B, B,
        *metric states]`` on the device (:func:`stats_row`)."""
        tv, ntv = self._stacked()
        if self._opt_state is None:
            self._opt_state = self.optimizer.init(tv, count_shape=(1,))
        n = x.shape[0]
        sw = torch.ones((1, n), device=self.device) if cw is None else cw[None]
        denom = None if cw is None else torch.full((1,), float(n), device=self.device)
        with torch.no_grad():
            tv, ntv, self._opt_state, stats = self._train_step(
                tv, ntv, self._opt_state, x[None], y[None], sw, self.generator, denom)
        self.adapter.install_state(*({k: v[0] for k, v in d.items()} for d in (tv, ntv)))
        return stats_row(stats)

    def _evaluate(self, x: torch.Tensor, y: torch.Tensor, batch_size: int,
                  callbacks=()):
        """Keras ``evaluate`` inside ``fit``: the sums over ``x`` in batches,
        each batch's test hooks called."""
        tv, ntv = self._stacked()
        tot = None
        _call(callbacks, "on_test_begin", {})
        for step, i in enumerate(range(0, x.shape[0], batch_size)):
            _call(callbacks, "on_test_batch_begin", step, logs={})
            xb, yb = x[i:i + batch_size], y[i:i + batch_size]
            sw = torch.ones((1, xb.shape[0]), device=self.device)
            row = stats_row(self._eval_step(tv, ntv, xb[None], yb[None], sw))
            tot = row if tot is None else tot + row
            if callbacks:
                _call(callbacks, "on_test_batch_end", step, logs=self._floats(self._logs(tot)))
        if callbacks:
            _call(callbacks, "on_test_end", self._floats(self._logs(tot)))
        return tot

    def _logs(self, tot: torch.Tensor, prefix: str = "") -> Dict[str, torch.Tensor]:
        """Keras's logs from the summed row: the loss, then each metric's
        result from its summed state (a vector where Keras's is one)."""
        logs = {prefix + "loss": tot[0] / tot[1]}
        for name, value in zip(self.metric_names, metric_results(self._metric_fns, tot[2:])):
            logs[prefix + name] = value
        return logs

    @staticmethod
    def _floats(logs: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """The logs read in one transfer: floats, a vector result as a
        float32 array (as Keras logs it)."""
        if not logs:
            return {}
        flat = torch.cat([v.reshape(-1) for v in logs.values()]).cpu()
        out, at = {}, 0
        for k, v in logs.items():
            n = v.numel()
            out[k] = result_value(flat[at:at + n].reshape(v.shape))
            at += n
        return out

    def fit(self, x, y, batch_size: Optional[int] = None, epochs: int = 1,
            verbose="auto", validation_split: float = 0.0, shuffle=True,
            class_weight: Optional[Dict[int, float]] = None, callbacks=None,
            initial_epoch: int = 0, validation_freq=1,
            validation_batch_size: Optional[int] = None,
            steps_per_epoch: Optional[int] = None, **kwargs) -> History:
        """Keras ``model.fit`` on numpy ``x``, ``y`` (see the module
        docstring), with Keras 3.13's ``class_weight``, ``callbacks``,
        ``initial_epoch`` (epochs run from it to ``epochs``),
        ``validation_freq``, ``validation_batch_size`` and
        ``steps_per_epoch`` (an epoch of that many batches; the order runs
        on across epochs and a new one is drawn when it is used up, an
        epoch cut short there). Other options Keras takes raise
        :class:`NotImplementedError` unless ``None``."""
        unknown = sorted(k for k, v in kwargs.items() if v is not None)
        if unknown:
            raise NotImplementedError(
                f"model.fit options {unknown} are not interpreted by the port's "
                f"workers (epochs, batch_size, verbose, validation_split, shuffle "
                f"and {', '.join(FIT_OPTIONS)} are)")
        if shuffle not in (True, False, "batch"):
            raise ValueError(f"shuffle must be True, False or 'batch', got {shuffle!r}")
        B = 32 if batch_size is None else int(batch_size)
        x, y = np.asarray(x), np.asarray(y)
        n = x.shape[0]
        n_train = int(math.floor(n * (1.0 - validation_split))) if validation_split else n
        xt, yt = _on_device(x[:n_train], self.device), _on_device(y[:n_train], self.device)
        xv, yv = _on_device(x[n_train:], self.device), _on_device(y[n_train:], self.device)
        cw = (None if not class_weight else
              torch.from_numpy(class_weights(y[:n_train], class_weight)).to(self.device))
        n_batches = -(-n_train // B)
        steps = int(steps_per_epoch) if steps_per_epoch else n_batches
        callbacks = list(callbacks or [])
        _call(callbacks, "set_model", self)
        _call(callbacks, "set_params", {"verbose": verbose, "epochs": int(epochs),
                                        "steps": steps})
        rows: List[Dict[str, torch.Tensor]] = []
        if shuffle is True and not self._peeked:
            np.random.permutation(n_train)      # Keras's peek (module docstring)
        self._peeked = True
        self.stop_training = False
        _call(callbacks, "on_train_begin", {})
        order, seen = None, n_batches           # the batch order runs on across epochs
        ran, training_logs = [], None
        for epoch in range(int(initial_epoch), int(epochs)):
            _call(callbacks, "on_epoch_begin", epoch, {})
            tot = None
            for step in range(steps):
                if seen >= n_batches:
                    if steps_per_epoch and step:
                        break                    # Keras: the data ran out
                    order = np.random.permutation(n_train) if shuffle is True else None
                    seen = 0
                start = seen * B
                stop = min(start + B, n_train)
                seen += 1
                if order is not None:
                    idx = order[start:stop]
                elif shuffle == "batch":
                    idx = np.random.permutation(stop - start) + start
                else:
                    idx = None
                _call(callbacks, "on_train_batch_begin", step, logs={})
                if idx is None:
                    xb, yb = xt[start:stop], yt[start:stop]
                    cb_ = None if cw is None else cw[start:stop]
                else:
                    sel = torch.from_numpy(idx).to(self.device)
                    xb, yb = xt[sel], yt[sel]
                    cb_ = None if cw is None else cw[sel]
                row = self._step(xb, yb) if cb_ is None else self._step(xb, yb, cb_)
                tot = row if tot is None else tot + row
                if callbacks:
                    _call(callbacks, "on_train_batch_end", step,
                          logs=self._floats(self._logs(tot)))
                    if self.stop_training:
                        break
            logs = self._logs(tot)
            if n - n_train and _should_eval(epoch, validation_freq):
                vb = B if validation_batch_size is None else int(validation_batch_size)
                logs.update(self._logs(self._evaluate(xv, yv, vb, callbacks), "val_"))
            rows.append(logs)
            ran.append(epoch)
            if callbacks:
                training_logs = self._floats(logs)
                _call(callbacks, "on_epoch_end", epoch, training_logs)
            if verbose:
                print(f"epoch {epoch + 1}/{epochs} - " + " - ".join(
                    f"{k}: {v}" for k, v in self._floats(logs).items()))
            if self.stop_training:
                break
        _call(callbacks, "on_train_end", training_logs or {})
        # one transfer for every metric of every epoch; a key missing from
        # an epoch (val_ under validation_freq) is left out of it, as
        # Keras's History leaves it
        history: Dict[str, List[Any]] = {}
        if rows:
            keys = list(dict.fromkeys(k for r in rows for k in r))
            flat = self._floats({(i, k): v for i, r in enumerate(rows) for k, v in r.items()})
            for (_, k), v in flat.items():
                history.setdefault(k, []).append(v)
            history = {k: history[k] for k in keys}
        else:
            history = {"loss": []}
        return History(history, ran)

    def train_on_batch(self, x, y):
        """Keras ``train_on_batch``: one step on the batch; the batch's loss,
        or ``[loss, *metrics]`` with metrics compiled in."""
        row = self._step(_on_device(np.asarray(x), self.device),
                         _on_device(np.asarray(y), self.device))
        out = list(self._floats(self._logs(row)).values())
        return out if len(out) > 1 else out[0]


class SparkWorker:
    """Synchronous worker: local full fit, yields a weight delta."""

    def __init__(self, json_config: str, parameters, train_config: Dict[str, Any],
                 master_optimizer, master_loss, master_metrics,
                 custom_objects: Optional[dict] = None, fault_plan=None,
                 device: DeviceLike = "cuda"):
        self.json_config = json_config
        self.parameters = parameters  # Broadcast of initial weights
        self.train_config = dict(train_config)
        self.master_optimizer = master_optimizer
        self.master_loss = master_loss
        self.master_metrics = master_metrics
        self.custom_objects = custom_objects
        # duck-typed fault plan (resilience): lets chaos tests kill this
        # worker mid-partition, after local training, before the delta is
        # yielded, so the task retry must recompute everything
        self.fault_plan = fault_plan
        self.device = device
        self.history = None

    def train(self, data_iterator: Iterator):
        data = _materialize(data_iterator)
        if data is None:
            return
        x_train, y_train = data
        batch_size = int(self.train_config.get("batch_size", 32))
        if x_train.shape[0] <= batch_size:
            # Reference quirk: partitions no larger than one batch are skipped.
            return
        ctx = TaskContext.get()
        if self.fault_plan is not None:
            self.fault_plan.straggler_stall(ctx)
        weights_before = self.parameters.value
        model = KerasReplica(
            self.json_config, weights_before, self.master_optimizer,
            self.master_loss, self.master_metrics, self.custom_objects,
            device=self.device, generator=_task_generator(ctx, self.device),
        )
        keras_history = model.fit(x_train, y_train, **self.train_config)
        # Yield the LOCAL history: one worker object serves all partition
        # threads, so instance state would cross-attribute histories.
        history = keras_history.history if keras_history is not None else None
        self.history = history
        deltas = subtract_params_np(weights_before, model.get_weights())
        if self.fault_plan is not None:
            self.fault_plan.maybe_crash_partition(ctx)
        yield deltas, history


class AsynchronousSparkWorker:
    """Async/hogwild worker: pull → local train → push delta, per frequency.

    ``history`` holds this partition's per-epoch metrics when it finishes:
    the ``model.fit`` histories of its epochs (``frequency="epoch"``), or
    the mean of its ``train_on_batch`` losses an epoch (``"batch"``)."""

    def __init__(self, json_config: str, client: BaseParameterClient,
                 train_config: Dict[str, Any], frequency: str,
                 master_optimizer, master_loss, master_metrics,
                 custom_objects: Optional[dict] = None, fault_plan=None,
                 registry=None, device: DeviceLike = "cuda"):
        self.json_config = json_config
        self.client = client
        self.train_config = dict(train_config)
        self.frequency = frequency
        self.master_optimizer = master_optimizer
        self.master_loss = master_loss
        self.master_metrics = master_metrics
        self.custom_objects = custom_objects
        # straggler-stall injection (fault_plan) and heartbeat-lease renewal
        # (registry), both duck-typed
        self.fault_plan = fault_plan
        self.registry = registry
        self.device = device
        self.history: Optional[Dict[str, List[float]]] = None

    def train(self, data_iterator: Iterator):
        data = _materialize(data_iterator)
        if data is None:
            return
        x_train, y_train = data
        batch_size = int(self.train_config.get("batch_size", 32))
        if x_train.shape[0] <= batch_size:
            return
        ctx = TaskContext.get()
        if self.fault_plan is not None:
            self.fault_plan.straggler_stall(ctx)

        def beat():
            if self.registry is not None and ctx is not None:
                self.registry.heartbeat(f"partition-{ctx.partitionId()}")

        model: Optional[KerasReplica] = None

        def pull():
            nonlocal model
            weights = self.client.get_parameters()
            if model is None:
                model = KerasReplica(
                    self.json_config, weights, self.master_optimizer,
                    self.master_loss, self.master_metrics, self.custom_objects,
                    device=self.device, generator=_task_generator(ctx, self.device))
            else:
                model.set_weights(weights)
            return weights

        epochs = int(self.train_config.get("epochs", 1))
        validation_split = float(self.train_config.get("validation_split", 0.0))
        verbose = self.train_config.get("verbose", 0)

        # Exactly-once under task retry: register this (partition, attempt)
        # with the server so a retry rolls back the failed attempt's pushes.
        # Degrades to untagged pushes when the server predates the attempt
        # API.
        task_id = None
        if ctx is not None:
            candidate = task_id_for(ctx)
            if self.client.register_attempt(candidate, ctx.attemptNumber()):
                task_id = candidate
            elif ctx.attemptNumber() > 0:
                raise RuntimeError(
                    "async task retry is not safe without the parameter "
                    "server attempt API; aborting instead of double-applying"
                    f" deltas (task {candidate}, attempt "
                    f"{ctx.attemptNumber()})"
                )

        def push(delta):
            if task_id is not None:
                # attempt-tagged: the server fences pushes from superseded
                # attempts (a zombie straggler whose backup already won)
                self.client.update_parameters_tagged(
                    task_id, delta, attempt=ctx.attemptNumber()
                )
            else:
                self.client.update_parameters(delta)

        history: Dict[str, List[float]] = {}
        if self.frequency == "epoch":
            for _epoch in range(epochs):
                beat()
                weights_before = pull()
                h = model.fit(
                    x_train, y_train, epochs=1, batch_size=batch_size,
                    verbose=verbose, validation_split=validation_split,
                )
                for k, v in h.history.items():
                    history.setdefault(k, []).extend(v)
                delta = subtract_params_np(weights_before, model.get_weights())
                push(delta)
        elif self.frequency == "batch":
            n = x_train.shape[0]
            if validation_split:
                n_val = int(n * validation_split)
                n -= n_val
            nbatch = n // batch_size
            for _epoch in range(epochs):
                indices = np.random.permutation(n)
                losses = []
                for b in range(nbatch):
                    beat()
                    idx = indices[b * batch_size:(b + 1) * batch_size]
                    weights_before = pull()
                    out = model.train_on_batch(x_train[idx], y_train[idx])
                    losses.append(out[0] if isinstance(out, list) else out)
                    delta = subtract_params_np(
                        weights_before, model.get_weights()
                    )
                    push(delta)
                if losses:
                    history.setdefault("loss", []).append(float(np.mean(losses)))
        else:
            raise ValueError(f"Unknown frequency: {self.frequency}")
        self.history = history
        if task_id is not None:
            # Clean finish: release the server-side accumulator.
            self.client.commit_attempt(task_id)
        return
        yield  # make this a generator (mapPartitions contract), yielding nothing
