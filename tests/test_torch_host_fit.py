"""The port's host parameter-server path (``elephas_tpu_torch/worker.py`` and
``SparkModel``'s host fits) against the JAX package's.

- The reference's host cells of ``tests/integration/test_spark_model.py``'s
  matrix, the native server, synchronous ``comm="host"`` and a compressed
  cell: each fits on ``device="cpu"`` with a falling loss and a better
  accuracy.
- Parity with the reference's host path: the same Keras model and weights,
  one worker (asynchronous http, epoch and batch) and four (synchronous
  ``comm="host"``), ``shuffle=False``, no dropout, SGD and Adam; both
  packages draw their orders from the same seeded ``np.random`` (the
  asynchronous epoch workers shuffle whatever ``shuffle`` says, as the
  reference's do). Tolerance: every weight within atol 1e-6 + rtol 1e-5,
  the synchronous histories the same (float32 matmuls in two libraries
  over 54 steps; the port follows Keras's own Adam and SGD rules, and
  optax's Adam misses this pin by three orders of magnitude).
- ``KerasReplica.fit`` against Keras ``model.fit``: the validation rows,
  the last partial batch, Keras's shuffle draws and History.
- The server's pull and push counts against the schedule, a worker error
  failing the run after the RDD's task retries, and ``SparkModel(json)``
  with the reference's defaults.

Every server binds port 0.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import json
import random

import keras
import numpy as np
import pytest

from elephas_tpu import SparkModel as JSparkModel
from elephas_tpu.data import SparkContext as JSparkContext
from elephas_tpu.utils import to_simple_rdd as j_to_simple_rdd
from elephas_tpu_torch import SparkModel
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.data.rdd import TaskFailedError
from elephas_tpu_torch.parameter.native import native_available
from elephas_tpu_torch.utils import to_simple_rdd
from elephas_tpu_torch.worker import KerasReplica

from .conftest import make_classifier

ATOL, RTOL = 1e-6, 1e-5


@pytest.fixture(autouse=True)
def restore_global_rngs():
    """Each test starts from ``keras.utils.set_random_seed(0)`` (its Keras
    models initialise unseeded otherwise) and seeds numpy, Python and Keras
    globally (the reference's host workers shuffle from the global
    ``np.random``); every global generator is put back afterwards, so that
    tests of the JAX package which run later in the same process and draw
    unseeded see what they would have seen without these."""
    from keras.src.backend.common import global_state
    from keras.src.random import seed_generator
    from keras.src.utils import rng_utils

    keys = (rng_utils.GLOBAL_RANDOM_SEED, seed_generator.GLOBAL_SEED_GENERATOR)
    saved = [global_state.get_global_attribute(k) for k in keys]
    np_state, py_state = np.random.get_state(), random.getstate()
    keras.utils.set_random_seed(0)
    yield
    np.random.set_state(np_state)
    random.setstate(py_state)
    for k, v in zip(keys, saved):
        global_state.set_global_attribute(k, v)


def _accuracy(sm, x, y):
    return float((sm.predict(x).argmax(1) == y.argmax(1)).mean())


HOST_CELLS = [
    # the reference's host rows (mode, ps_mode, frequency), then the port's others
    ("asynchronous", "http", "epoch"),
    ("asynchronous", "http", "batch"),
    ("asynchronous", "socket", "epoch"),
    ("hogwild", "http", "epoch"),
    ("hogwild", "socket", "batch"),
    ("asynchronous", "native", "batch"),
    ("hogwild", "native", "epoch"),
]


@pytest.mark.parametrize("mode,ps_mode,frequency", HOST_CELLS)
def test_host_training_matrix(mode, ps_mode, frequency, toy_classification):
    if ps_mode == "native" and not native_available():
        pytest.skip("native parameter server unavailable (no C++ toolchain)")
    x, y = toy_classification
    sm = SparkModel(make_classifier(), mode=mode, frequency=frequency,
                    parameter_server_mode=ps_mode, num_workers=4, port=0,
                    merge="mean", device="cpu")
    base = _accuracy(sm, x, y)
    sm.fit(to_simple_rdd(SparkContext("local[4]"), x, y), epochs=4, batch_size=16,
           validation_split=0.0)
    assert sm.comm == "host"
    assert len(sm.training_histories) == 4
    for hist in sm.training_histories:
        assert np.isfinite(hist["loss"]).all()
        assert hist["loss"][-1] < hist["loss"][0], hist
    acc = _accuracy(sm, x, y)
    assert acc > max(base, 0.34), f"no improvement: {base} -> {acc}"


@pytest.mark.parametrize("kw", [dict(mode="synchronous", comm="host"),
                                dict(mode="asynchronous", compression="int8"),
                                dict(mode="hogwild", parameter_server_mode="socket",
                                     compression="topk:0.5")],
                         ids=["sync-host", "int8", "topk"])
def test_host_sync_and_compressed_fits(kw, toy_classification):
    x, y = toy_classification
    sm = SparkModel(make_classifier(), num_workers=4, port=0, device="cpu", **kw)
    base = _accuracy(sm, x, y)
    sm.fit(to_simple_rdd(SparkContext("local[4]"), x, y), epochs=4, batch_size=16,
           validation_split=0.1)
    assert all(h["loss"][-1] < h["loss"][0] for h in sm.training_histories)
    assert set(sm.training_histories[0]) == {"loss", "val_loss"}
    assert _accuracy(sm, x, y) > max(base, 0.34)


@pytest.mark.parametrize("kw,match", [
    (dict(mode="synchronous", compression="int8"), "compression"),
    (dict(mode="asynchronous", parameter_server_mode="jax", compression="int8"),
     "compression"),
    (dict(mode="asynchronous", compression="gzip"), "compression spec"),
])
def test_compression_validated_eagerly_as_the_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        JSparkModel(make_classifier(), **kw)
    with pytest.raises(ValueError, match=match):
        SparkModel(make_classifier(), device="cpu", **kw)


# -- parity with the reference's host path -----------------------------------------


PARITY = [(dict(mode="asynchronous", frequency="epoch"), 1),
          (dict(mode="asynchronous", frequency="batch"), 1),
          (dict(mode="synchronous", comm="host"), 4)]


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("kw,workers", PARITY, ids=["async-epoch", "async-batch", "sync"])
def test_host_path_matches_reference(kw, workers, optimizer, toy_classification):
    x, y = toy_classification
    keras.utils.set_random_seed(3)
    jm = make_classifier(optimizer=optimizer)
    w0 = [np.array(w) for w in jm.get_weights()]
    fit = dict(epochs=3, batch_size=32, validation_split=0.1, shuffle=False)
    np.random.seed(7)
    jsm = JSparkModel(jm, num_workers=workers, port=0, **kw)
    jsm.fit(j_to_simple_rdd(JSparkContext(f"local[{workers}]"), x, y), **fit)
    tm = make_classifier(optimizer=optimizer)
    tm.set_weights(w0)
    np.random.seed(7)
    tsm = SparkModel(tm, num_workers=workers, port=0, device="cpu", **kw)
    tsm.fit(to_simple_rdd(SparkContext(f"local[{workers}]"), x, y), **fit)
    for got, want in zip(tsm.master_network.get_weights(),
                         jsm.master_network.get_weights()):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    if kw["mode"] == "synchronous":
        assert len(tsm.training_histories) == len(jsm.training_histories) == workers
        for got, want in zip(tsm.training_histories, jsm.training_histories):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shuffle", [True, False])
def test_replica_fit_follows_keras_fit(shuffle):
    """``KerasReplica.fit`` against Keras ``model.fit`` on 203 rows (a
    partial last batch, a validation split that is not a whole number of
    rows) with an accuracy metric: the same History and weights."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(203, 6)).astype("float32")
    y = np.eye(3, dtype="float32")[rng.integers(0, 3, 203)]
    keras.utils.set_random_seed(1)
    km = keras.Sequential([keras.layers.Dense(8, activation="tanh"),
                           keras.layers.Dense(3, activation="softmax")])
    km.build((None, 6))
    km.compile("adam", "categorical_crossentropy", metrics=["accuracy"])
    w0 = [np.array(w) for w in km.get_weights()]
    replica = KerasReplica(km.to_json(), w0, "adam", "categorical_crossentropy",
                           ["accuracy"], device="cpu")
    fit = dict(epochs=3, batch_size=32, validation_split=0.15, shuffle=shuffle, verbose=0)
    np.random.seed(11)
    want = km.fit(x, y, **fit).history
    np.random.seed(11)
    got = replica.fit(x, y, **fit).history
    assert set(got) == set(want) == {"loss", "accuracy", "val_loss", "val_accuracy"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL)
    for a, b in zip(replica.get_weights(), km.get_weights()):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=RTOL)
    with pytest.raises(NotImplementedError, match="class_weight"):
        replica.fit(x, y, class_weight={0: 1.0})


# -- the schedule, failures and defaults ----------------------------------------------


@pytest.mark.parametrize("frequency", ["epoch", "batch"])
def test_server_counts_match_the_schedule(frequency, toy_classification):
    """W workers, E epochs: one pull and one push per worker and epoch
    (``"epoch"``) or batch (``"batch"``: ``(n - int(n * split)) // B``
    batches a partition), plus the fit's final pull."""
    x, y = toy_classification
    W, E, B, split = 2, 2, 32, 0.1
    sm = SparkModel(make_classifier(), num_workers=W, frequency=frequency, port=0,
                    device="cpu")
    sm.fit(to_simple_rdd(SparkContext(f"local[{W}]"), x, y), epochs=E, batch_size=B,
           validation_split=split)
    per = len(x) // W
    steps = 1 if frequency == "epoch" else (per - int(per * split)) // B
    stats = sm.membership_snapshot()["parameter_servers"]["primary"]
    assert stats["version"] == W * E * steps
    assert stats["pulls"] == W * E * steps + 1
    assert sorted(stats["applied_tagged"].values()) == [E * steps] * W


def test_worker_error_fails_the_run_after_task_retries(monkeypatch, toy_classification):
    """A step that raises in every attempt fails the fit with
    ``TaskFailedError`` after ``maxTaskFailures`` attempts, and the server
    is stopped."""
    x, y = toy_classification
    calls = []

    def broken(self, xb, yb):
        calls.append(1)
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(KerasReplica, "_step", broken)
    sm = SparkModel(make_classifier(), num_workers=1, port=0, device="cpu")
    sc = SparkContext("local[1]")
    with pytest.raises(TaskFailedError, match="kernel failed"):
        sm.fit(to_simple_rdd(sc, x, y), epochs=1, batch_size=32)
    assert len(calls) == sc.maxTaskFailures
    assert sm._server is None


@pytest.mark.parametrize("ps_mode", ["http", "socket"])
def test_server_binds_loopback_and_keeps_the_requested_port(ps_mode, toy_classification):
    """The servers listen on ``ps_bind_host`` (127.0.0.1 unless asked
    otherwise); ``port=0`` stays asked for, so each fit binds a fresh OS
    port."""
    x, y = toy_classification
    sm = SparkModel(make_classifier(), num_workers=1, parameter_server_mode=ps_mode,
                    port=0, device="cpu")
    sm.start_server()
    try:
        server = sm._server
        sock = server._httpd.socket if ps_mode == "http" else server._sock
        assert sock.getsockname()[0] == "127.0.0.1" and sm._server_port == server.port
        assert sm.port == 0 and sm.get_config()["port"] == 0
    finally:
        sm.stop_server()
    sm.fit(to_simple_rdd(SparkContext("local[1]"), x, y), epochs=1, batch_size=32)
    assert sm.port == 0
    wide = SparkModel(make_classifier(), num_workers=1, parameter_server_mode=ps_mode,
                      port=0, ps_bind_host="127.0.0.2", device="cpu")
    wide.start_server()
    try:
        server = wide._server
        sock = server._httpd.socket if ps_mode == "http" else server._sock
        assert sock.getsockname()[0] == "127.0.0.2"
    finally:
        wide.stop_server()


def test_reference_defaults_construct_and_fit(toy_classification):
    """``SparkModel(json)`` as the reference writes it: asynchronous, http,
    epoch, one worker a device."""
    x, y = toy_classification
    cfg = json.loads(make_classifier().to_json())
    sm = SparkModel(json.dumps(cfg), port=0, device="cpu")
    assert (sm.mode, sm.parameter_server_mode, sm.comm, sm.frequency) == \
        ("asynchronous", "http", "host", "epoch")
    sm.fit(to_simple_rdd(SparkContext("local[2]"), x, y), epochs=3, batch_size=32)
    assert len(sm.training_histories) == 1
    assert sm.training_histories[0]["loss"][-1] < sm.training_histories[0]["loss"][0]
