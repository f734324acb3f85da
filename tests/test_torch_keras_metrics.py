"""The Keras metrics, ``evaluate``'s Keras fall-back and the host path's
``model.fit`` options in the port, against Keras and the JAX package on
seeded numpy inputs.

- Every metric the port resolves (each function of ``keras.metrics`` of
  Keras 3.13, the aliases, the mean-metric classes with their options)
  against Keras's metric object on the same batch: Keras's ``Mean`` of the
  values within 1e-5; ``"accuracy"`` by the shapes of ``y_true`` and
  ``y_pred``, exactly.
- ``SparkModel.evaluate``: the reference's three fall-back tests
  (``tests/integration/test_spark_model.py:144-190``) at their 1e-5, and a
  correlation metric over 100 rows (batches of 32, the last of 4).
- Host-path histories, ``class_weight``, ``initial_epoch``,
  ``validation_freq``, ``validation_batch_size``, ``steps_per_epoch`` and
  callbacks (``History``, ``LambdaCallback``, ``EarlyStopping``) of the
  port's ``KerasReplica.fit`` against Keras ``model.fit`` (what the
  reference's workers run) from the same weights and the same seeded
  ``np.random``, and through ``SparkModel``'s host path against
  ``elephas_tpu.SparkModel``'s: atol 1e-6 + rtol 1e-5, as
  ``tests/test_torch_host_fit.py`` holds the host path.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import keras
import numpy as np
import pytest
import torch

from elephas_tpu import SparkModel as JSparkModel
from elephas_tpu.data import SparkContext as JSparkContext
from elephas_tpu.models.adapters import compile_metric_names as j_names
from elephas_tpu.utils import to_simple_rdd as j_to_simple_rdd
from elephas_tpu_torch import SparkModel
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.models import losses as TL
from elephas_tpu_torch.models.adapters import compile_metric_names
from elephas_tpu_torch.utils import to_simple_rdd
from elephas_tpu_torch.worker import KerasReplica

from .conftest import make_classifier
from .test_torch_host_fit import restore_global_rngs  # noqa: F401  (autouse fixture)

TOL = 1e-5
ATOL, RTOL = 1e-6, 1e-5


def _batch(kind, rng, B=20, C=5):
    if kind == "onehot":
        return (np.eye(C, dtype=np.float32)[rng.integers(0, C, B)],
                rng.normal(size=(B, C)).astype(np.float32))
    if kind == "probs":
        p = rng.random((B, C)).astype(np.float32) + 0.05
        return (np.eye(C, dtype=np.float32)[rng.integers(0, C, B)],
                (p / p.sum(-1, keepdims=True)).astype(np.float32))
    if kind == "sparse":
        p = rng.random((B, C)).astype(np.float32) + 0.05
        return (rng.integers(0, C, size=(B, 1)).astype(np.float32),
                (p / p.sum(-1, keepdims=True)).astype(np.float32))
    if kind == "binary":
        return (rng.integers(0, 2, size=(B, 3)).astype(np.float32),
                rng.random((B, 3)).astype(np.float32))
    if kind == "positive":
        return (rng.random((B, 4)).astype(np.float32) * 3,
                rng.random((B, 4)).astype(np.float32) + 0.1)
    return (rng.normal(size=(B, 4)).astype(np.float32) * 2,
            rng.normal(size=(B, 4)).astype(np.float32))


# (spec, data kind): every function of keras.metrics, the aliases, and
# serialized mean-metric classes with options
METRICS = [
    ("binary_accuracy", "binary"), ("categorical_accuracy", "onehot"),
    ("sparse_categorical_accuracy", "sparse"), ("top_k_categorical_accuracy", "onehot"),
    ("sparse_top_k_categorical_accuracy", "sparse"), ("binary_crossentropy", "binary"),
    ("categorical_crossentropy", "probs"), ("sparse_categorical_crossentropy", "sparse"),
    (keras.metrics.binary_focal_crossentropy, "binary"),
    (keras.metrics.categorical_focal_crossentropy, "probs"),
    ("hinge", "binary"), ("squared_hinge", "binary"), ("categorical_hinge", "onehot"),
    (keras.metrics.huber, "regression"), ("kl_divergence", "probs"),
    (keras.metrics.log_cosh, "regression"), ("log_cosh_error", "regression"),
    ("mean_absolute_error", "regression"), ("mean_absolute_percentage_error", "regression"),
    ("mean_squared_error", "regression"), ("mean_squared_logarithmic_error", "positive"),
    ("poisson", "positive"), ("pearson_correlation", "regression"),
    ("concordance_correlation", "regression"),
    ("mae", "regression"), ("mse", "regression"), ("mape", "regression"),
    ("msle", "positive"), ("acc", "onehot"), ("accuracy", "sparse"), ("accuracy", "binary"),
    (lambda: keras.metrics.TopKCategoricalAccuracy(k=2), "onehot"),
    (lambda: keras.metrics.SparseTopKCategoricalAccuracy(k=3), "sparse"),
    (lambda: keras.metrics.BinaryAccuracy(threshold=0.3), "binary"),
    (lambda: keras.metrics.CategoricalCrossentropy(from_logits=True, label_smoothing=0.1),
     "onehot"),
    (lambda: keras.metrics.PearsonCorrelation(axis=-1), "regression"),
    (lambda: keras.metrics.CosineSimilarity(), "regression"),
    (lambda: keras.metrics.LogCoshError(), "regression"),
    (lambda: keras.metrics.MeanSquaredError(), "regression"),
]


def _is_function(spec):
    return callable(spec) and spec.__name__ in TL.KERAS_METRICS


def _metric_id(case):
    spec, kind = case
    name = (spec if isinstance(spec, str) else spec.__name__ if _is_function(spec)
            else type(spec()).__name__)
    return f"{name}-{kind}"


@pytest.mark.parametrize("spec,kind", METRICS, ids=[_metric_id(c) for c in METRICS])
def test_metric_matches_keras(spec, kind):
    """The port's value of the metric against Keras's compiled metric (what
    ``compile(metrics=[spec])`` builds for this batch) over two batches;
    the port reads a metric class or a function from its serialized dict."""
    from keras.src.trainers.compile_utils import get_metric

    rng = np.random.default_rng(len(_metric_id((spec, kind))))
    batches = [_batch(kind, rng), _batch(kind, rng, B=7)]
    keras_spec = spec if isinstance(spec, str) or _is_function(spec) else spec()
    port_spec = spec if isinstance(spec, str) else keras.metrics.serialize(keras_spec)
    km = get_metric(keras_spec, *batches[0])
    name, fn = TL.resolve_metric(port_spec)
    assert name == km.name
    total, count = 0.0, 0
    for yt, yp in batches:
        km.update_state(yt, yp)
        s, c = TL.metric_sums(fn(torch.from_numpy(yt), torch.from_numpy(yp)))
        total, count = total + float(s), count + c
    np.testing.assert_allclose(total / count, float(km.result()), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("spec", [lambda: keras.metrics.AUC(), lambda: keras.metrics.Precision(),
                                  lambda: keras.metrics.Recall(),
                                  lambda: keras.metrics.F1Score(),
                                  lambda: keras.metrics.MeanIoU(num_classes=2),
                                  lambda: keras.metrics.R2Score(),
                                  lambda: keras.metrics.RootMeanSquaredError()],
                         ids=["AUC", "Precision", "Recall", "F1Score", "MeanIoU", "R2Score",
                              "RootMeanSquaredError"])
def test_stateful_metric_classes_raise_naming_item_13(spec):
    """The stateful classes this test once found refused are ported: each,
    as an object and from its serialized dict, resolves to a metric whose
    state summed over three batches gives Keras's result after the same
    three ``update_state`` calls, within 1e-6 (``tests/test_torch_stateful_metrics.py``
    holds every class and option). A class still unported raises naming
    part four of item 13."""
    rng = np.random.default_rng(5)
    obj = spec()
    if isinstance(obj, (keras.metrics.F1Score, keras.metrics.R2Score,
                        keras.metrics.RootMeanSquaredError)):
        yt = rng.normal(size=(40, 3)).astype(np.float32)
        if isinstance(obj, keras.metrics.F1Score):
            yt = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 40)]
        yp = rng.uniform(size=(40, 3)).astype(np.float32)
    else:
        yt = rng.integers(0, 2, size=(40, 1)).astype(np.float32)
        yp = rng.uniform(size=(40, 1)).astype(np.float32)
    for i in range(0, 40, 16):
        obj.update_state(yt[i:i + 16], yp[i:i + 16])
    want = np.asarray(obj.result())
    for form in (obj, keras.metrics.serialize(obj)):
        name, fn = TL.resolve_metric(form)
        assert name == obj.name
        tot = sum(TL.metric_state(fn, torch.from_numpy(yt[i:i + 16]),
                                  torch.from_numpy(yp[i:i + 16])) for i in range(0, 40, 16))
        np.testing.assert_allclose(TL.metric_result(fn, tot).numpy(), want, atol=1e-6,
                                   rtol=1e-6)
    with pytest.raises(NotImplementedError, match="item 13, part four"):
        TL.resolve_metric(keras.metrics.Sum())


def test_function_only_metric_names_do_not_resolve():
    """Keras resolves ``huber``, ``log_cosh`` and the focal crossentropies
    from their functions, not from their names: both refuse the strings."""
    from keras.src.trainers.compile_utils import get_metric

    yt, yp = _batch("regression", np.random.default_rng(0))
    for name in ("huber", "log_cosh", "binary_focal_crossentropy",
                 "categorical_focal_crossentropy"):
        with pytest.raises(ValueError, match="interpret"):
            get_metric(name, yt, yp)
        with pytest.raises(ValueError, match="interpret"):
            TL.resolve_metric(name)


def test_compile_metric_names_reads_json_and_live_models():
    """The module-level function at the reference's path: a live model
    (read duck-typed through its JSON), its JSON string and the adapter
    give the reference's ``(metrics, weighted_metrics)``."""
    m = keras.Sequential([keras.layers.Dense(16, activation="relu"), keras.layers.Dense(3)])
    m.build((None, 10))
    m.compile("adam", "mse", metrics=["mae", keras.metrics.MeanSquaredError(name="m2")],
              weighted_metrics=["accuracy"])
    want = j_names(m)
    assert want == (["mae", "m2"], ["accuracy"])
    assert compile_metric_names(m) == want
    assert compile_metric_names(m.to_json()) == want
    sm = SparkModel(m, mode="synchronous", num_workers=2, device="cpu")
    assert compile_metric_names(sm.master_network) == want
    assert sm.master_network.compile_metric_names() == want


# -- evaluate's Keras fall-back: the reference's three tests, and a correlation --


def _regressor(**compile_kw):
    m = keras.Sequential([keras.layers.Dense(16, activation="relu"), keras.layers.Dense(3)])
    m.build((None, 10))
    m.compile(optimizer="adam", loss="mse", **compile_kw)
    return m


@pytest.mark.parametrize("case", ["metrics", "weighted_metrics", "master_metrics"])
def test_evaluate_falls_back_as_the_reference(case, toy_classification):
    """``test_evaluate_non_accuracy_metrics_fall_back``,
    ``test_evaluate_weighted_metrics_fall_back`` and
    ``test_evaluate_master_metrics_override_falls_back`` on the port: the
    Keras return shape and values within 1e-5, as in the reference; the
    reference's ``SparkModel.evaluate`` gives the same."""
    x, y = toy_classification
    if case == "master_metrics":
        model = make_classifier()
        kw = dict(master_metrics=["mae"])
    else:
        model = _regressor(**{case: ["mae"]})
        kw = {}
    ref = model.evaluate(x, y, verbose=0)
    got = SparkModel(model, mode="synchronous", num_workers=4, device="cpu", **kw
                     ).evaluate(x, y)
    assert isinstance(got, list) and len(got) == len(ref)
    assert np.allclose(got, ref, atol=1e-5)
    jgot = JSparkModel(model, mode="synchronous", num_workers=4, **kw).evaluate(x, y)
    np.testing.assert_allclose(got, jgot, atol=1e-5)


def test_evaluate_correlation_and_mixed_metrics_over_ragged_batches():
    """100 rows (three batches of 32 and one of 4, Keras's default batch):
    loss, a correlation, top-k and accuracy by shape in Keras's order,
    metrics then weighted metrics; the host path falls back too."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(100, 10)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 100)]
    m = keras.Sequential([keras.layers.Dense(16, activation="relu"),
                          keras.layers.Dense(3, activation="softmax")])
    m.build((None, 10))
    m.compile("adam", "categorical_crossentropy",
              metrics=["pearson_correlation", "accuracy", "top_k_categorical_accuracy"],
              weighted_metrics=["concordance_correlation"])
    ref = m.evaluate(x, y, verbose=0)
    assert len(ref) == 5
    for kw in (dict(mode="synchronous"), dict(mode="asynchronous", port=0)):
        got = SparkModel(m, num_workers=2, device="cpu", **kw).evaluate(x, y)
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_loss_object_evaluates_per_batch():
    """A Loss object's scalar is its batch's: Keras averages the batches'
    scalars weighted by their rows, so the fall-back's 32-row batches
    decide the value of ``Dice``. (A metric whose name holds "accuracy"
    would keep the compiled path, whose accuracy follows the loss's name,
    in both packages.)"""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(70, 10)).astype(np.float32)
    y = rng.integers(0, 2, size=(70, 3)).astype(np.float32)
    m = keras.Sequential([keras.layers.Dense(3, activation="sigmoid")])
    m.build((None, 10))
    m.compile("adam", keras.losses.Dice(), metrics=["mae"])
    ref = m.evaluate(x, y, verbose=0)
    got = SparkModel(m, mode="synchronous", num_workers=2, device="cpu").evaluate(x, y)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


# -- the host path's Keras fit: histories and options ---------------------------------


def _replica_and_keras(metrics=("mae", "accuracy"), optimizer="adam", seed=3):
    keras.utils.set_random_seed(seed)
    km = make_classifier(optimizer=optimizer)
    km.compile(optimizer=km.optimizer, loss=km.loss, metrics=list(metrics))
    w0 = [np.array(w) for w in km.get_weights()]
    replica = KerasReplica(km.to_json(), w0, optimizer, km.loss, list(metrics),
                           device="cpu")
    return replica, km


def _assert_history(got, want):
    assert list(got) == list(want) or set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)


OPTIONS = {
    "metrics": dict(),
    "class_weight": dict(class_weight={0: 0.5, 1: 2.0, 2: 1.5}),
    "initial_epoch": dict(initial_epoch=1),
    "validation_freq": dict(validation_freq=2),
    "validation_batch_size": dict(validation_batch_size=7),
    "steps_per_epoch": dict(steps_per_epoch=5),
    "steps_past_the_data": dict(steps_per_epoch=40),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_replica_fit_options_follow_keras_fit(option, toy_classification):
    """Each option of Keras 3.13's ``fit`` the port takes, with compiled
    metrics logged (and their ``val_`` copies): the history's keys and
    values, its epochs and the final weights against Keras ``fit`` from
    the same weights and ``np.random`` state."""
    x, y = toy_classification
    x, y = x[:300], y[:300]
    replica, km = _replica_and_keras(("mae", "accuracy", "top_k_categorical_accuracy"))
    fit = dict(epochs=3, batch_size=32, validation_split=0.2, verbose=0, **OPTIONS[option])
    np.random.seed(11)
    with pytest.warns(UserWarning) if option == "steps_past_the_data" else _nothing():
        want = km.fit(x, y, **fit)
    np.random.seed(11)
    got = replica.fit(x, y, **fit)
    _assert_history(got.history, want.history)
    assert got.epoch == want.epoch
    for a, b in zip(replica.get_weights(), km.get_weights()):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=RTOL)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_replica_callbacks_follow_keras(toy_classification):
    """The same Keras ``History``, ``LambdaCallback`` (recording every hook
    and its logs) and ``EarlyStopping`` objects handed to Keras ``fit`` and
    to the port's replica: the same hooks in the same order with the same
    logs (floats), the same stopping epoch, and ``restore_best_weights``
    restoring the same weights."""
    x, y = toy_classification
    x, y = x[:256], y[:256]

    def run(model):
        calls = []
        hooks = {h: (lambda h: lambda *a, **k: calls.append((h, a + tuple(k.values()))))(h)
                 for h in (
            "on_train_begin", "on_train_end", "on_epoch_begin", "on_epoch_end",
            "on_train_batch_begin", "on_train_batch_end")}
        hist = keras.callbacks.History()
        stop = keras.callbacks.EarlyStopping(monitor="val_loss", min_delta=0.05,
                                             patience=1, restore_best_weights=True)
        np.random.seed(5)
        out = model.fit(x, y, epochs=8, batch_size=64, validation_split=0.25, verbose=0,
                        callbacks=[hist, keras.callbacks.LambdaCallback(**hooks), stop])
        return calls, hist, stop, out

    replica, km = _replica_and_keras(("accuracy",), optimizer="sgd")
    want_calls, want_hist, want_stop, want_out = run(km)
    got_calls, got_hist, got_stop, got_out = run(replica)
    assert [c[0] for c in got_calls] == [c[0] for c in want_calls]
    assert got_stop.stopped_epoch == want_stop.stopped_epoch > 0
    assert len(got_hist.epoch) == len(want_hist.epoch) < 8
    _assert_history(got_hist.history, want_hist.history)
    _assert_history(got_out.history, want_out.history)
    for (name, a), (_, b) in zip(got_calls, want_calls):
        if isinstance(b[-1], dict):
            assert a[:-1] == b[:-1] and set(a[-1]) == set(b[-1])
            assert all(isinstance(v, float) for v in a[-1].values())
            np.testing.assert_allclose([a[-1][k] for k in b[-1]], list(b[-1].values()),
                                       atol=ATOL, rtol=RTOL)
    for a, b in zip(replica.get_weights(), km.get_weights()):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=RTOL)


def test_host_path_histories_and_options_match_reference(toy_classification):
    """``SparkModel``'s synchronous host path (``comm="host"``, one worker:
    the callback objects are shared by every worker's thread)
    with ``master_metrics`` and Keras ``fit`` options riding in ``fit``'s
    keyword arguments: every worker's history (keys, values) and the merged
    weights against ``elephas_tpu.SparkModel``'s; the same early stop."""
    x, y = toy_classification
    keras.utils.set_random_seed(3)
    jm = make_classifier(optimizer="adam")
    w0 = [np.array(w) for w in jm.get_weights()]
    kw = dict(mode="synchronous", comm="host", num_workers=1, port=0,
              master_metrics=["mae", "accuracy"])
    fit = dict(epochs=4, batch_size=32, validation_split=0.1, shuffle=False,
               class_weight={0: 2.0, 2: 0.5}, validation_freq=2,
               callbacks=[keras.callbacks.EarlyStopping(monitor="loss", min_delta=10.0,
                                                        patience=1)])
    np.random.seed(7)
    jsm = JSparkModel(jm, **kw)
    jsm.fit(j_to_simple_rdd(JSparkContext("local[1]"), x, y), **fit)
    tm = make_classifier(optimizer="adam")
    tm.set_weights(w0)
    np.random.seed(7)
    tsm = SparkModel(tm, device="cpu", **kw)
    tsm.fit(to_simple_rdd(SparkContext("local[1]"), x, y), **fit)
    assert len(tsm.training_histories) == len(jsm.training_histories) == 1
    for got, want in zip(tsm.training_histories, jsm.training_histories):
        assert set(got) == set(want) >= {"loss", "mae", "accuracy", "val_loss"}
        assert len(got["loss"]) == 2          # stopped after its second epoch
        _assert_history(got, want)
    for a, b in zip(tsm.master_network.get_weights(), jsm.master_network.get_weights()):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=RTOL)
