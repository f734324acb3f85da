"""Keras 3.13's stateful metric classes in the port
(``elephas_tpu_torch/models/stateful_metrics.py``) against Keras and
``elephas_tpu.SparkModel``.

- Every class with its options (AUC on each curve and summation, from
  logits, multi-label and explicit thresholds; Precision and Recall with
  thresholds, ``top_k`` and ``class_id``; the four counts; the four
  constrained rates; F1Score and FBetaScore with each ``average`` and a
  threshold; R2Score with each aggregation and ``num_regressors``;
  RootMeanSquaredError; IoU, BinaryIoU, MeanIoU, OneHotIoU and
  OneHotMeanIoU): the state summed over three batches against Keras's
  result after the same three ``update_state`` calls, from the metric
  object and from its serialized dict.
- ``SparkModel.evaluate``'s fall-back (batches of 32) against the
  reference's over 100 rows, where the mean of the batches' results
  differs from the result: the state is a vector summed over the batches,
  not a mean.
- The host path's ``fit`` histories (the metrics and their ``val_``
  copies, a vector result as Keras logs it) against Keras ``model.fit``,
  and through ``SparkModel``'s host path against the reference's.
- The compiled path ignores these metrics, as the reference's
  ``_infer_metrics`` does.

Inputs come from numpy with a seed. Tolerance: 1e-6 (counts are exact; the
results divide them in float32 on both sides).
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import keras
import numpy as np
import pytest
import torch

from elephas_tpu import SparkModel as JSparkModel
from elephas_tpu.data import SparkContext as JSparkContext
from elephas_tpu.utils import to_simple_rdd as j_to_simple_rdd
from elephas_tpu_torch import SparkModel
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.models import losses as TL
from elephas_tpu_torch.utils import to_simple_rdd
from elephas_tpu_torch.worker import KerasReplica

TOL = 1e-6
M = keras.metrics


def _data(kind, n=50, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        y = rng.integers(0, 2, size=(n, 1)).astype(np.float32)
        p = rng.uniform(size=(n, 1)).astype(np.float32)
        p[:3], p[3], p[4] = 0.0, 1.0, 0.5          # the thresholds' ends and middle
        return y, p
    if kind == "logits":
        return (rng.integers(0, 2, size=(n, 1)).astype(np.float32),
                rng.normal(size=(n, 1)).astype(np.float32) * 2)
    if kind == "classes":
        return (np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)],
                rng.uniform(size=(n, 4)).astype(np.float32))
    if kind == "regression":
        return rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 3)).astype(
            np.float32)
    labels = rng.integers(0, 4, n).astype(np.float32)
    if kind == "sparse":
        return labels, rng.integers(0, 4, n).astype(np.float32)
    return labels, rng.uniform(size=(n, 4)).astype(np.float32)       # sparse_probs


CLASSES = [
    ("AUC", lambda: M.AUC(), "binary"),
    ("AUC-PR", lambda: M.AUC(curve="PR"), "binary"),
    ("AUC-PR-minoring", lambda: M.AUC(curve="PR", summation_method="minoring"), "binary"),
    ("AUC-ROC-majoring", lambda: M.AUC(summation_method="majoring"), "binary"),
    ("AUC-PRGAIN", lambda: M.AUC(num_thresholds=7, curve="PRGAIN"), "binary"),
    ("AUC-logits", lambda: M.AUC(from_logits=True), "logits"),
    ("AUC-multi-label", lambda: M.AUC(multi_label=True), "classes"),
    ("AUC-multi-label-PR", lambda: M.AUC(multi_label=True, curve="PR"), "classes"),
    ("AUC-label-weights", lambda: M.AUC(multi_label=True, label_weights=[1, 2, 0.5, 1]),
     "classes"),
    ("AUC-thresholds", lambda: M.AUC(thresholds=[0.2, 0.5, 0.7]), "binary"),
    ("AUC-even-thresholds", lambda: M.AUC(thresholds=[0.25, 0.5, 0.75]), "binary"),
    ("Precision", lambda: M.Precision(), "binary"),
    ("Precision-thresholds", lambda: M.Precision(thresholds=[0.3, 0.6]), "binary"),
    ("Precision-top_k", lambda: M.Precision(top_k=2), "classes"),
    ("Precision-class_id", lambda: M.Precision(class_id=1, thresholds=0.4), "classes"),
    ("Recall", lambda: M.Recall(thresholds=0.3), "binary"),
    ("Recall-top_k-class_id", lambda: M.Recall(top_k=1, class_id=2), "classes"),
    ("TruePositives", lambda: M.TruePositives(), "binary"),
    ("FalsePositives", lambda: M.FalsePositives(thresholds=[0.2, 0.8]), "binary"),
    ("TrueNegatives", lambda: M.TrueNegatives(thresholds=0.1), "binary"),
    ("FalseNegatives", lambda: M.FalseNegatives(), "binary"),
    ("PrecisionAtRecall", lambda: M.PrecisionAtRecall(0.5), "binary"),
    ("RecallAtPrecision", lambda: M.RecallAtPrecision(0.4, num_thresholds=20), "binary"),
    ("SensitivityAtSpecificity", lambda: M.SensitivityAtSpecificity(0.5), "binary"),
    ("SpecificityAtSensitivity", lambda: M.SpecificityAtSensitivity(0.5, class_id=1),
     "classes"),
    ("F1Score", lambda: M.F1Score(), "classes"),
    ("F1Score-macro-threshold", lambda: M.F1Score(average="macro", threshold=0.5),
     "classes"),
    ("F1Score-micro", lambda: M.F1Score(average="micro"), "classes"),
    ("FBetaScore-weighted", lambda: M.FBetaScore(average="weighted", beta=2.0), "classes"),
    ("R2Score", lambda: M.R2Score(), "regression"),
    ("R2Score-variance-regressors",
     lambda: M.R2Score(class_aggregation="variance_weighted_average", num_regressors=2),
     "regression"),
    ("R2Score-raw", lambda: M.R2Score(class_aggregation=None), "regression"),
    ("RootMeanSquaredError", lambda: M.RootMeanSquaredError(), "regression"),
    ("IoU", lambda: M.IoU(num_classes=4, target_class_ids=[0, 2]), "sparse"),
    ("IoU-ignore", lambda: M.IoU(num_classes=4, target_class_ids=[1, 3], ignore_class=0),
     "sparse"),
    ("BinaryIoU", lambda: M.BinaryIoU(), "binary"),
    ("BinaryIoU-threshold", lambda: M.BinaryIoU(target_class_ids=[1], threshold=0.3),
     "binary"),
    ("MeanIoU", lambda: M.MeanIoU(num_classes=4), "sparse"),
    ("MeanIoU-dense-pred", lambda: M.MeanIoU(num_classes=4, sparse_y_pred=False),
     "sparse_probs"),
    ("OneHotIoU", lambda: M.OneHotIoU(num_classes=4, target_class_ids=[1, 3]), "classes"),
    ("OneHotMeanIoU", lambda: M.OneHotMeanIoU(num_classes=4), "classes"),
]


@pytest.mark.parametrize("build,kind", [c[1:] for c in CLASSES], ids=[c[0] for c in CLASSES])
def test_stateful_class_matches_keras(build, kind):
    """Three batches (16, 16, 18 rows): the summed state's result against
    Keras's after the same three updates; the name Keras logs."""
    yt, yp = _data(kind)
    obj = build()
    for i in range(0, 50, 16):
        obj.update_state(yt[i:i + 16], yp[i:i + 16])
    want = np.asarray(obj.result())
    for form in (obj, keras.metrics.serialize(obj)):
        name, fn = TL.resolve_metric(form)
        assert name == obj.name
        tot = None
        for i in range(0, 50, 16):
            s = TL.metric_state(fn, torch.from_numpy(yt[i:i + 16]), torch.from_numpy(yp[i:i + 16]))
            tot = s if tot is None else tot + s
        got = TL.metric_result(fn, tot).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["auc", "precision", "recall", "f1_score", "r2_score",
                                  "AUC", "true_positives"])
def test_stateful_class_names_resolve_as_keras(name):
    """A class by its name or its snake-case name, as ``keras.metrics.get``
    resolves it, logged under the name given."""
    from keras.src.trainers.compile_utils import get_metric

    yt, yp = _data("regression" if name == "r2_score" else
                   "classes" if name == "f1_score" else "binary")
    km = get_metric(name, yt, yp)
    km.update_state(yt, yp)
    got_name, fn = TL.resolve_metric(name)
    assert got_name == km.name == name
    got = TL.metric_result(fn, TL.metric_state(fn, torch.from_numpy(yt), torch.from_numpy(yp)))
    np.testing.assert_allclose(got.numpy(), np.asarray(km.result()), atol=TOL, rtol=TOL)


def test_unported_metric_classes_raise_naming_part_four():
    for obj in (M.Sum(), M.Mean(), M.MeanMetricWrapper(lambda a, b: a)):
        with pytest.raises(NotImplementedError, match="item 13, part four"):
            TL.resolve_metric(obj)


def _mlp(metrics, seed=1, n_out=4):
    keras.utils.set_random_seed(seed)
    m = keras.Sequential([keras.layers.Input((8,)), keras.layers.Dense(16, activation="relu"),
                          keras.layers.Dense(n_out)])
    m.compile(optimizer=keras.optimizers.SGD(0.1),
              loss=keras.losses.CategoricalCrossentropy(from_logits=True),
              metrics=list(metrics))
    return m


def _classes(n=100, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return x, np.eye(4, dtype=np.float32)[(x @ rng.normal(size=(8, 4))).argmax(1)]


EVAL_METRICS = [lambda: M.AUC(from_logits=True), lambda: M.Precision(),
                lambda: M.F1Score(), lambda: M.MeanIoU(num_classes=4, sparse_y_true=False,
                                                       sparse_y_pred=False),
                lambda: M.RecallAtPrecision(0.3)]


def test_evaluate_fall_back_matches_the_reference_over_batches():
    """``SparkModel.evaluate`` (the Keras fall-back, batches of 32 over 100
    rows) with five stateful classes against the reference's, within
    1e-6; the batches' mean result differs from the summed state's for
    AUC, so a per-batch mean would not hold the pin."""
    x, y = _classes()
    metrics = [f() for f in EVAL_METRICS]
    want = JSparkModel(_mlp(metrics), mode="synchronous").evaluate(x, y)
    got = SparkModel(_mlp([f() for f in EVAL_METRICS]), mode="synchronous",
                     device="cpu").evaluate(x, y)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL)
    km = _mlp([])
    logits = km.predict(x, verbose=0)
    per_batch = []
    for i in range(0, 100, 32):
        auc = M.AUC(from_logits=True)
        auc.update_state(y[i:i + 32], logits[i:i + 32])
        per_batch.append(float(auc.result()))
    assert abs(np.mean(per_batch) - got[1]) > 1e-3


def test_host_fit_histories_match_keras_fit():
    """``KerasReplica.fit`` (the host path's worker) against Keras
    ``model.fit`` with AUC, Precision and F1Score: the history's metrics,
    their ``val_`` copies (F1Score's a vector a class), each epoch's state
    started anew; the weights."""
    x, y = _classes(120)
    metrics = lambda: [M.AUC(from_logits=True, name="auc"),  # noqa: E731
                       M.Precision(name="precision"), M.F1Score(name="f1_score")]
    km = _mlp(metrics())
    w0 = [np.array(w) for w in km.get_weights()]
    replica = KerasReplica(km.to_json(), w0, None, None, metrics(), device="cpu")
    fit = dict(epochs=3, batch_size=32, validation_split=0.2, verbose=0)
    np.random.seed(4)
    want = km.fit(x, y, **fit).history
    np.random.seed(4)
    got = replica.fit(x, y, **fit).history
    assert set(got) == set(want) == {p + k for p in ("", "val_")
                                     for k in ("loss", "auc", "precision", "f1_score")}
    for k in want:
        for a, b in zip(got[k], want[k]):
            assert np.shape(a) == np.shape(b), k
            np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=1e-5, err_msg=k)


def test_host_spark_fit_matches_the_reference():
    """``SparkModel``'s host path (synchronous, ``comm="host"``, two
    workers, whose Keras models compile with ``master_metrics``: here the
    names ``"auc"``, ``"recall"`` and ``"precision"``, as Keras resolves
    them) against the reference's: each worker's history, the metrics and
    their ``val_`` copies included, and the final weights."""
    x, y = _classes(160)
    names = ["auc", "recall", "precision"]
    jm = _mlp(names)
    w0 = [np.array(w) for w in jm.get_weights()]
    fit = dict(epochs=2, batch_size=32, validation_split=0.25, shuffle=False)
    np.random.seed(7)
    jsm = JSparkModel(jm, mode="synchronous", comm="host", num_workers=2, port=0,
                      master_metrics=names)
    jsm.fit(j_to_simple_rdd(JSparkContext("local[2]"), x, y), **fit)
    tm = _mlp(names)
    tm.set_weights(w0)
    np.random.seed(7)
    tsm = SparkModel(tm, mode="synchronous", comm="host", num_workers=2, port=0, device="cpu",
                     master_metrics=names)
    tsm.fit(to_simple_rdd(SparkContext("local[2]"), x, y), **fit)
    assert len(tsm.training_histories) == len(jsm.training_histories) == 2
    for got, want in zip(tsm.training_histories, jsm.training_histories):
        assert set(got) == set(want) == {p + k for p in ("", "val_")
                                         for k in ["loss"] + names}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=1e-5, err_msg=k)
    for a, b in zip(tsm.master_network.get_weights(), jsm.master_network.get_weights()):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=1e-5)


def test_compiled_fit_ignores_stateful_metrics_as_the_reference():
    """The compiled path's history holds the loss alone (and its ``val_``
    copy) for a model compiled with AUC and Precision, as the reference's
    (its ``_infer_metrics`` keeps accuracy only)."""
    x, y = _classes(64)
    kw = dict(mode="synchronous", num_workers=2)
    jsm = JSparkModel(_mlp([M.AUC(), M.Precision()]), **kw)
    jsm.fit(j_to_simple_rdd(JSparkContext("local[2]"), x, y), epochs=1, batch_size=16)
    tsm = SparkModel(_mlp([M.AUC(), M.Precision()]), device="cpu", **kw)
    tsm.fit(to_simple_rdd(SparkContext("local[2]"), x, y), epochs=1, batch_size=16)
    assert set(tsm.training_histories[-1]) == set(jsm.training_histories[-1]) == {
        "loss", "val_loss"}
