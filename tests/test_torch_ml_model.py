"""The port's Spark-ML skin (``elephas_tpu_torch/ml_model.py``, ``ml/``,
``data/dataframe.py``) and DL4J aliases against the JAX package's.

- ``Row`` / ``DataFrame`` / ``SparkSession`` on the cases of
  ``tests/data/test_dataframe.py``, each case run in both packages with the
  same results.
- ``df_to_simple_rdd`` gives the reference's ``(x, y)`` pairs exactly, in
  the same partitions; ``StringIndexer`` and ``StandardScaler`` its columns
  (to 1e-12).
- The estimator's params: ``explainParams`` the same text, unknown params
  refused, ``fit(df, params)`` on a copy; ``set_keras_model`` captures the
  dicts ``keras.*.serialize`` gives, without Keras.
- An estimator fit on ``device="cpu"`` against the reference's estimator
  on the same DataFrame, a softmax and a logits head, both from the same
  initial weights (put into both ``SparkModel``s) and the JAX engine's
  epoch order (put into the port's engine): the transformer's weights
  within 1e-4 of each array's scale (the fit-parity tolerance of
  ``tests/test_torch_model_families.py``), its ``prediction`` column equal
  wherever the reference's top-2 margin rules out a near tie.
- Persistence: a file the reference's ``save`` wrote (HDF5) loads in the
  port and predicts as the reference's transformer (1e-5); the port's npz
  round-trips exactly; HDF5 without h5py raises an ImportError naming it.
- The DL4J aliases warn and set their mode.

The reference fits run once per module (``fits``), since each JAX
``SparkModel`` fit compiles its schedule.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import contextlib
import json
import random
import sys
import warnings

import jax
import keras
import numpy as np
import pytest

import elephas_tpu.ml_model as jm
import elephas_tpu_torch.ml_model as tm
from elephas_tpu import dl4j as jdl4j
from elephas_tpu.data import Row as JRow
from elephas_tpu.data import SparkContext as JSparkContext
from elephas_tpu.data import SparkSession as JSparkSession
from elephas_tpu.ml import StandardScaler as JStandardScaler
from elephas_tpu.ml import StringIndexer as JStringIndexer
from elephas_tpu.ml import df_to_simple_rdd as j_df_to_simple_rdd
from elephas_tpu.mllib import Vectors as JVectors
from elephas_tpu_torch import (ElephasEstimator, ElephasTransformer, load_ml_estimator,
                               load_ml_transformer)
from elephas_tpu_torch import dl4j
from elephas_tpu_torch.data import Row, SparkContext, SparkSession
from elephas_tpu_torch.ml import Pipeline, StandardScaler, StringIndexer, df_to_simple_rdd
from elephas_tpu_torch.mllib import Vectors
from elephas_tpu_torch.models.optimizers import _extract_lr, _normalize, keras_compiled_spec
from elephas_tpu_torch.parallel import engine as port_engine

TOL = 1e-4

PORT = dict(Row=Row, Session=lambda n: SparkSession(SparkContext(f"local[{n}]")),
            Vectors=Vectors, to_rdd=df_to_simple_rdd, StringIndexer=StringIndexer,
            StandardScaler=StandardScaler)
REF = dict(Row=JRow, Session=lambda n: JSparkSession(JSparkContext(f"local[{n}]")),
           Vectors=JVectors, to_rdd=j_df_to_simple_rdd, StringIndexer=JStringIndexer,
           StandardScaler=JStandardScaler)


@contextlib.contextmanager
def saved_global_rngs():
    """Put numpy's, Python's and Keras's global generators back afterwards,
    so that later JAX-package tests in the same process draw unseeded as
    they would without these."""
    from keras.src.backend.common import global_state
    from keras.src.random import seed_generator
    from keras.src.utils import rng_utils

    keys = (rng_utils.GLOBAL_RANDOM_SEED, seed_generator.GLOBAL_SEED_GENERATOR)
    saved = [global_state.get_global_attribute(k) for k in keys]
    np_state, py_state = np.random.get_state(), random.getstate()
    try:
        yield
    finally:
        np.random.set_state(np_state)
        random.setstate(py_state)
        for k, v in zip(keys, saved):
            global_state.set_global_attribute(k, v)


@pytest.fixture(autouse=True)
def restore_global_rngs():
    with saved_global_rngs():
        yield


def _toy(n=320, d=10, c=3, seed=42):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype("float32")
    y = np.eye(c, dtype="float32")[(x @ rng.normal(size=(d, c))).argmax(axis=1)]
    return x, y


def _frame(pkg, x, y, n_parts=4):
    rows = [pkg["Row"](features=pkg["Vectors"].dense(xi.astype("float64")),
                       label=float(yi.argmax())) for xi, yi in zip(x, y)]
    return pkg["Session"](n_parts).createDataFrame(rows)


# -- the DataFrame facade (tests/data/test_dataframe.py) -------------------------


def _row_case(pkg):
    r = pkg["Row"](features=[1, 2], label=1.0)
    with pytest.raises(AttributeError):
        _ = r.missing
    return r.label, r["features"], r.asDict(), r[1], "label" in r, len(r), list(r), repr(r)


def _select_case(pkg):
    df = pkg["Session"](8).createDataFrame([(1.0, 2.0), (3.0, 4.0)], schema=["a", "b"])
    sel = df.select("b")
    return df.columns, df.count(), sel.columns, [r.b for r in sel.collect()], \
        df.first().asDict(), [r.asDict() for r in df.take(1)]


def _with_column_case(pkg):
    df = pkg["Session"](8).createDataFrame(
        [pkg["Row"](features=pkg["Vectors"].dense([1.0, 0.0]), label=0.0),
         pkg["Row"](features=pkg["Vectors"].dense([0.0, 1.0]), label=1.0)])
    df2 = df.withColumn("prediction", lambda r: r.label + 1)
    feats = df.rdd.map(lambda r: r.features.toArray()).collect()
    return df2.columns, [r.prediction for r in df2.collect()], \
        [f.tolist() for f in feats], df2.drop("features").columns


def _random_split_case(pkg):
    df = pkg["Session"](8).createDataFrame([(float(i),) for i in range(100)], ["v"])
    a, b = df.randomSplit([0.8, 0.2], seed=1)
    return [r.v for r in a.collect()], [r.v for r in b.collect()], \
        a.rdd.getNumPartitions(), df.repartition(3).rdd.getNumPartitions()


@pytest.mark.parametrize("case", [_row_case, _select_case, _with_column_case,
                                  _random_split_case], ids=lambda f: f.__name__[1:])
def test_dataframe_cases_match_reference(case):
    assert case(PORT) == case(REF)


def test_session_builder_and_errors_match_reference():
    for pkg_session in (SparkSession, JSparkSession):
        spark = pkg_session.builder.master("local[2]").appName("t").getOrCreate()
        assert spark.sparkContext.defaultParallelism == 2
        with pytest.raises(ValueError, match="schema"):
            spark.createDataFrame([(1.0,)])
        with pytest.raises(ValueError, match="empty"):
            spark.createDataFrame([])
        with pytest.raises(TypeError):
            spark.createDataFrame([1.0])
        spark.stop()


# -- the adapter and the feature stages ------------------------------------------------


@pytest.mark.parametrize("categorical,nb_classes", [(True, 3), (True, None), (False, None)])
def test_df_to_simple_rdd_matches_reference(categorical, nb_classes):
    x, y = _toy(n=60)
    got = PORT["to_rdd"](_frame(PORT, x, y), categorical, nb_classes)
    want = REF["to_rdd"](_frame(REF, x, y), categorical, nb_classes)
    assert got.getNumPartitions() == want.getNumPartitions() == 4
    for gp, wp in zip(got.partitions(), want.partitions()):
        assert len(gp) == len(wp)
        for (gx, gy), (wx, wy) in zip(gp, wp):
            assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_feature_stages_match_reference():
    x, y = _toy(n=50)
    out = []
    for pkg in (PORT, REF):
        rows = [pkg["Row"](raw=pkg["Vectors"].dense(xi.astype("float64")),
                           category=["a", "b", "c", "b"][int(yi.argmax()) + (i % 2)])
                for i, (xi, yi) in enumerate(zip(x, y))]
        df = pkg["Session"](4).createDataFrame(rows)
        df = pkg["StringIndexer"](inputCol="category", outputCol="label").fit(df).transform(df)
        model = pkg["StandardScaler"](inputCol="raw", outputCol="scaled").fit(df)
        df = model.transform(df)
        out.append((df.columns, [r.label for r in df.collect()],
                    np.stack([r.scaled.toArray() for r in df.collect()]), model.mean,
                    model.std))
    (gc, gl, gs, gm, gsd), (wc, wl, ws, wm, wsd) = out
    assert gc == wc and gl == wl
    for a, b in ((gs, ws), (gm, wm), (gsd, wsd)):
        np.testing.assert_allclose(a, b, atol=1e-12, rtol=1e-12)


# -- the params ------------------------------------------------------------------------


def _configured(cls, **kw):
    est = cls(**kw)
    est.set_keras_model_config('{"class_name": "Sequential"}')
    est.set_loss("categorical_crossentropy")
    est.set_num_workers(4)
    est.set_mode("synchronous")
    return est


def test_params_match_reference():
    got, want = _configured(ElephasEstimator, device="cpu"), _configured(jm.ElephasEstimator)
    assert got.explainParams() == want.explainParams()
    assert got.param_values() == want.param_values()
    assert "device" not in got.param_values()
    assert [p.name for p in got.params] == [p.name for p in want.params]
    for cls in (ElephasEstimator, jm.ElephasEstimator):
        kw = {"device": "cpu"} if cls is ElephasEstimator else {}
        with pytest.raises(ValueError, match="Unknown param"):
            cls(not_a_param=1, **kw)
    tr = ElephasTransformer(device="cpu", output_col="p")
    assert tr.explainParams() == jm.ElephasTransformer(output_col="p").explainParams()


def test_fit_with_params_leaves_the_estimator_unchanged(monkeypatch):
    """``fit(df, params)`` fits a copy with ``params`` (pyspark's
    semantics); the estimator keeps its own values and device."""
    est = _configured(ElephasEstimator, device="cpu")
    seen = []
    monkeypatch.setattr(ElephasEstimator, "_fit",
                        lambda self, df: seen.append((self, self.get_epochs(),
                                                      self.device)))
    est.fit(None, {"epochs": 7})
    copy, epochs, device = seen[0]
    assert copy is not est and epochs == 7 and device == est.device
    assert est.get_epochs() == 10
    est.fit(None)
    assert seen[1][0] is est and seen[1][1] == 10


@pytest.mark.parametrize("loss", [
    "categorical_crossentropy",
    keras.losses.CategoricalCrossentropy(from_logits=True),
    keras.losses.categorical_crossentropy,
], ids=["string", "object", "function"])
@pytest.mark.parametrize("optimizer", ["adam", "sgd", keras.optimizers.RMSprop(0.01)],
                         ids=["adam", "sgd", "rmsprop"])
def test_set_keras_model_captures_what_keras_serializes(loss, optimizer):
    keras.utils.set_random_seed(0)
    m = keras.Sequential([keras.layers.Dense(3)])
    m.build((None, 4))
    m.compile(optimizer=optimizer, loss=loss)
    got = ElephasEstimator(device="cpu").set_keras_model(m)
    want = jm.ElephasEstimator().set_keras_model(m)
    assert got.param_values() == want.param_values()


@pytest.mark.parametrize("name", ["sgd", "adam", "rmsprop", "adagrad", "adamax", "nadam"])
def test_string_optimizer_takes_keras_default_rate(name):
    """The reference's estimator compiles a Keras model with the string,
    so its ``SparkModel`` reads Keras's optimizer at Keras's default rate
    (SGD 0.01, not the 0.001 a bare string maps to)."""
    want = keras.optimizers.get(name).get_config()["learning_rate"]
    assert _extract_lr(_normalize(keras_compiled_spec(name))[1]) == pytest.approx(
        want, rel=1e-7)


# -- fits against the reference's estimator ----------------------------------------------


def _jax_permutation(seed, n_workers, epoch, n_rows):
    wp = -(-n_workers // jax.device_count()) * jax.device_count()
    keys = jax.random.split(jax.random.PRNGKey(seed), wp)
    return np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(keys[w], epoch),
                                                       n_rows))
                     for w in range(n_workers)])


def _keras_model(logits):
    keras.utils.set_random_seed(3)
    m = keras.Sequential([keras.layers.Dense(32, activation="relu"),
                          keras.layers.Dense(3, activation=None if logits else "softmax")])
    m.build((None, 10))
    m.compile(optimizer="adam",
              loss=keras.losses.CategoricalCrossentropy(from_logits=True) if logits
              else "categorical_crossentropy", metrics=["accuracy"])
    return m


def _starting_from(cls, weights):
    class Seeded(cls):
        def __init__(self, model, *args, **kwargs):
            super().__init__(model, *args, **kwargs)
            self.master_network.set_weights(weights)

    return Seeded


def _estimator(cls, model, logits, **kw):
    est = cls(**kw)
    if logits:     # the example's way: the compiled model's optimizer and loss
        est.set_keras_model(model)
    else:          # the reference test's way: each param set
        est.set_keras_model_config(model.to_json())
        est.set_optimizer_config(keras.optimizers.serialize(keras.optimizers.Adam()))
        est.set_loss("categorical_crossentropy")
    est.setParams(metrics=["accuracy"], categorical=True, nb_classes=3, num_workers=4,
                  epochs=3, batch_size=16, validation_split=0.1, mode="synchronous",
                  parameter_server_mode="jax")
    return est


@pytest.fixture(scope="module")
def fits():
    """Each head fitted once by each package's estimator from the same
    weights and order: ``{logits: (port transformer, reference
    transformer, x, reference estimator)}``."""
    x, y = _toy()
    out = {}
    with saved_global_rngs(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_engine, "epoch_permutation", _jax_permutation)
        for logits in (False, True):
            model = _keras_model(logits)
            w0 = model.get_weights()
            mp.setattr(tm, "SparkModel", _starting_from(tm.SparkModel, w0))
            mp.setattr(jm, "SparkModel", _starting_from(jm.SparkModel, w0))
            port_tr = Pipeline(stages=[_estimator(ElephasEstimator, model, logits,
                                                  device="cpu")]).fit(_frame(PORT, x, y))
            ref_est = _estimator(jm.ElephasEstimator, model, logits)
            ref_tr = ref_est.fit(_frame(REF, x, y))
            out[logits] = (port_tr.stages[0], ref_tr, x, y, ref_est)
    return out


@pytest.mark.parametrize("logits", [False, True], ids=["softmax", "logits"])
def test_estimator_fit_matches_reference(fits, logits):
    port_tr, ref_tr, x, y, _ = fits[logits]
    assert isinstance(port_tr, ElephasTransformer)
    assert len(port_tr.weights) == len(ref_tr.weights) == 4
    moved = 0.0
    for got, want, start in zip(port_tr.weights, ref_tr.weights,
                                _keras_model(logits).get_weights()):
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= TOL * scale
        moved = max(moved, float(np.abs(want - start).max()) / scale)
    assert moved > 1e-2          # the fit trained
    out = port_tr.transform(_frame(PORT, x, y))
    ref_out = ref_tr.transform(_frame(REF, x, y))
    assert out.columns == ref_out.columns == ["features", "label", "prediction"]
    assert out.rdd.getNumPartitions() == ref_out.rdd.getNumPartitions()
    got = np.array([r.prediction for r in out.collect()])
    want = np.array([r.prediction for r in ref_out.collect()])
    assert got.dtype == want.dtype == np.float64
    scores = np.sort(ref_tr.get_model().predict(x, verbose=0), axis=1)
    clear = scores[:, -1] - scores[:, -2] > 1e-3
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(got[clear], want[clear])


def test_transform_column_logic_matches_reference(fits):
    """Not categorical: the first output column; an existing output column
    is replaced in place, not appended twice."""
    port_tr, ref_tr, x, y, _ = fits[False]
    port_tr = port_tr.copy({"categorical": False, "output_col": "label"})
    ref_tr = ref_tr.copy({"categorical": False, "output_col": "label"})
    got = port_tr.transform(_frame(PORT, x[:20], y[:20]))
    want = ref_tr.transform(_frame(REF, x[:20], y[:20]))
    assert got.columns == want.columns == ["features", "label"]
    np.testing.assert_allclose([r.label for r in got.collect()],
                               [r.label for r in want.collect()], atol=1e-5)


# -- persistence ------------------------------------------------------------------------


def test_reference_files_load_in_the_port(fits, tmp_path):
    port_tr, ref_tr, x, _, ref_est = fits[True]
    ref_tr.save(str(tmp_path / "t.h5"))
    ref_est.save(str(tmp_path / "e.h5"))
    tr = load_ml_transformer(str(tmp_path / "t.h5"), device="cpu")
    np.testing.assert_allclose(tr.get_model().predict(x, verbose=0),
                               ref_tr.get_model().predict(x, verbose=0), atol=1e-5, rtol=1e-5)
    assert tr.param_values() == ref_tr.param_values()
    est = load_ml_estimator(str(tmp_path / "e.h5"), device="cpu")
    assert est.param_values() == ref_est.param_values()
    with pytest.raises(ValueError, match="not an estimator"):
        load_ml_estimator(str(tmp_path / "t.h5"), device="cpu")


def test_port_files_round_trip(fits, tmp_path):
    port_tr, _, x, _, ref_est = fits[True]
    path = str(tmp_path / "t.npz")
    port_tr.save(path)
    with np.load(path) as data:
        assert str(data["elephas_kind"]) == "transformer"
        assert sorted(data.files) == ["elephas_kind", "params_json", "w0", "w1", "w2", "w3"]
        assert json.loads(str(data["params_json"])) == {
            k: v for k, v in port_tr.param_values().items() if k != "custom_objects"}
    loaded = load_ml_transformer(path, custom_objects={"k": 1}, device="cpu")
    np.testing.assert_array_equal(loaded.get_model().predict(x), port_tr.get_model().predict(x))
    assert loaded.get_custom_objects() == {"k": 1}
    est = ElephasEstimator(device="cpu", **ref_est.param_values())
    est.save(str(tmp_path / "e"))
    assert load_ml_estimator(str(tmp_path / "e"), device="cpu").param_values() == \
        est.param_values()
    with pytest.raises(ValueError, match="not a transformer"):
        load_ml_transformer(str(tmp_path / "e"), device="cpu")


def test_hdf5_file_without_h5py_names_it(fits, tmp_path, monkeypatch):
    _, ref_tr, _, _, _ = fits[True]
    ref_tr.save(str(tmp_path / "t.h5"))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        load_ml_transformer(str(tmp_path / "t.h5"), device="cpu")


# -- DL4J --------------------------------------------------------------------------------


@pytest.mark.parametrize("name,mode", [("ParameterAveragingModel", "synchronous"),
                                       ("ParameterSharingModel", "asynchronous")])
def test_dl4j_aliases_warn_and_set_their_mode(name, mode):
    m = _keras_model(False)
    with pytest.warns(UserWarning, match=f"{name} is the legacy DL4J path"):
        got = getattr(dl4j, name)(m, java_spark_context=object(), num_workers=2,
                                  device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(jdl4j, name)(m, java_spark_context=object(), num_workers=2)
    assert type(got).__name__ == type(want).__name__ == name
    assert got.mode == want.mode == mode
    assert got.get_config() == {k: v for k, v in want.get_config().items()
                                if k in got.get_config()}
    with pytest.warns(UserWarning):
        assert getattr(dl4j, name)(m, mode="hogwild", device="cpu").mode == "hogwild"
