"""The port's MLP fit surface against the JAX package: the Keras-free
adapter (``elephas_tpu_torch/models/adapters.py``) against Keras's own
``model.predict``, the committed MNIST-MLP JSON, ``SparkModel.predict`` /
``evaluate`` and ``SparkMLlibModel`` against the JAX ``SparkModel`` after
the same fit, dropout's keep share and scale, and every part of the
reference that the port refuses with :class:`NotImplementedError`.

Tolerances: forwards within atol = rtol = 1e-5 of Keras (float32 matmuls
and activations in another library); after a fit, atol = rtol = 1e-5 as
in ``tests/test_torch_engine.py``.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import json
from pathlib import Path

import jax
import keras
import numpy as np
import pytest
import torch

from elephas_tpu import SparkMLlibModel as JSparkMLlibModel
from elephas_tpu import SparkModel as JSparkModel
from elephas_tpu.data import SparkContext as JSparkContext
from elephas_tpu.mllib import Matrices as JMatrices
from elephas_tpu.mllib import Vectors as JVectors
from elephas_tpu.utils import to_labeled_point as j_to_labeled_point
from elephas_tpu.utils import to_simple_rdd as j_to_simple_rdd
from elephas_tpu_torch import SparkMLlibModel, SparkModel
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.mllib import DenseMatrix, DenseVector, Matrices, Vectors
from elephas_tpu_torch.models import KerasModelAdapter
from elephas_tpu_torch.parallel import build_mesh, engine as port_engine
from elephas_tpu_torch.utils import (dict_to_model, model_to_dict, to_labeled_point,
                                     to_simple_rdd)

ROOT = Path(__file__).resolve().parents[1]
MNIST_JSON = ROOT / "elephas_tpu_torch" / "configs" / "mnist_mlp_logits.json"
TOL = 1e-5


def _jax_permutation(seed, n_workers, epoch, n_rows):
    """The JAX engine's epoch order on its 8 CPU devices (workers padded to
    a multiple of the device count, ``engine.py:261, 324, 640``)."""
    wp = -(-n_workers // jax.device_count()) * jax.device_count()
    keys = jax.random.split(jax.random.PRNGKey(seed), wp)
    return np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(keys[w], epoch),
                                                       n_rows))
                     for w in range(n_workers)])


@pytest.fixture
def jax_order(monkeypatch):
    monkeypatch.setattr(port_engine, "epoch_permutation", _jax_permutation)


def _mnist_mlp(head=None, dropout=0.2):
    keras.utils.set_random_seed(0)
    m = keras.Sequential([
        keras.layers.Dense(128, activation="relu"),
        keras.layers.Dropout(dropout),
        keras.layers.Dense(128, activation="relu"),
        keras.layers.Dropout(dropout),
        keras.layers.Dense(10, activation=head),
    ])
    m.build((None, 784))
    m.compile(optimizer="adam",
              loss=keras.losses.CategoricalCrossentropy(from_logits=head is None),
              metrics=["accuracy"])
    return m


def _toy(logits=True, n_in=8, n_out=4, loss=None, metrics=("accuracy",)):
    keras.utils.set_random_seed(1)
    m = keras.Sequential([keras.layers.Dense(16, activation="relu"),
                          keras.layers.Dropout(0.0),
                          keras.layers.Dense(n_out, activation=None if logits else "softmax")])
    m.build((None, n_in))
    m.compile("adam", loss or keras.losses.CategoricalCrossentropy(from_logits=logits),
              metrics=list(metrics))
    return m


def _toy_data(n=150, n_in=8, n_out=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[(x @ rng.normal(size=(n_in, n_out))).argmax(1)]
    return x, y


# -- the adapter against Keras ------------------------------------------------


@pytest.mark.parametrize("head", [None, "softmax"])
def test_adapter_forward_matches_keras_at_mnist_widths(head):
    m = _mnist_mlp(head)
    x = np.random.default_rng(0).random((64, 784)).astype(np.float32)
    adapter = KerasModelAdapter(m, device="cpu")
    assert [w.shape for w in adapter.get_weights()] == [(784, 128), (128,), (128, 128),
                                                        (128,), (128, 10), (10,)]
    np.testing.assert_allclose(adapter.predict(x, batch_size=32),
                               m.predict(x, verbose=0), atol=TOL, rtol=TOL)
    assert adapter.wants_accuracy
    assert adapter.loss_spec["config"]["from_logits"] is (head is None)


ACTIVATIONS = ["linear", "relu", "relu6", "leaky_relu", "elu", "selu", "gelu",
               "sigmoid", "hard_sigmoid", "hard_silu", "silu", "swish", "mish",
               "softplus", "softsign", "tanh", "exponential", "softmax",
               "log_softmax"]


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_dense_activations_match_keras(act):
    keras.utils.set_random_seed(2)
    m = keras.Sequential([keras.layers.Input((6,)), keras.layers.Flatten(),
                          keras.layers.Dense(5, activation=act),
                          keras.layers.Activation("tanh" if act != "tanh" else "relu"),
                          keras.layers.Dense(3, use_bias=False)])
    x = np.random.default_rng(3).normal(size=(9, 6)).astype(np.float32)
    got = KerasModelAdapter(m.to_json(), weights=m.get_weights(), device="cpu").predict(x)
    np.testing.assert_allclose(got, m.predict(x, verbose=0), atol=TOL, rtol=TOL)


def test_committed_mnist_json_rebuilds_with_keras():
    """The JSON ``chip_smoke.py`` trains is what Keras writes for the
    reference's MNIST MLP with a logits head: Keras rebuilds it with the
    same layers and compile config, and the port reads the same model."""
    cfg = json.loads(MNIST_JSON.read_text())
    rebuilt = keras.models.model_from_json(MNIST_JSON.read_text())
    assert [type(layer).__name__ for layer in rebuilt.layers] == \
        ["Dense", "Dropout", "Dense", "Dropout", "Dense"]
    assert [layer.units for layer in rebuilt.layers if hasattr(layer, "units")] == [128, 128, 10]
    assert [layer.rate for layer in rebuilt.layers if hasattr(layer, "rate")] == [0.2, 0.2]
    assert rebuilt.layers[-1].get_config()["activation"] == "linear"
    cc = cfg["compile_config"]
    assert cc["loss"]["class_name"] == "CategoricalCrossentropy"
    assert cc["loss"]["config"]["from_logits"] is True
    assert cc["optimizer"]["class_name"] == "Adam"
    assert abs(cc["optimizer"]["config"]["learning_rate"] - 1e-3) < 1e-9
    assert cc["metrics"] == ["accuracy"]
    fresh = json.loads(_mnist_mlp().to_json())
    assert [layer["class_name"] for layer in fresh["config"]["layers"]] == \
        [layer["class_name"] for layer in cfg["config"]["layers"]]
    assert fresh["compile_config"] == cc
    x = np.random.default_rng(4).random((16, 784)).astype(np.float32)
    adapter = KerasModelAdapter(MNIST_JSON.read_text(), weights=rebuilt.get_weights(),
                                device="cpu")
    np.testing.assert_allclose(adapter.predict(x), rebuilt.predict(x, verbose=0),
                               atol=TOL, rtol=TOL)


def test_adapter_initialises_from_the_config():
    a = KerasModelAdapter(MNIST_JSON.read_text(), seed=5, device="cpu")
    b = KerasModelAdapter(MNIST_JSON.read_text(), seed=5, device="cpu")
    w = a.get_weights()
    assert [x.shape for x in w] == [(784, 128), (128,), (128, 128), (128,), (128, 10), (10,)]
    for x, y in zip(w, b.get_weights()):
        np.testing.assert_array_equal(x, y)
    limit = np.sqrt(6.0 / (784 + 128))         # GlorotUniform
    assert np.abs(w[0]).max() <= limit and np.abs(w[0]).max() > 0.9 * limit
    assert abs(w[0].std() - limit / np.sqrt(3)) < 0.02 * limit
    assert not w[1].any() and not w[5].any()   # Zeros
    m = keras.Sequential([keras.layers.Input((30,)),
                          keras.layers.Dense(200, kernel_initializer="he_normal",
                                             bias_initializer=keras.initializers.Constant(0.5))])
    c = KerasModelAdapter(m.to_json(), device="cpu").get_weights()
    std = np.sqrt(2.0 / 30)
    assert abs(c[0].std() - std) < 0.05 * std and np.abs(c[0]).max() <= 2 * std / 0.8796 + 1e-6
    assert (c[1] == 0.5).all()
    # a convolution's fans count its receptive field, as Keras's; LSTM's
    # Orthogonal recurrent kernel and unit_forget_bias; BatchNormalization's
    # four defaults; Embedding's uniform rows
    m = keras.Sequential([keras.layers.Input((10, 10, 4)), keras.layers.Conv2D(8, 3),
                          keras.layers.BatchNormalization(), keras.layers.Reshape((64, 8)),
                          keras.layers.LSTM(6)])
    conv, conv_b, gamma, beta, mean, var, kernel, rec, bias = KerasModelAdapter(
        m.to_json(), seed=2, device="cpu").get_weights()
    limit = np.sqrt(6.0 / (3 * 3 * 4 + 3 * 3 * 8))
    assert conv.shape == (3, 3, 4, 8) and 0.9 * limit < np.abs(conv).max() <= limit
    assert not conv_b.any() and (gamma == 1).all() and not beta.any()
    assert not mean.any() and (var == 1).all()
    assert rec.shape == (6, 24)
    np.testing.assert_allclose(rec @ rec.T, np.eye(6), atol=1e-5)
    np.testing.assert_array_equal(bias, np.r_[np.zeros(6), np.ones(6), np.zeros(12)])
    e = keras.Sequential([keras.layers.Input((5,)), keras.layers.Embedding(300, 40)])
    (emb,) = KerasModelAdapter(e.to_json(), device="cpu").get_weights()
    assert 0.045 < np.abs(emb).max() <= 0.05 and abs(emb.mean()) < 0.002


def test_dropout_keeps_one_minus_rate_and_scales():
    keras.utils.set_random_seed(0)
    m = keras.Sequential([keras.layers.Input((1000,)), keras.layers.Dropout(0.25)])
    adapter = KerasModelAdapter(m, device="cpu")
    gen = torch.Generator().manual_seed(0)
    out = adapter.apply({}, torch.ones(2, 4, 1000), training=True, generator=gen)
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.75))
    assert not torch.equal(kept[0], kept[1])            # replicas draw their own masks
    assert torch.equal(adapter.apply({}, torch.ones(2, 4, 1000), training=False),
                       torch.ones(2, 4, 1000))


def test_serialization_round_trip():
    m = _toy()
    d = model_to_dict(m)
    adapter = dict_to_model(d, device="cpu")
    for a, b in zip(adapter.get_weights(), m.get_weights()):
        np.testing.assert_array_equal(a, b)
    again = model_to_dict(adapter)
    assert json.loads(again["model"]) == json.loads(d["model"])
    sm = SparkModel(d, mode="synchronous", device="cpu")
    for a, b in zip(sm.master_network.get_weights(), m.get_weights()):
        np.testing.assert_array_equal(a, b)


# -- the SparkModel surface against the JAX package ---------------------------


def _both_fit(jax_order, make, x, y, model_cls=(JSparkModel, SparkModel), n_workers=4,
              **kw):
    jsm = model_cls[0](make(), mode="synchronous", num_workers=n_workers, **kw)
    jsm.fit(j_to_simple_rdd(JSparkContext("local[4]"), x, y), epochs=2, batch_size=8,
            validation_split=0.1)
    tsm = model_cls[1](make(), mode="synchronous", num_workers=n_workers, device="cpu",
                       **kw)
    tsm.fit(to_simple_rdd(SparkContext("local[4]"), x, y), epochs=2, batch_size=8,
            validation_split=0.1)
    return jsm, tsm


def test_predict_and_evaluate_match_jax(jax_order):
    x, y = _toy_data()
    jsm, tsm = _both_fit(jax_order, _toy, x, y)
    xt, yt = _toy_data(n=50, seed=9)
    np.testing.assert_allclose(tsm.predict(xt), jsm.predict(xt), atol=TOL, rtol=TOL)
    got, want = tsm.evaluate(xt, yt), jsm.evaluate(xt, yt)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    sc = SparkContext("local[3]")
    rdd_pred = tsm.predict(sc.parallelize(list(xt), 3))
    assert rdd_pred.getNumPartitions() == 3
    np.testing.assert_allclose(np.stack(rdd_pred.collect()), jsm.predict(xt),
                               atol=TOL, rtol=TOL)
    empty = tsm.predict(sc.parallelize([], 2))
    assert empty.getNumPartitions() == 2 and empty.collect() == []


def test_evaluate_without_metrics_returns_the_loss(jax_order):
    x, y = _toy_data()
    jsm, tsm = _both_fit(jax_order, lambda: _toy(metrics=()), x, y)
    got, want = tsm.evaluate(x, y), jsm.evaluate(x, y)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_mllib_model_matches_jax(jax_order):
    x, y = _toy_data(n=160)
    labels = y.argmax(1)
    jsm = JSparkMLlibModel(_toy(), mode="synchronous", num_workers=4)
    jsm.fit(j_to_labeled_point(JSparkContext("local[4]"), x, labels), epochs=2,
            batch_size=8, categorical=True, nb_classes=4)
    tsm = SparkMLlibModel(_toy(), mode="synchronous", num_workers=4, device="cpu")
    tsm.fit(to_labeled_point(SparkContext("local[4]"), x, labels), epochs=2,
            batch_size=8, categorical=True, nb_classes=4)
    for a, b in zip(tsm.master_network.get_weights(), jsm.master_network.get_weights()):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    mat = Matrices.dense(5, 8, x[:5].flatten(order="F"))
    got = tsm.predict(mat)
    assert isinstance(got, DenseMatrix)
    want = jsm.predict(JMatrices.dense(5, 8, x[:5].flatten(order="F")))
    np.testing.assert_allclose(got.toArray(), want.toArray(), atol=TOL, rtol=TOL)
    vec = tsm.predict(Vectors.dense(x[0]))
    assert isinstance(vec, DenseVector)
    np.testing.assert_allclose(vec.toArray(), jsm.predict(JVectors.dense(x[0])).toArray(),
                               atol=TOL, rtol=TOL)


def test_partitions_not_above_the_batch_size_are_skipped():
    x, y = _toy_data(n=40)
    sm = SparkModel(_toy(), mode="synchronous", num_workers=4, device="cpu")
    with pytest.raises(ValueError, match="skipped"):
        sm.fit(to_simple_rdd(SparkContext("local[4]"), x, y), epochs=1, batch_size=10)
    sm.fit(to_simple_rdd(SparkContext("local[4]"), x, y), epochs=1, batch_size=9)
    assert len(sm.training_histories) == 1


# -- what the port refuses ------------------------------------------------------


def _resilience_case(name):
    """Constructor options of the resilience slice, built per test (the
    registry and the plan are stateful)."""
    from elephas_tpu_torch.resilience import FaultPlan, HeartbeatRegistry

    return {"fault_plan": dict(mode="synchronous", fault_plan=FaultPlan(seed=0), quorum=2),
            "membership": dict(mode="synchronous", membership=HeartbeatRegistry(), quorum=0),
            "elastic": dict(mode="synchronous"),
            "hot_standby": dict(mode="synchronous", hot_standby=True)}[name]


@pytest.mark.parametrize("case,match", [
    ("fault_plan", "requires a membership registry"),
    ("membership", "quorum must be >= 1"),
    ("elastic", "kept"),
    ("hot_standby", "needs a live parameter server"),
])
def test_unported_constructor_options_raise(case, match):
    """The resilience options hold the reference's validation: a quorum
    without a membership registry or below 1, and a hot standby without a
    live server, raise the reference's ``ValueError`` in both packages, and
    without the invalid quorum the options construct and are kept. An
    ``ElasticConfig`` (each package's own) constructs in both and is kept."""
    kw = _resilience_case(case)
    if case == "elastic":
        from elephas_tpu.parallel.elastic import ElasticConfig as JElasticConfig
        from elephas_tpu_torch.parallel.elastic import ElasticConfig

        for cls, cfg, extra in ((SparkModel, ElasticConfig(initial_hosts=3), {"device": "cpu"}),
                                (JSparkModel, JElasticConfig(initial_hosts=3), {})):
            sm = cls(_toy(), **{**kw, "elastic": cfg}, **extra)
            assert sm.elastic is cfg and sm._elastic_pool is None
            assert "elastic" not in sm.membership_snapshot()
        return
    with pytest.raises(ValueError, match=match):
        SparkModel(_toy(), device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        JSparkModel(_toy(), **kw)
    kept = {k: v for k, v in kw.items() if k != "quorum"}
    if case == "hot_standby":
        kept.update(mode="asynchronous", parameter_server_mode="socket")
    sm = SparkModel(_toy(), device="cpu", **kept)
    for k, v in kept.items():
        assert getattr(sm, k) is v or getattr(sm, k) == v, k


def test_unported_calls_raise(tmp_path):
    x, y = _toy_data()
    rdd = to_simple_rdd(SparkContext("local[4]"), x, y)
    sm = SparkModel(_toy(), mode="synchronous", num_workers=2, device="cpu")
    with pytest.raises(NotImplementedError, match="profile"):
        sm.fit(rdd, epochs=1, batch_size=8, profile_dir=str(tmp_path))
    # fit_stream is ported: a mode without a live server is the reference's
    # ValueError (test_fit_stream_rejects_modes_without_live_ps)
    with pytest.raises(ValueError, match="fit_stream needs a live parameter server"):
        sm.fit_stream([], None)
    with pytest.raises(ValueError, match="fit_stream needs a live parameter server"):
        JSparkModel(_toy(), mode="synchronous").fit_stream([], None)
    # evaluate hands metrics other than accuracy to the Keras fall-back,
    # where a stateful metric class runs as the reference's Keras runs it
    metrics = (keras.metrics.AUC(from_logits=True), keras.metrics.Precision())
    auc = SparkModel(_toy(metrics=metrics), mode="synchronous", device="cpu")
    want = JSparkModel(_toy(metrics=metrics), mode="synchronous").evaluate(x, y)
    np.testing.assert_allclose(auc.evaluate(x, y), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("layers,match", [
    (lambda: [keras.layers.LSTM(2, return_state=True)], "return_state"),
    (lambda: [keras.layers.Embedding(10, 2, mask_zero=True), keras.layers.Flatten(),
              keras.layers.Dense(2)], "mask_zero"),
    (lambda: [keras.layers.Dense(4), keras.layers.Dense(2, dtype="bfloat16")],
     "'bfloat16'"),
    (lambda: [keras.layers.Dense(4, activation="relu6"),
              keras.layers.LayerNormalization()], "LayerNormalization"),
])
def test_unported_layers_raise_naming_their_item(layers, match):
    """A 16-bit policy and LayerNormalization still raise naming item 13. A
    Sequential model ending in ``return_state`` is a model of several
    outputs, which the reference's entry points do not take, and raises
    saying so; an Embedding's mask reaching Flatten is dropped there, as
    Keras 3.13 drops a mask at a layer that does not support masking, and
    the model runs within 1e-5 of ``predict``."""
    m = keras.Sequential([keras.layers.Input((8, 3)) if match == "return_state"
                          else keras.layers.Input((8,))] + layers())
    if match == "mask_zero":
        x = np.random.default_rng(0).integers(0, 10, size=(5, 8)).astype(np.float32)
        got = KerasModelAdapter(m, device="cpu").predict(x, batch_size=5)
        np.testing.assert_allclose(got, m.predict(x, verbose=0), atol=TOL, rtol=TOL)
        return
    expect = "a model of 3 outputs" if match == "return_state" else match
    with pytest.raises(NotImplementedError, match=expect) as err:
        KerasModelAdapter(m, device="cpu")
    assert ("reference's entry points" if match == "return_state" else "item 13") in \
        str(err.value)


def test_functional_models_and_meshes_raise():
    """A Functional model of two outputs raises, saying that the
    reference's entry points do not take one either
    (``tests/test_torch_graph_options.py`` runs the reference's fit to its
    own error); a model nested as a layer runs, within 1e-5 of
    ``predict``; meshes wait for item 6."""
    inp = keras.Input((4,))
    two_out = keras.Model(inp, [keras.layers.Dense(2)(inp), keras.layers.Dense(3)(inp)])
    with pytest.raises(NotImplementedError, match="2 outputs") as err:
        KerasModelAdapter(two_out, device="cpu")
    assert "reference's entry points do not take" in str(err.value)
    inner = keras.Sequential([keras.layers.Dense(3)])
    nested = keras.Model(inp, keras.layers.Dense(2)(inner(inp)))
    x = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(KerasModelAdapter(nested, device="cpu").predict(x),
                               nested.predict(x, verbose=0), atol=TOL, rtol=TOL)
    with pytest.raises(NotImplementedError, match="item 6"):
        build_mesh(devices=["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="item 6"):
        build_mesh(num_devices=2, device="cpu")
