"""Mixed-precision dtype policies in the port (``mixed_bfloat16`` and
``mixed_float16``, model-wide and on one layer) against Keras and the JAX
package, on seeded numpy inputs.

- Every layer kind the examples use, under both policies and both scopes,
  against Keras ``predict`` at the bf16 pin 2e-2, with Keras's output dtype
  (a bfloat16 output comes back widened to float32: numpy has no bfloat16).
- The mirror of the reference's ``tests/integration/test_mixed_precision.py``:
  a ``mixed_bfloat16`` model through the port's ``CompiledTrainer`` against
  the reference's, the losses at 2e-2.
- A small Functional ResNet under ``mixed_bfloat16`` fitted by the port's
  ``SparkModel`` against ``elephas_tpu.SparkModel``.
- ``mixed_float16``'s optimizer on both paths: the compiled path's SGD
  fall-back (Keras's ``LossScaleOptimizer`` has no optax mapping), and the
  host path's loss scaling against Keras ``fit``, a step whose gradients
  overflow float16 skipped and the scale halved.
- K1's plain versions on float16 logits against the JAX kernel in
  interpret mode; the committed mixed-precision configs against Keras's
  JSON.

The references compute 16-bit ops in XLA's order and the port in PyTorch's,
so the two round differently; 2e-2 is the bf16 pin of the port's card
tests (eight bits of mantissa, a few roundings deep).
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import json
import warnings
from pathlib import Path

import jax.numpy as jnp
import keras
import numpy as np
import pytest
import torch

from elephas_tpu import SparkModel as JSparkModel
from elephas_tpu.data import SparkContext as JSparkContext
from elephas_tpu.models import KerasModelAdapter as JAdapter
from elephas_tpu.ops import pallas_ops as JP
from elephas_tpu.parallel import CompiledTrainer as JTrainer
from elephas_tpu.utils import to_simple_rdd as j_to_simple_rdd
from elephas_tpu_torch import SparkModel
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.models import KerasModelAdapter
from elephas_tpu_torch.models.optimizers import LossScaleState, to_keras_optimizer
from elephas_tpu_torch.ops import fused_xent as X
from elephas_tpu_torch.parallel import CompiledTrainer, engine as port_engine
from elephas_tpu_torch.utils import to_simple_rdd
from elephas_tpu_torch.worker import KerasReplica

from .test_torch_functional import image_data, jax_permutation, small_resnet

PIN = 2e-2
CONFIGS = Path(__file__).resolve().parents[1] / "elephas_tpu_torch" / "configs"
POLICIES = ["mixed_bfloat16", "mixed_float16"]


class policy:
    """Keras's global dtype policy inside a ``with``, float32 after."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        keras.mixed_precision.set_global_policy(self.name)

    def __exit__(self, *exc):
        keras.mixed_precision.set_global_policy("float32")


def _layers(kind, dt):
    """``(input shape, layers before, the layer under test, layers after)``
    of a small model around one layer kind; ``dt`` the tested layer's
    dtype (None: the global policy)."""
    kw = {} if dt is None else {"dtype": dt}
    L = keras.layers
    return {
        "dense": ((6,), [], L.Dense(5, activation="relu", **kw), [L.Dense(3)]),
        "conv2d": ((6, 6, 2), [], L.Conv2D(3, 3, padding="same", activation="relu", **kw),
                   [L.Flatten(), L.Dense(3)]),
        "batchnorm": ((6,), [L.Dense(5)], L.BatchNormalization(**kw), [L.Dense(3)]),
        "maxpool": ((6, 6, 2), [L.Conv2D(3, 1)], L.MaxPooling2D(2, **kw),
                    [L.GlobalAveragePooling2D(), L.Dense(3)]),
        "avgpool": ((6, 6, 2), [L.Conv2D(3, 1)], L.AveragePooling2D(2, padding="same", **kw),
                    [L.Flatten(), L.Dense(3)]),
        "lstm": ((5,), [L.Embedding(20, 4)], L.LSTM(3, **kw), [L.Dense(3)]),
        "gru": ((5, 3), [], L.GRU(4, return_sequences=True, **kw), [L.GRU(3), L.Dense(3)]),
        "embedding": ((5,), [], L.Embedding(20, 4, **kw), [L.Flatten(), L.Dense(3)]),
    }[kind]


def _model(kind, pol, scope):
    """The model of ``kind`` under ``pol``: model-wide (the global policy)
    or on the tested layer alone (the rest float32); ``add`` is a
    Functional model whose merge is the tested layer."""
    keras.utils.set_random_seed(0)
    with policy(pol if scope == "model" else "float32"):
        dt = None if scope == "model" else pol
        if kind == "add":
            i = keras.Input((6,))
            a = keras.layers.Dense(4)(i)
            b = keras.layers.Dense(4, activation="tanh")(i)
            h = keras.layers.Add(**({} if dt is None else {"dtype": dt}))([a, b])
            return keras.Model(i, keras.layers.Dense(3)(h)), (6,)
        shape, before, layer, after = _layers(kind, dt)
        return keras.Sequential([keras.Input(shape)] + before + [layer] + after), shape


def _randomize(m, rng):
    """Keras's weights moved by noise (the moving variances kept positive)."""
    ws = []
    for v, w in zip(m.weights, m.get_weights()):
        w = w + rng.normal(size=w.shape).astype(np.float32) * 0.2
        ws.append(np.abs(w) + 0.5 if "moving_variance" in v.path else w)
    m.set_weights(ws)
    return ws


def _inputs(kind, shape, rng, n=6):
    if kind in ("lstm", "embedding"):
        return rng.integers(0, 20, size=(n,) + shape).astype(np.float32)
    return rng.normal(size=(n,) + shape).astype(np.float32)


@pytest.mark.parametrize("scope", ["model", "layer"])
@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("kind", ["dense", "conv2d", "batchnorm", "maxpool", "avgpool",
                                  "add", "lstm", "gru", "embedding"])
def test_layer_matches_keras_predict(kind, pol, scope):
    m, shape = _model(kind, pol, scope)
    rng = np.random.default_rng(len(kind))
    ws = _randomize(m, rng)
    x = _inputs(kind, shape, rng)
    # the model's eager call: predict's forward and output dtype, without
    # compiling a predict function for every case
    want = np.asarray(m(x, training=False))
    adapter = KerasModelAdapter(m.to_json(), weights=ws, device="cpu")
    got = adapter.predict(x, batch_size=4)
    out_dtype = {"bfloat16": np.float32, "float16": np.float16, "float32": np.float32}[
        str(want.dtype)]
    assert got.dtype == out_dtype, (got.dtype, want.dtype)
    if scope == "model":
        assert str(want.dtype) == pol.split("_")[1]
    np.testing.assert_allclose(got.astype(np.float32), np.asarray(want, np.float32),
                               atol=PIN, rtol=PIN)
    # the variables stay float32 and come back as Keras's
    for a, b in zip(adapter.get_weights(), m.get_weights()):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_mixed_bfloat16_policy(toy_classification, monkeypatch):
    """The reference's own test on the port: a ``mixed_bfloat16`` model
    (bf16 compute, float32 variables) through the port's ``CompiledTrainer``
    trains (the loss falls, every loss finite), and its losses match the
    reference's ``CompiledTrainer`` on the same start and order."""
    monkeypatch.setattr(port_engine, "epoch_permutation", jax_permutation)
    x, y = toy_classification
    with policy("mixed_bfloat16"):
        keras.utils.set_random_seed(0)
        m = keras.Sequential([keras.layers.Dense(32, activation="relu"),
                              keras.layers.Dense(3, activation="softmax")])
        m.build((None, 10))
        m.compile("adam", "categorical_crossentropy", metrics=["accuracy"])
    assert m.layers[0].compute_dtype == "bfloat16"
    assert m.layers[0].variable_dtype == "float32"
    adapter = KerasModelAdapter(m, device="cpu")
    assert adapter.layers[0].dtype == torch.bfloat16
    parts = [(x[i::4], y[i::4]) for i in range(4)]
    fit = dict(epochs=4, batch_size=16, validation_split=0.0)
    res = CompiledTrainer(adapter, mode="synchronous").fit(parts, **fit)
    assert res.history["loss"][-1] < res.history["loss"][0]
    assert all(np.isfinite(v) for v in res.history["loss"])
    want = JTrainer(JAdapter(m), mode="synchronous").fit(parts, **fit)
    np.testing.assert_allclose(res.history["loss"], want.history["loss"], atol=PIN,
                               rtol=PIN)
    np.testing.assert_allclose(res.history["accuracy"], want.history["accuracy"],
                               atol=0.05)


def test_small_resnet_mixed_bfloat16_fit_matches_jax_spark_model(monkeypatch):
    """The small Functional ResNet (convolutions, BatchNormalization, two
    Adds) under ``mixed_bfloat16``: 2 workers, synchronous, 2 epochs; the
    histories within the bf16 pin and the weights within it relative to
    their scale. BatchNormalization's moving statistics are float32 on both
    sides, moved from bf16 activations."""
    monkeypatch.setattr(port_engine, "epoch_permutation", jax_permutation)
    x, y = image_data()
    kw = dict(mode="synchronous", frequency="epoch", parameter_server_mode="jax",
              num_workers=2)
    fit = dict(epochs=2, batch_size=8, validation_split=0.25)
    with policy("mixed_bfloat16"):
        jm, tm = small_resnet(), small_resnet()
    jsm = JSparkModel(jm, **kw)
    jsm.fit(j_to_simple_rdd(JSparkContext("local[2]"), x, y), **fit)
    tsm = SparkModel(tm, device="cpu", **kw)
    tsm.fit(to_simple_rdd(SparkContext("local[2]"), x, y), **fit)
    jh, th = jsm.training_histories[-1], tsm.training_histories[-1]
    assert set(th) == set(jh)
    for k in ("loss", "val_loss"):
        np.testing.assert_allclose(th[k], jh[k], atol=PIN, rtol=PIN, err_msg=k)
    for a, b in zip(tsm.master_network.get_weights(), jsm.master_network.get_weights()):
        b = np.asarray(b)
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=PIN * max(1.0, float(np.abs(b).max())))


def _mlp_f16(seed=0, optimizer="adam"):
    with policy("mixed_float16"):
        keras.utils.set_random_seed(seed)
        m = keras.Sequential([keras.Input((8,)), keras.layers.Dense(16, activation="relu"),
                              keras.layers.Dense(4)])
        m.compile(optimizer, keras.losses.CategoricalCrossentropy(from_logits=True),
                  metrics=["accuracy"])
    return m


def _data(n=96, d=8, c=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[(x @ rng.normal(size=(d, c))).argmax(1)]
    return x, y


def test_mixed_float16_compiled_path_runs_the_reference_sgd_fallback(monkeypatch):
    """Keras wraps a ``mixed_float16`` model's optimizer in a
    ``LossScaleOptimizer``, which the reference's ``to_optax`` does not
    map: it warns and trains with SGD at 0.001. The port reads Adam from
    the JSON's compile_config, wraps it as Keras does, and falls back the
    same way; the two fits match at the pin."""
    monkeypatch.setattr(port_engine, "epoch_permutation", jax_permutation)
    m = _mlp_f16()
    assert type(m.optimizer).__name__ == "LossScaleOptimizer"
    assert json.loads(m.to_json())["compile_config"]["optimizer"]["class_name"] == "Adam"
    x, y = _data()
    kw = dict(mode="synchronous", frequency="epoch", parameter_server_mode="jax",
              num_workers=2)
    fit = dict(epochs=2, batch_size=16, validation_split=0.0)
    with pytest.warns(UserWarning, match="lossscaleoptimizer"):
        jsm = JSparkModel(m, **kw)
        jsm.fit(j_to_simple_rdd(JSparkContext("local[2]"), x, y), **fit)
    with pytest.warns(UserWarning, match="lossscaleoptimizer.*SGD\\(lr=0.001\\)"):
        tsm = SparkModel({"model": m.to_json(), "weights": m.get_weights()}, device="cpu",
                         **kw)
        tsm.fit(to_simple_rdd(SparkContext("local[2]"), x, y), **fit)
    assert tsm.master_network.optimizer_spec["class_name"] == "LossScaleOptimizer"
    np.testing.assert_allclose(tsm.training_histories[-1]["loss"],
                               jsm.training_histories[-1]["loss"], atol=PIN, rtol=PIN)
    for a, b in zip(tsm.master_network.get_weights(), jsm.master_network.get_weights()):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3, rtol=1e-3)


def _guide_model():
    """Keras's mixed-precision guide's pattern: a Functional model built
    under ``mixed_float16`` whose softmax head is set to float32. Its JSON
    names no model policy and its layers' policies differ; the live model's
    ``dtype_policy`` is ``mixed_float16``, so ``compile`` wraps its Adam."""
    with policy("mixed_float16"):
        keras.utils.set_random_seed(1)
        i = keras.Input((8,))
        h = keras.layers.Dense(16, activation="relu")(i)
        o = keras.layers.Activation("softmax", dtype="float32")(keras.layers.Dense(4)(h))
        m = keras.Model(i, o)
        m.compile("adam", "categorical_crossentropy", metrics=["accuracy"])
    return m


@pytest.mark.parametrize("path", ["compiled", "host"])
def test_mixed_float16_functional_with_float32_head_matches_jax_spark_model(path,
                                                                           monkeypatch):
    """The guide's model on both paths against ``elephas_tpu.SparkModel``:
    the port reads the live model's policy, so its optimizer is the
    ``LossScaleOptimizer`` the reference serializes (the compiled path's
    SGD fall-back, the host path's loss-scaled Adam); the histories at the
    pin, the weights within 1e-3. Its JSON alone does not say whether
    Keras wraps the optimizer, and raises naming item 13 unless an
    optimizer is given."""
    monkeypatch.setattr(port_engine, "epoch_permutation", jax_permutation)
    m = _guide_model()
    assert m.dtype_policy.name == "mixed_float16"
    assert type(m.optimizer).__name__ == "LossScaleOptimizer"
    if path == "compiled":
        with pytest.raises(NotImplementedError, match="item 13"):
            KerasModelAdapter(m.to_json(), device="cpu")
        adapter = KerasModelAdapter(m.to_json(), optimizer="adam", device="cpu")
        assert adapter.policy is None and adapter.optimizer_spec == "adam"
    x, y = _data(64)
    kw = dict(mode="synchronous", frequency="epoch", parameter_server_mode="jax",
              num_workers=2) if path == "compiled" else dict(
        mode="synchronous", comm="host", num_workers=1, port=0)
    fit = dict(epochs=2, batch_size=16, validation_split=0.0, shuffle=False)

    def warns():
        return pytest.warns(UserWarning, match="lossscaleoptimizer") \
            if path == "compiled" else warnings.catch_warnings()

    with warns():
        np.random.seed(5)
        jsm = JSparkModel(m, **kw)
        jsm.fit(j_to_simple_rdd(JSparkContext(f"local[{kw['num_workers']}]"), x, y), **fit)
    tm = _guide_model()
    with warns():
        np.random.seed(5)
        tsm = SparkModel(tm, device="cpu", **kw)
        tsm.fit(to_simple_rdd(SparkContext(f"local[{kw['num_workers']}]"), x, y), **fit)
    assert tsm.master_network.policy == "mixed_float16"
    assert tsm.master_network.optimizer_spec["class_name"] == "LossScaleOptimizer"
    for got, want in zip(tsm.training_histories, jsm.training_histories):
        np.testing.assert_allclose(got["loss"], want["loss"], atol=PIN, rtol=PIN)
    for a, b in zip(tsm.master_network.get_weights(), jsm.master_network.get_weights()):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("where", ["evaluate", "host_validation"])
def test_keras_steps_take_the_loss_in_float32(where):
    """Where the reference hands the work to Keras (``evaluate``'s
    fall-back, the host path's workers), Keras's ``Loss`` casts ``y_pred``
    to float32: a ``mixed_bfloat16`` model's Poisson loss (Keras's
    function, in the dtype it is handed) there equals float64's on its
    (exactly widened) predictions within float32's rounding, where bf16
    arithmetic would miss by bf16's."""
    with policy("mixed_bfloat16"):
        keras.utils.set_random_seed(2)
        m = keras.Sequential([keras.Input((8,)), keras.layers.Dense(16, activation="tanh"),
                              keras.layers.Dense(4, activation="softmax")])
        m.compile("sgd", "poisson", metrics=["mae"])
    x, y = _data(70)
    if where == "evaluate":
        adapter = KerasModelAdapter(m, device="cpu")
        loss, mae = adapter.keras_evaluate(x, y)
        xv, yv = x, y
    else:
        replica = KerasReplica(m.to_json(), m.get_weights(), None, None, ["mae"],
                               device="cpu")
        hist = replica.fit(x, y, batch_size=16, epochs=1, validation_split=0.5,
                           shuffle=False, verbose=0).history
        loss, mae = hist["val_loss"][0], hist["val_mae"][0]
        adapter, xv, yv = replica.adapter, x[35:], y[35:]
    pred = adapter.predict(xv).astype(np.float64)
    want = np.mean(pred - yv * np.log(pred + 1e-7))
    np.testing.assert_allclose(loss, want, rtol=1e-6)
    np.testing.assert_allclose(mae, np.mean(np.abs(pred - yv)), rtol=PIN)


def test_mixed_float16_host_path_scales_skips_and_halves():
    """The host path's workers compile the JSON under its policies, so
    Keras's ``LossScaleOptimizer`` over Adam trains there: the port's
    replica against Keras ``fit`` from the same weights, unshuffled, on
    batches of which the second overflows float16 (inputs of 1e5): that
    step is skipped (the weights and Adam's step count as before it) and
    the scale halves from 2**15, while the finite steps match Keras."""
    m = _mlp_f16()
    w0 = [np.array(w) for w in m.get_weights()]
    x, y = _data(48)
    x[16:32] *= 1e5
    spec = json.loads(m.to_json())["compile_config"]["optimizer"]
    replica = KerasReplica(m.to_json(), w0, None, None, ["accuracy"], device="cpu")
    assert replica.adapter.optimizer_spec["class_name"] == "LossScaleOptimizer"
    assert replica.adapter.optimizer_spec["config"]["inner_optimizer"] == spec
    fit = dict(epochs=1, batch_size=16, shuffle=False, verbose=0)
    want = m.fit(x, y, **fit).history
    got = replica.fit(x, y, **fit).history
    state = replica._opt_state
    assert isinstance(state, LossScaleState)
    assert float(state.scale[0]) == float(m.optimizer.dynamic_scale.value) == 2.0 ** 14
    assert int(state.inner.count[0]) == int(m.optimizer.iterations.value) == 2
    for a, b in zip(replica.get_weights(), m.get_weights()):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3, rtol=1e-3)
    assert np.isfinite(want["loss"][0]) == np.isfinite(got["loss"][0])


def test_loss_scale_doubles_after_growth_steps():
    """The scale doubles once ``dynamic_growth_steps`` finite steps have
    run since it last changed (Keras's counter reaching ``steps - 1``)."""
    opt = to_keras_optimizer({"class_name": "LossScaleOptimizer", "config": {
        "inner_optimizer": {"class_name": "SGD", "config": {"learning_rate": 0.1}},
        "initial_scale": 8.0, "dynamic_growth_steps": 3}})
    p = {"w": torch.ones(2)}
    st = opt.init(p)
    scales = []
    for g in (1.0, 1.0, 1.0, float("inf"), 1.0):
        upd, st = opt.update({"w": torch.full((2,), g) * opt.loss_scale(st)}, st, p)
        scales.append(float(st.scale))
    assert scales == [8.0, 8.0, 16.0, 8.0, 8.0]


def test_fp16_logits_k1_plain_versions_match_the_jax_kernel():
    """K1's plain versions (the CPU path) on float16 logits against the
    reference's Pallas kernel in interpret mode on the same float16 logits:
    the loss float32 within 1e-5, the gradient float16 within one fp16 ulp
    of its scale."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(16, 10)) * 3).astype(np.float16)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
    g = rng.normal(size=16).astype(np.float32)
    import jax
    out, vjp = jax.vjp(lambda a: JP.fused_xent_from_logits(a, jnp.asarray(y), True),
                       jnp.asarray(x))
    want_dx = np.asarray(vjp(jnp.asarray(g))[0].astype(jnp.float32))
    xt = torch.from_numpy(x).requires_grad_()
    got = X.categorical_crossentropy_from_logits(xt, torch.from_numpy(y))
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    assert got.dtype == torch.float32 and dx.dtype == torch.float16
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dx.float().numpy(), want_dx, atol=2 ** -10, rtol=2 ** -10)


def _layer_kinds(arch):
    return [(layer["class_name"], layer["config"].get("dtype"),
             {k: v for k, v in layer["config"].items()
              if k not in ("name", "dtype") and "initializer" not in k})
            for layer in arch["config"]["layers"]]


def _mlp_f16_example():
    """``examples/mnist_mlp_spark.py``'s 784-128-128-10 with a logits head,
    under ``mixed_float16``."""
    with policy("mixed_float16"):
        keras.utils.set_random_seed(0)
        L = keras.layers
        m = keras.Sequential([keras.Input((784,)), L.Dense(128, activation="relu"),
                              L.Dropout(0.2), L.Dense(128, activation="relu"),
                              L.Dropout(0.2), L.Dense(10)])
        m.compile(optimizer="adam",
                  loss=keras.losses.CategoricalCrossentropy(from_logits=True),
                  metrics=["accuracy"])
    return m


def _resnet_layer_kinds():
    """A Functional model of every layer class ResNet-50 has, its kernels
    zero (no random initializer to compile)."""
    L, z = keras.layers, {"kernel_initializer": "zeros"}
    i = keras.Input((8, 8, 3))
    x = L.Conv2D(4, 3, strides=2, **z)(L.ZeroPadding2D(1)(i))
    x = L.Activation("relu")(L.BatchNormalization(axis=3, epsilon=1.001e-5)(x))
    x = L.MaxPooling2D(3, strides=2)(L.ZeroPadding2D(1)(x))
    x = L.Activation("relu")(L.Add()([x, L.Conv2D(4, 1, **z)(x)]))
    return keras.Model(i, L.Dense(10, **z)(L.GlobalAveragePooling2D()(x)))


def _under_policy(arch, pol):
    """``arch`` as Keras writes it when its model is built under the global
    policy ``pol``: each layer but the input's names the policy."""
    arch = json.loads(json.dumps(arch))
    for layer in arch["config"]["layers"]:
        if layer["class_name"] != "InputLayer":
            layer["config"]["dtype"] = {"module": "keras", "class_name": "DTypePolicy",
                                        "config": {"name": pol}, "registered_name": None}
    return arch


def test_committed_mixed_configs_match_keras():
    """``configs/resnet50_logits_mixed_bf16.json`` is the float32 config's
    ResNet-50 (held to ``keras.applications.ResNet50`` by
    ``test_torch_functional.py``) under ``mixed_bfloat16``: Keras writes a
    model built under a global policy as the float32 one with each layer's
    policy named, which a model of its layer classes shows here, so the
    committed file is the float32 one so rewritten, its compile config the
    same.
    ``configs/mnist_mlp_logits_mixed_f16.json`` is the MLP under
    ``mixed_float16``: each layer's class, policy and options, the model's
    policy and the compile config's loss and optimizer as Keras writes
    them; its forward against Keras ``predict``."""
    f32 = json.loads(_resnet_layer_kinds().to_json())
    with policy("mixed_bfloat16"):
        bf16 = json.loads(_resnet_layer_kinds().to_json())
    assert _layer_kinds(_under_policy(f32, "mixed_bfloat16")) == _layer_kinds(bf16)
    resnet = json.loads((CONFIGS / "resnet50_logits.json").read_text())
    committed = json.loads((CONFIGS / "resnet50_logits_mixed_bf16.json").read_text())
    assert _layer_kinds(committed) == _layer_kinds(_under_policy(resnet, "mixed_bfloat16"))
    assert committed["compile_config"] == resnet["compile_config"]
    assert KerasModelAdapter(committed, device="cpu").policy == "mixed_bfloat16"
    m = _mlp_f16_example()
    arch = json.loads(m.to_json())
    committed = json.loads((CONFIGS / "mnist_mlp_logits_mixed_f16.json").read_text())
    assert [k[0] for k in _layer_kinds(committed)] == [k[0] for k in _layer_kinds(arch)]
    assert [k[1:] for k in _layer_kinds(committed)] == [k[1:] for k in _layer_kinds(arch)]
    assert KerasModelAdapter(committed, device="cpu").policy == "mixed_float16"
    for k in ("loss", "optimizer", "metrics"):
        assert committed["compile_config"][k] == arch["compile_config"][k], k
    x = np.random.default_rng(1).uniform(0, 1, size=(8, 784)).astype(np.float32)
    adapter = KerasModelAdapter((CONFIGS / "mnist_mlp_logits_mixed_f16.json").read_text(),
                                weights=m.get_weights(), device="cpu")
    got = adapter.predict(x)
    want = m.predict(x, verbose=0)
    assert got.dtype == want.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=PIN,
                               rtol=PIN)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert adapter.optimizer_spec["class_name"] == "LossScaleOptimizer"
