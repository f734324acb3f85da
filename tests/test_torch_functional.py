"""Functional Keras graphs and the small layer options in the port's adapter
(``elephas_tpu_torch/models/adapters.py``) against Keras's own: each new
layer (the merges, Concatenate's axis, ZeroPadding, the average and
global poolings) and the graph walk (a shared layer whose second call
reads a later layer) against ``model.predict``; convolution ``groups``,
``channels_first``, BatchNormalization over another axis, a frozen
BatchNormalization and a frozen Dense, ``Dropout(noise_shape)``; the
weight order of a graph whose two BatchNormalization layers have one
width; a small ResNet-like graph's forward, and its 2-worker synchronous
``SparkModel`` fit against ``elephas_tpu.SparkModel``'s; the committed
``configs/resnet50_logits.json`` against ``keras.applications.ResNet50``.

Inputs come from numpy with a seed; the weights are Keras's, drawn anew
(``_randomise``) and read by the port through ``get_weights()``.
Tolerance: atol = rtol = 1e-5, float32 on both sides, unless a test says
otherwise (ResNet-50's forward: twice the float32 error of the head's
sum, as ``test_torch_keras_layers.py`` holds the committed examples).
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import json
from pathlib import Path

import jax
import keras
import numpy as np
import pytest
import torch

from elephas_tpu import SparkModel as JSparkModel
from elephas_tpu.data import SparkContext as JSparkContext
from elephas_tpu.utils import to_simple_rdd as j_to_simple_rdd
from elephas_tpu_torch import SparkModel
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.models import KerasModelAdapter
from elephas_tpu_torch.parallel import engine as port_engine
from elephas_tpu_torch.utils import to_simple_rdd

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "elephas_tpu_torch" / "configs"
TOL = 1e-5
L = keras.layers


def _randomise(m, seed=1):
    """Every weight drawn anew (moving variances positive), so that a bias,
    a gamma or a moving statistic left at its default hides nothing."""
    rng = np.random.default_rng(seed)
    ws = [rng.normal(size=w.shape).astype("float32") * 0.5 for w in m.get_weights()]
    for i, v in enumerate(m.weights):
        if v.path.endswith("moving_variance"):
            ws[i] = np.abs(ws[i]) + 0.5
    m.set_weights(ws)


def _check(m, x, randomise=True):
    if randomise:
        _randomise(m)
    want = m.predict(x, verbose=0)
    adapter = KerasModelAdapter(m, device="cpu")
    got = adapter.predict(x, batch_size=len(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    return adapter


def _functional(build, shape, seed=0):
    keras.utils.set_random_seed(seed)
    inp = keras.Input(shape)
    return keras.Model(inp, build(inp))


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype("float32")


MERGES = ["Add", "Subtract", "Multiply", "Average", "Maximum", "Minimum"]


@pytest.mark.parametrize("merge", MERGES)
def test_merge_layers_match_keras(merge):
    """Two (three) Dense branches of one input, merged."""
    def build(inp):
        branches = [L.Dense(5)(inp) for _ in range(2 if merge == "Subtract" else 3)]
        return L.Dense(3)(getattr(L, merge)()(branches))

    _check(_functional(build, (4,)), _x(6, 4))


@pytest.mark.parametrize("axis", [-1, 1, 2, -2])
def test_concatenate_axis_matches_keras(axis):
    """Keras's axis counts the batch: axis k is axis k + 1 of the port's
    replica stack; a negative one is unchanged."""
    def build(inp):
        a, b = L.Dense(4)(inp), L.Dense(4, activation="tanh")(inp)
        return L.Flatten()(L.Concatenate(axis=axis)([a, b]))

    _check(_functional(build, (3, 2)), _x(5, 3, 2))


def test_shared_layer_runs_every_call_with_one_set_of_weights():
    """A layer called twice, its second call reading a layer the config
    lists after it (the walk puts that call off until its input exists);
    the shared kernel is one array in ``get_weights()``."""
    def build(inp):
        shared = L.Dense(4, activation="tanh", name="shared")
        a = shared(inp)
        b = L.Dense(4, name="other")(a)
        return L.Dense(2)(L.Add()([shared(b), a]))

    m = _functional(build, (4,))
    adapter = _check(m, _x(7, 4))
    assert len(adapter.get_weights()) == len(m.get_weights()) == 6
    assert [type(op).__name__ for op in adapter.layers].count("_Dense") == 4


@pytest.mark.parametrize("padding", [1, (2, 1), ((1, 2), (0, 3))], ids=str)
@pytest.mark.parametrize("fmt", ["channels_last", "channels_first"])
def test_zero_padding2d_matches_keras(padding, fmt):
    """Zeros, not -inf: a max pool after the padding sees them."""
    m = keras.Sequential([keras.Input((4, 5, 3)), L.ZeroPadding2D(padding, data_format=fmt),
                          L.MaxPooling2D(2, padding="same", data_format=fmt)])
    _check(m, _x(3, 4, 5, 3) - 1.0, randomise=False)


def test_zero_padding1d_matches_keras():
    m = keras.Sequential([keras.Input((6, 3)), L.ZeroPadding1D((1, 2)), L.Conv1D(2, 3)])
    _check(m, _x(3, 6, 3))


POOLS = [dict(pool_size=p, strides=s, padding=pad)
         for p, s in ((2, None), (3, 1), (3, 2)) for pad in ("valid", "same")]


@pytest.mark.parametrize("kw", POOLS, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_average_pooling2d_matches_keras(kw):
    """``"same"`` averages over the cells inside the image only (XLA's
    window count), the odd row and column padded after."""
    m = keras.Sequential([keras.Input((7, 6, 3)), L.AveragePooling2D(**kw)])
    _check(m, _x(3, 7, 6, 3), randomise=False)


@pytest.mark.parametrize("layer", ["MaxPooling1D", "AveragePooling1D"])
@pytest.mark.parametrize("padding", ["valid", "same"])
@pytest.mark.parametrize("fmt", ["channels_last", "channels_first"])
def test_pooling1d_matches_keras(layer, padding, fmt):
    m = keras.Sequential([keras.Input((7, 4)),
                          getattr(L, layer)(3, strides=2, padding=padding, data_format=fmt)])
    _check(m, _x(3, 7, 4), randomise=False)


GLOBAL = [(cls, keep, fmt) for cls in ("GlobalAveragePooling2D", "GlobalMaxPooling2D",
                                       "GlobalAveragePooling1D", "GlobalMaxPooling1D")
          for keep in (False, True) for fmt in ("channels_last", "channels_first")]


@pytest.mark.parametrize("cls,keepdims,fmt", GLOBAL,
                         ids=[f"{c}-{k}-{f}" for c, k, f in GLOBAL])
def test_global_pooling_matches_keras(cls, keepdims, fmt):
    shape = (5, 4, 3) if cls.endswith("2D") else (5, 3)
    m = keras.Sequential([keras.Input(shape), getattr(L, cls)(keepdims=keepdims,
                                                              data_format=fmt)])
    _check(m, _x(3, *shape), randomise=False)


@pytest.mark.parametrize("rank,groups,fmt", [(2, 2, "channels_last"), (2, 4, "channels_last"),
                                             (2, 2, "channels_first"), (1, 3, "channels_last"),
                                             (1, 1, "channels_first")])
def test_conv_groups_and_channels_first_match_keras(rank, groups, fmt):
    """``groups`` over the replica stack is ``L * groups`` groups of the
    kernel's ``[*k, in / groups, out]``; channels_first in and out."""
    shape = (6, 5, 12) if rank == 2 else (9, 6)
    if fmt == "channels_first":
        shape = (shape[-1],) + shape[:-1]
    conv = L.Conv2D(8, 3, groups=groups, padding="same", strides=(2, 1), data_format=fmt) \
        if rank == 2 else L.Conv1D(6, 3, groups=groups, dilation_rate=2, data_format=fmt)
    pool = (L.MaxPooling2D(2, data_format=fmt) if rank == 2
            else L.MaxPooling1D(2, data_format=fmt))
    m = keras.Sequential([keras.Input(shape), conv, pool])
    x = _x(4, *shape)
    adapter = _check(m, x)
    # two replicas at once, each with its own weights, give each its own answer
    tv, ntv = adapter.state_values()
    stack = {k: torch.stack([v, 2 * v]) for k, v in tv.items()}
    got = adapter.apply(stack, torch.from_numpy(np.stack([x, x])))
    m.set_weights([2 * w for w in m.get_weights()])
    np.testing.assert_allclose(got[1].numpy(), m.predict(x, verbose=0), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("axis", [1, 2, -2])
def test_batch_normalization_other_axis_matches_keras(axis):
    """Inference by the moving statistics, training by the batch's moments
    over every other axis, the statistics moved as Keras moves them."""
    m = keras.Sequential([keras.Input((5, 4, 3)), L.BatchNormalization(axis=axis)])
    x = _x(6, 5, 4, 3) * 3.0 + 2.0
    adapter = _check(m, x)
    tv, ntv = ({k: v[None] for k, v in d.items()} for d in adapter.state_values())
    got, ntv2 = adapter.stateless_call(tv, ntv, torch.from_numpy(x)[None], training=True)
    want = np.asarray(m(x, training=True))
    np.testing.assert_allclose(got[0].numpy(), want, atol=TOL, rtol=TOL)
    for v in m.non_trainable_variables:
        name = "/".join(v.path.split("/")[-2:])
        np.testing.assert_allclose(ntv2[name][0].numpy(), np.asarray(v), atol=TOL, rtol=TOL)


def test_frozen_layers_stay_out_of_training():
    """A frozen BatchNormalization runs in inference mode also in training
    (Keras 3), its gamma and beta non-trainable; a frozen Dense keeps its
    weights. ``get_weights()`` keeps the layers' order; ``(tv, ntv)`` are
    Keras's ``trainable_variables`` and ``non_trainable_variables``; a
    train step moves neither."""
    m = keras.Sequential([keras.Input((4,)), L.Dense(6, trainable=False, name="frozen"),
                          L.BatchNormalization(trainable=False), L.Dense(3, name="head")])
    m.compile("sgd", "mse")
    x = _x(8, 4)
    adapter = _check(m, x)
    for got, want in zip(adapter.get_weights(), m.get_weights()):
        np.testing.assert_array_equal(got, want)
    tv, ntv = adapter.state_values()
    names = lambda vs: {"/".join(v.path.split("/")[-2:]) for v in vs}  # noqa: E731
    assert set(tv) == names(m.trainable_variables)
    assert set(ntv) == names(m.non_trainable_variables)
    stack = {k: v[None] for k, v in tv.items()}
    nstack = {k: v[None] for k, v in ntv.items()}
    got, ntv2 = adapter.stateless_call(stack, nstack, torch.from_numpy(x)[None], training=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(m(x, training=True)),
                               atol=TOL, rtol=TOL)
    opt = adapter.make_optimizer()
    y = torch.from_numpy(_x(1, 8, 3))
    tv2, ntv3, _, _ = adapter.build_train_step(opt)(
        stack, nstack, opt.init(stack, count_shape=(1,)), torch.from_numpy(x)[None], y,
        torch.ones(1, 8), None)
    for k, v in nstack.items():
        assert torch.equal(ntv3[k], v), k
    assert set(tv2) == {"head/kernel", "head/bias"}
    assert not torch.equal(tv2["head/kernel"], stack["head/kernel"])


@pytest.mark.parametrize("noise_shape", [(None, 1, 5), (None, 4, 1), (1, 4, 5)], ids=str)
def test_dropout_noise_shape_draws_one_mask_per_replica(noise_shape):
    """One mask at ``noise_shape`` (``None`` axes the input's), broadcast
    over the others, per replica; kept values scaled by ``1 / (1 - rate)``,
    as Keras's own training call (whose draws differ) keeps them; inference
    is the identity."""
    m = keras.Sequential([keras.Input((4, 5)), L.Dropout(0.5, noise_shape=noise_shape)])
    x = np.abs(_x(6, 4, 5)) + 1.0
    adapter = _check(m, x, randomise=False)
    gen = torch.Generator().manual_seed(3)
    xs = torch.from_numpy(np.stack([x, x, x]))
    got = adapter.apply({}, xs, training=True, generator=gen).numpy()
    keras_out = np.asarray(m(x, training=True))
    for out in [got[0], got[1], got[2], keras_out]:
        kept = out != 0
        np.testing.assert_allclose(out[kept], 2 * x[kept], rtol=1e-6)
        # the mask is constant along every axis noise_shape sets to 1
        for ax, v in enumerate(noise_shape):
            if v == 1:
                assert (kept == kept.take([0], axis=ax)).all()
    assert not (got[0] == got[1]).all() or not (got[1] == got[2]).all()


def options_cnn():
    """An MNIST-shaped CNN through the small options: channels_first
    convolutions (the second of 4 groups), BatchNormalization over the
    channels axis 1, a frozen one, max and average pooling and a Flatten
    in channels_first, ``Dropout(noise_shape)`` dropping whole channels, a
    logits head (K1 on the card). The first convolution has no bias (the
    BatchNormalization after it cancels its gradient, and Adam would step by
    the rounding of a zero)."""
    keras.utils.set_random_seed(0)
    cf = dict(data_format="channels_first")
    m = keras.Sequential([
        L.Reshape((1, 28, 28)),
        L.Conv2D(16, 3, activation="relu", use_bias=False, **cf),
        L.BatchNormalization(axis=1),
        L.Conv2D(32, 3, groups=4, activation="relu", **cf),
        L.MaxPooling2D(2, **cf),
        L.BatchNormalization(axis=1, trainable=False),
        L.AveragePooling2D(2, padding="same", **cf),
        L.Dropout(0.25, noise_shape=(None, 32, 1, 1)),
        L.Flatten(**cf),
        L.Dense(10)])
    m.build((None, 784))
    m.compile(optimizer="adam", loss=keras.losses.CategoricalCrossentropy(from_logits=True),
              metrics=["accuracy"])
    return m


def test_committed_options_cnn_matches_keras():
    """The committed ``configs/mnist_cnn_options.json`` is
    :func:`options_cnn`'s model (layers, options, loss); with Keras's
    weights drawn anew the port's forward is Keras's, and a training call
    leaves the frozen BatchNormalization's four arrays where they were."""
    m = options_cnn()
    arch = json.loads(m.to_json())
    committed = json.loads((CONFIGS / "mnist_cnn_options.json").read_text())
    assert _layer_kinds(committed) == _layer_kinds(arch)
    assert committed["compile_config"]["loss"] == arch["compile_config"]["loss"]
    x = np.random.default_rng(5).uniform(0, 1, size=(6, 784)).astype(np.float32)
    adapter = _check(m, x)
    bn, frozen_bn = [layer.name for layer in m.layers
                     if isinstance(layer, L.BatchNormalization)]
    stats = ["moving_mean", "moving_variance"]
    assert [s.name for s in adapter._specs if not s.trainable] == (
        [f"{bn}/{k}" for k in stats] + [f"{frozen_bn}/{k}" for k in ["gamma", "beta"] + stats])
    tv, ntv = ({k: v[None] for k, v in d.items()} for d in adapter.state_values())
    _, ntv2 = adapter.stateless_call(tv, ntv, torch.from_numpy(x)[None], training=True,
                                     generator=torch.Generator().manual_seed(0))
    assert {k for k in ntv if not torch.equal(ntv2[k], ntv[k])} == {f"{bn}/{k}" for k in stats}


def _two_bn_graph():
    """Two branches, each Conv2D + BatchNormalization of width 8, added: the
    two BatchNormalization layers' arrays have one shape, so only the
    values tell them apart."""
    def build(inp):
        a = L.BatchNormalization(name="bn_a")(L.Conv2D(8, 3, padding="same", name="conv_a")(inp))
        b = L.BatchNormalization(name="bn_b")(L.Conv2D(8, 1, name="conv_b")(inp))
        return L.Dense(3)(L.GlobalAveragePooling2D()(L.Activation("relu")(L.Add()([b, a]))))

    return _functional(build, (6, 6, 2))


def test_weight_order_of_two_equal_batch_normalizations():
    """``get_weights()`` follows ``model.layers``; the port's arrays follow
    it array by array (randomised, so a swap of the two BatchNormalization
    layers changes the forward and the moved statistics)."""
    m = _two_bn_graph()
    x = _x(5, 6, 6, 2)
    adapter = _check(m, x)
    for got, want in zip(adapter.get_weights(), m.get_weights()):
        np.testing.assert_array_equal(got, want)
    names = [s.name for s in adapter._specs]
    keras_names = ["/".join(v.path.split("/")[-2:]) for v in m.weights]
    assert names == keras_names
    tv, ntv = ({k: v[None] for k, v in d.items()} for d in adapter.state_values())
    _, ntv2 = adapter.stateless_call(tv, ntv, torch.from_numpy(x)[None], training=True)
    m(x, training=True)
    for v in m.non_trainable_variables:
        name = "/".join(v.path.split("/")[-2:])
        np.testing.assert_allclose(ntv2[name][0].numpy(), np.asarray(v), atol=TOL, rtol=TOL)


def _bottleneck(x, filters, name, project):
    """Keras's ResNet50 ``block1``: 1x1, 3x3 and 1x1 convolutions with
    BatchNormalization, a projection (or identity) shortcut, Add, ReLU."""
    bn = lambda n: L.BatchNormalization(axis=3, epsilon=1.001e-5, name=f"{name}_{n}_bn")  # noqa: E731
    shortcut = x
    if project:
        shortcut = bn("0")(L.Conv2D(4 * filters, 1, name=f"{name}_0_conv")(x))
    x = L.Activation("relu")(bn("1")(L.Conv2D(filters, 1, name=f"{name}_1_conv")(x)))
    x = L.Activation("relu")(bn("2")(L.Conv2D(filters, 3, padding="same",
                                              name=f"{name}_2_conv")(x)))
    x = bn("3")(L.Conv2D(4 * filters, 1, name=f"{name}_3_conv")(x))
    return L.Activation("relu")(L.Add()([shortcut, x]))


def small_resnet(seed=0):
    """ResNet-50's stem and two bottleneck blocks at widths 4-16 on 16x16x3
    images: ZeroPadding2D, a 3x3 stride-2 Conv2D, BatchNormalization, ReLU,
    ZeroPadding2D and a 3x3 stride-2 MaxPooling2D; a block with a projection
    shortcut and one with an identity; GlobalAveragePooling2D and a logits
    Dense. SGD, categorical cross-entropy from logits, accuracy."""
    keras.utils.set_random_seed(seed)
    inp = keras.Input((16, 16, 3))
    x = L.Conv2D(8, 3, strides=2, name="conv1_conv")(L.ZeroPadding2D(1)(inp))
    x = L.Activation("relu")(L.BatchNormalization(axis=3, epsilon=1.001e-5)(x))
    x = L.MaxPooling2D(3, strides=2)(L.ZeroPadding2D(1)(x))
    x = _bottleneck(x, 4, "block1", project=True)
    x = _bottleneck(x, 4, "block2", project=False)
    out = L.Dense(10, name="predictions")(L.GlobalAveragePooling2D()(x))
    m = keras.Model(inp, out)
    m.compile(optimizer=keras.optimizers.SGD(0.05),
              loss=keras.losses.CategoricalCrossentropy(from_logits=True),
              metrics=["accuracy"])
    return m


def image_data(n=48, seed=0):
    """Uniform 16x16x3 images, labelled by which of 10 random projections
    of the image is largest."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, 16, 16, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[(x.reshape(n, -1) @ rng.normal(size=(768, 10))).argmax(1)]
    return x, y


def test_small_resnet_forward_matches_keras():
    m = small_resnet()
    x, _ = image_data(6)
    adapter = _check(m, x)
    assert [type(op).__name__ for op in adapter.layers].count("_Merge") == 2


def jax_permutation(seed, n_workers, epoch, n_rows):
    """The JAX engine's epoch order on its 8 CPU devices (as
    ``tests/test_torch_engine.py`` puts it into the port's engine)."""
    wp = -(-n_workers // jax.device_count()) * jax.device_count()
    keys = jax.random.split(jax.random.PRNGKey(seed), wp)
    return np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(keys[w], epoch),
                                                       n_rows))
                     for w in range(n_workers)])


def assert_same_fit(tsm, jsm):
    """Histories and final weights (moving statistics included) of two
    fits within the engine tests' pins."""
    jh, th = jsm.training_histories[-1], tsm.training_histories[-1]
    assert set(th) == set(jh)
    for k in jh:
        np.testing.assert_allclose(th[k], jh[k], atol=TOL, rtol=TOL, err_msg=k)
    for a, b in zip(tsm.master_network.get_weights(), jsm.master_network.get_weights()):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


def test_small_resnet_fit_matches_jax_spark_model(monkeypatch):
    """2 workers, synchronous, epoch frequency, 2 epochs, validation 0.25:
    the port's ``SparkModel`` against ``elephas_tpu.SparkModel`` with the
    JAX engine's order put in; each replica normalises over its own rows
    and the moving statistics merge with the parameters."""
    monkeypatch.setattr(port_engine, "epoch_permutation", jax_permutation)
    x, y = image_data()
    kw = dict(mode="synchronous", frequency="epoch", parameter_server_mode="jax",
              num_workers=2)
    fit = dict(epochs=2, batch_size=8, validation_split=0.25)
    jsm = JSparkModel(small_resnet(), **kw)
    jsm.fit(j_to_simple_rdd(JSparkContext("local[2]"), x, y), **fit)
    tsm = SparkModel(small_resnet(), device="cpu", **kw)
    tsm.fit(to_simple_rdd(SparkContext("local[2]"), x, y), **fit)
    assert_same_fit(tsm, jsm)


def _resnet50():
    keras.utils.set_random_seed(0)
    m = keras.applications.ResNet50(weights=None, input_shape=(32, 32, 3), classes=10,
                                    classifier_activation=None)
    m.compile(optimizer="sgd", loss=keras.losses.CategoricalCrossentropy(from_logits=True),
              metrics=["accuracy"])
    return m


def _layer_kinds(arch):
    """Each layer's class, calls and options; the input layer's name, which
    Keras numbers by the models built before in the process, as one."""
    inp = arch["config"].get("input_layers", [""])[0]
    return [(layer["class_name"],
             json.dumps(layer.get("inbound_nodes")).replace(f'"{inp}"', '"<input>"'),
             {k: v for k, v in layer["config"].items()
              if k not in ("name", "dtype") and "initializer" not in k})
            for layer in arch["config"]["layers"]]


def test_committed_resnet50_matches_keras():
    """The committed JSON is ``keras.applications.ResNet50(weights=None,
    input_shape=(32, 32, 3), classes=10, classifier_activation=None)``
    compiled with SGD and cross-entropy from logits (layers, their calls,
    options, loss). Read with Keras's weights (the BatchNormalization
    statistics drawn anew), the port's forward on 4 images is within
    ``2 sqrt(n) eps32 S`` of Keras's ``predict``: ``S`` the head's sum of
    magnitudes from Keras's own pooled features, ``n`` its fan-in."""
    m = _resnet50()
    arch = json.loads(m.to_json())
    committed = json.loads((CONFIGS / "resnet50_logits.json").read_text())
    assert _layer_kinds(committed) == _layer_kinds(arch)
    assert committed["compile_config"]["loss"] == arch["compile_config"]["loss"]
    assert committed["config"]["output_layers"] == arch["config"]["output_layers"]
    rng = np.random.default_rng(2)
    ws = m.get_weights()
    for i, v in enumerate(m.weights):
        if "_bn/" in v.path:
            lo, hi = {"gamma": (0.5, 1.0), "beta": (-0.1, 0.1), "moving_mean": (-0.1, 0.1),
                      "moving_variance": (0.5, 1.5)}[v.path.split("/")[-1]]
            ws[i] = rng.uniform(lo, hi, size=ws[i].shape).astype(np.float32)
    m.set_weights(ws)
    x = rng.uniform(0, 1, size=(4, 32, 32, 3)).astype(np.float32)
    want = m.predict(x, verbose=0)
    adapter = KerasModelAdapter((CONFIGS / "resnet50_logits.json").read_text(), weights=ws,
                                device="cpu")
    got = adapter.predict(x, batch_size=4)
    pooled = keras.Model(m.input, m.get_layer("avg_pool").output).predict(x, verbose=0)
    kernel, bias = m.get_layer("predictions").get_weights()
    scale = np.abs(pooled) @ np.abs(kernel) + np.abs(bias)
    atol = 2 * np.sqrt(kernel.shape[0]) * np.finfo(np.float32).eps * scale
    err = np.abs(got - want)
    assert np.all(err <= atol), float((err / atol).max())
    assert len(adapter.get_weights()) == len(ws) == 320
