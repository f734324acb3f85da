"""Nested models, several outputs, second tensors, ``stateful`` and the masks
of the port's adapter (``elephas_tpu_torch/models/adapters.py``) against
Keras 3.13 and ``elephas_tpu.SparkModel``.

- Nested models: a small CNN base (Functional, and a Sequential one) nested
  in a Functional model, frozen and trainable, called with ``training``
  False, True and None, against ``model.predict``; a siamese pair (one
  set of weights, two calls), nesting three deep; the weight order against
  ``get_weights()``; a frozen base's train step runs no convolution
  backward; ``remat=True`` over a nested model; the committed
  ``resnet50_transfer_logits.json`` and ``resnet50_finetune_logits.json``
  against the Keras model they were written from (the 320 arrays in order,
  2 and 214 trainable, the forward within the head-sum bound of
  ``test_committed_resnet50_matches_keras``).
- ``training``: Keras 3.13 runs a model's layers in the mode its own call
  names, which overrides the ``training`` saved with a layer's call
  (``keras/src/models/functional.py`` ``operation_fn``); every step of the
  reference and of Keras names it. So a base called with ``training=False``
  moves its BatchNormalization statistics in a fit unless it is frozen,
  and ``Dropout(x, training=True)`` is off in ``predict``: the reference's
  fits and Keras's ``predict`` show it, and the port follows them.
- ``return_state`` and ``initial_state`` on LSTM, GRU and SimpleRNN (with
  ``return_sequences``, ``go_backwards`` and a mask); ``stateful`` (every
  batch from zeros in the reference's compiled fit and in Keras's host
  fit); a Sequential model with a ``return_state`` layer inside.
- Masks, layer by layer against Keras's own (the mask Keras attaches to
  each layer's output) and the outputs against ``predict``: Dense,
  Activation and Dropout hand a mask on; Reshape, Flatten, Conv1D and
  GlobalMaxPooling1D drop it; the merges OR it (Maximum, Minimum and
  Multiply use it); Concatenate concatenates it; GlobalAveragePooling1D
  takes a masked mean; BatchNormalization's moments in training. A mask
  reaching the loss: ignored by the compiled path (the reference's own
  loss), weighting the loss on the host path and in ``evaluate`` (Keras's).
- Models of several inputs or outputs and BatchNormalization over several
  axes raise with the reason: the reference's ``SparkModel.fit`` fails on
  such a model too, and Keras's constructor refuses the list ``axis``.
- Two-worker synchronous fits against ``elephas_tpu.SparkModel``'s: the
  nested CNN in both stages, the masked classifier, the ``stateful`` LSTM,
  a ``ctc`` model; host-path fits where that path differs.

Inputs come from numpy with a seed; the weights are Keras's, drawn anew
and read through ``get_weights()``. Tolerance: atol = rtol = 1e-5, float32
on both sides, unless a test says otherwise.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import json
import re
from pathlib import Path

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
from elephas_tpu_torch.worker import KerasReplica

from .test_torch_functional import _randomise, assert_same_fit, jax_permutation

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "elephas_tpu_torch" / "configs"
TOL = 1e-5
L = keras.layers


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ids(n=6, t=9, vocab=12, seed=3):
    """Ids with zeros at the end, the start and inside; no all-zero row."""
    x = np.random.default_rng(seed).integers(1, vocab, size=(n, t))
    x[0, 5:] = 0
    x[1, :3] = 0
    x[2, 4] = 0
    return x.astype(np.float32)


def _check(m, x, randomise=True, batch_size=None):
    if randomise:
        _randomise(m)
    want = m.predict(x, verbose=0, batch_size=batch_size)
    adapter = KerasModelAdapter(m, device="cpu")
    got = adapter.predict(x, batch_size=batch_size or len(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    return adapter


# -- nested models -------------------------------------------------------------


def cnn_base(kind="functional", name="base", rate=0.25):
    """A small CNN base: two 3x3 convolutions, each with BatchNormalization
    and ReLU, then Dropout (what a base's inference mode switches off; its
    ``rate`` 0 in the fits, whose masks the two packages draw apart)."""
    layers = [L.Conv2D(6, 3, padding="same", name=f"{name}_c1"),
              L.BatchNormalization(name=f"{name}_bn1"), L.Activation("relu"),
              L.Conv2D(8, 3, name=f"{name}_c2"), L.BatchNormalization(name=f"{name}_bn2"),
              L.Activation("relu"), L.Dropout(rate)]
    if kind == "sequential":
        return keras.Sequential([keras.Input((10, 10, 3))] + layers, name=name)
    inp = keras.Input((10, 10, 3))
    h = inp
    for layer in layers:
        h = layer(h)
    return keras.Model(inp, h, name=name)


def nested_cnn(stage="transfer", training=False, kind="functional", seed=0, lr=0.05,
               rate=0.25):
    """Keras's transfer-learning recipe at small widths: the base frozen
    (``"transfer"``) or trainable (``"finetune"``), called with
    ``training``, under GlobalAveragePooling2D and a logits head; SGD,
    cross-entropy from logits, accuracy."""
    keras.utils.set_random_seed(seed)
    base = cnn_base(kind, rate=rate)
    base.trainable = stage == "finetune"
    inp = keras.Input((10, 10, 3))
    h = base(inp) if training is None else base(inp, training=training)
    out = L.Dense(4, name="head")(L.GlobalAveragePooling2D()(h))
    m = keras.Model(inp, out)
    m.compile(optimizer=keras.optimizers.SGD(lr),
              loss=keras.losses.CategoricalCrossentropy(from_logits=True),
              metrics=["accuracy"])
    return m


def images(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, 10, 10, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[(x.reshape(n, -1) @ rng.normal(size=(300, 4))).argmax(1)]
    return x, y


@pytest.mark.parametrize("training", [False, True, None], ids=["False", "True", "None"])
@pytest.mark.parametrize("stage", ["transfer", "finetune"])
def test_nested_base_matches_keras_predict(stage, training):
    """Frozen and trainable, under each ``training``: the forward against
    ``predict`` and Keras's own training call (whose mode overrides the
    saved ``training``), the trainable arrays as Keras counts them."""
    m = nested_cnn(stage, training)
    x, _ = images(5)
    adapter = _check(m, x)
    assert sum(s.trainable for s in adapter._specs) == len(m.trainable_weights)
    assert [w.shape for w in adapter.get_weights()] == [w.shape for w in m.get_weights()]
    tv, ntv = ({k: v[None] for k, v in d.items()} for d in adapter.state_values())
    # no Dropout draw in a frozen base's training call: its BatchNormalization
    # runs on the moving statistics either way; with the base trainable the
    # batch's moments, as Keras's call in training mode
    m2 = nested_cnn(stage, training)
    m2.set_weights(m.get_weights())
    m2.get_layer("base").get_layer(index=7).rate = 0.0
    text = json.loads(m2.to_json())
    for layer in text["config"]["layers"][1]["config"]["layers"]:
        if layer["class_name"] == "Dropout":
            layer["config"]["rate"] = 0.0
    a2 = KerasModelAdapter(json.dumps(text), weights=m.get_weights(), device="cpu")
    got, _ = a2.stateless_call(tv, ntv, torch.from_numpy(x)[None], training=True)
    want = np.asarray(m2(x, training=True))
    np.testing.assert_allclose(got[0].numpy(), want, atol=TOL, rtol=TOL)


def test_nested_sequential_in_sequential_and_three_deep():
    """A Sequential base inside a Sequential model, and a model nested
    three deep (a Functional in a Sequential in a Functional)."""
    keras.utils.set_random_seed(0)
    m = keras.Sequential([keras.Input((10, 10, 3)), cnn_base("sequential"),
                          L.GlobalAveragePooling2D(), L.Dense(3)])
    x, _ = images(4)
    _check(m, x)
    keras.utils.set_random_seed(0)
    middle = keras.Sequential([keras.Input((10, 10, 3)), cnn_base("functional", "inner"),
                               L.Flatten(), L.Dense(5, activation="tanh")], name="middle")
    inp = keras.Input((10, 10, 3))
    m = keras.Model(inp, L.Dense(2)(middle(inp)))
    adapter = _check(m, x)
    assert len(adapter.get_weights()) == len(m.get_weights()) == 16


def test_siamese_pair_shares_one_set_of_weights():
    """One nested base called on two tensors: one set of weights (Keras's
    count), each call with it, against ``predict``."""
    keras.utils.set_random_seed(0)
    bi = keras.Input((6,))
    tower = keras.Model(bi, L.Dense(4, activation="tanh")(L.BatchNormalization()(
        L.Dense(5)(bi))), name="tower")
    inp = keras.Input((6,))
    a, b = tower(inp), tower(L.Dense(6, name="shift")(inp))
    m = keras.Model(inp, L.Dense(2)(L.Concatenate()([a, L.Subtract()([a, b])])))
    adapter = _check(m, _x(7, 6))
    assert len(adapter.get_weights()) == len(m.get_weights()) == 12
    assert [type(op).__name__ for op in adapter.layers].count("_Dense") == 6


def test_frozen_base_runs_no_backward_through_it():
    """A train step of the frozen stage computes no gradient in the base:
    no convolution backward runs (the base's parameters are constants, and
    so is the input); the trainable stage runs both convolutions'."""
    from torch.profiler import ProfilerActivity, profile

    x, y = images(8)
    for stage, want in (("transfer", 0), ("finetune", 2)):
        adapter = KerasModelAdapter(nested_cnn(stage), device="cpu")
        tv, ntv = ({k: v[None] for k, v in d.items()} for d in adapter.state_values())
        opt = adapter.make_optimizer()
        step = adapter.build_train_step(opt)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(tv, ntv, opt.init(tv, count_shape=(1,)), torch.from_numpy(x)[None],
                 torch.from_numpy(y)[None], torch.ones(1, 8), torch.Generator().manual_seed(0))
        n = sum(e.count for e in prof.key_averages() if e.key == "aten::convolution_backward")
        assert n == want, (stage, n)


@pytest.mark.parametrize("stage", ["transfer", "finetune"])
def test_remat_over_a_nested_model_keeps_the_step(stage):
    """``remat=True`` over a nested base: the same step, the same moved
    statistics (dropout off: the recompute would draw other masks)."""
    text = json.loads(nested_cnn(stage).to_json())
    for layer in text["config"]["layers"][1]["config"]["layers"]:
        if layer["class_name"] == "Dropout":
            layer["config"]["rate"] = 0.0
    adapter = KerasModelAdapter(json.dumps(text), device="cpu")
    x, y = images(8)
    outs = []
    for remat in (False, True):
        tv, ntv = ({k: v[None] for k, v in d.items()} for d in adapter.state_values())
        opt = adapter.make_optimizer()
        outs.append(adapter.build_train_step(opt, remat=remat)(
            tv, ntv, opt.init(tv, count_shape=(1,)), torch.from_numpy(x)[None],
            torch.from_numpy(y)[None], torch.ones(1, 8), None))
    for d in (0, 1):
        for k in outs[0][d]:
            torch.testing.assert_close(outs[1][d][k], outs[0][d][k], rtol=1e-6, atol=1e-7)


def resnet50_transfer(stage):
    """``keras.applications.ResNet50(include_top=False, weights=None,
    input_shape=(32, 32, 3))`` frozen (``"transfer"``) or made trainable
    again (``"finetune"``), called with ``training=False`` under
    GlobalAveragePooling2D and a ``Dense(10)`` logits head; SGD (1e-5 for
    the fine-tuning stage, as Keras's guide), cross-entropy from logits,
    accuracy. The committed configs' builder."""
    keras.utils.set_random_seed(0)
    base = keras.applications.ResNet50(include_top=False, weights=None,
                                       input_shape=(32, 32, 3))
    base.trainable = stage == "finetune"
    inp = keras.Input((32, 32, 3), name="image")
    h = base(inp, training=False)
    out = L.Dense(10, name="predictions")(L.GlobalAveragePooling2D(name="avg_pool")(h))
    m = keras.Model(inp, out)
    m.compile(optimizer=keras.optimizers.SGD(1e-5 if stage == "finetune" else 0.01),
              loss=keras.losses.CategoricalCrossentropy(from_logits=True),
              metrics=["accuracy"])
    return m


_POLICIES = ("float32", "float16", "bfloat16", "mixed_float16", "mixed_bfloat16")


def _normalised(text):
    """A config's JSON with every layer and model name as its place among
    the names (Keras numbers a default name, ``dense_12``, by what the
    process built before)."""
    names = []
    for name in re.findall(r'"name": "([^"]+)"', text):
        if name not in names and name not in _POLICIES:
            names.append(name)
    index = {name: i for i, name in enumerate(names)}
    return re.sub(r'"([^"]+)"', lambda m: f'"<{index[m.group(1)]}>"'
                  if m.group(1) in index else m.group(0), text)


def _no_initializers(cfg):
    if isinstance(cfg, dict):
        return {k: _no_initializers(v) for k, v in cfg.items() if "initializer" not in k}
    if isinstance(cfg, list):
        return [_no_initializers(v) for v in cfg]
    return cfg


@pytest.mark.parametrize("stage", ["transfer", "finetune"])
def test_committed_resnet50_transfer_matches_keras(stage):
    """The committed config is the builder's model (layers, calls,
    options, compile config); read with Keras's weights (BatchNormalization
    statistics drawn anew), its 320 arrays are ``get_weights()``'s in order
    with Keras's trainable count, and its forward on 4 images is within
    ``2 sqrt(n) eps32 S`` of ``predict`` (``S`` the head's sum of
    magnitudes from Keras's pooled features, ``n`` its fan-in)."""
    m = resnet50_transfer(stage)
    text = (CONFIGS / f"resnet50_{stage}_logits.json").read_text()
    committed, built = json.loads(_normalised(text)), json.loads(_normalised(m.to_json()))
    assert _no_initializers(committed["config"]) == _no_initializers(built["config"])
    assert committed["compile_config"] == built["compile_config"]
    rng = np.random.default_rng(2)
    ws = m.get_weights()
    for i, v in enumerate(m.weights):
        kind = v.path.split("/")[-1]
        if "_bn" in v.path:
            lo, hi = {"gamma": (0.5, 1.0), "beta": (-0.1, 0.1), "moving_mean": (-0.1, 0.1),
                      "moving_variance": (0.5, 1.5)}[kind]
            ws[i] = rng.uniform(lo, hi, size=ws[i].shape).astype(np.float32)
    m.set_weights(ws)
    adapter = KerasModelAdapter(text, weights=ws, device="cpu")
    assert len(adapter.get_weights()) == 320
    assert sum(s.trainable for s in adapter._specs) == len(m.trainable_weights) == \
        (2 if stage == "transfer" else 214)
    for a, b in zip(adapter.get_weights(), m.get_weights()):
        np.testing.assert_array_equal(a, b)
    x = rng.uniform(0, 1, size=(4, 32, 32, 3)).astype(np.float32)
    want = m.predict(x, verbose=0)
    got = adapter.predict(x, batch_size=4)
    pooled = keras.Model(m.input, m.get_layer("avg_pool").output).predict(x, verbose=0)
    kernel, bias = m.get_layer("predictions").get_weights()
    scale = np.abs(pooled) @ np.abs(kernel) + np.abs(bias)
    atol = 2 * np.sqrt(kernel.shape[0]) * np.finfo(np.float32).eps * scale
    err = np.abs(got - want)
    assert np.all(err <= atol), float((err / atol).max())


@pytest.mark.parametrize("stage", ["transfer", "finetune"])
def test_nested_cnn_fit_matches_jax_spark_model(stage, monkeypatch):
    """2 workers, synchronous, 2 epochs, validation 0.25, the engine's order
    put in: the frozen stage keeps the base bit for bit and trains the head;
    the trainable stage trains the base and moves its statistics (Keras's
    ``training=True`` over the saved ``False``), as the reference's does."""
    monkeypatch.setattr(port_engine, "epoch_permutation", jax_permutation)
    x, y = images(48)
    kw = dict(mode="synchronous", parameter_server_mode="jax", num_workers=2)
    fit = dict(epochs=2, batch_size=8, validation_split=0.25)
    jm = nested_cnn(stage, rate=0.0)
    _randomise(jm)
    w0 = [np.array(w) for w in jm.get_weights()]
    jsm = JSparkModel(jm, **kw)
    jsm.fit(j_to_simple_rdd(JSparkContext("local[2]"), x, y), **fit)
    tm = nested_cnn(stage, rate=0.0)
    tm.set_weights(w0)
    tsm = SparkModel(tm, device="cpu", **kw)
    tsm.fit(to_simple_rdd(SparkContext("local[2]"), x, y), **fit)
    assert_same_fit(tsm, jsm)
    after = tsm.master_network.get_weights()
    moved = [not np.array_equal(a, b) for a, b in zip(after, w0)]
    paths = [v.path for v in tm.weights]
    stats = [i for i, p in enumerate(paths) if "moving" in p]
    if stage == "transfer":
        assert moved == [i >= len(paths) - 2 for i in range(len(paths))]
    else:
        assert all(moved[i] for i in stats)
        assert all(moved[i] for i, p in enumerate(paths) if p.endswith(("kernel", "gamma")))


# -- several outputs and second tensors ----------------------------------------

RECURRENT = [(cls, rs, gb) for cls in ("LSTM", "GRU", "SimpleRNN")
             for rs in (False, True) for gb in (False, True)]


@pytest.mark.parametrize("cls,return_sequences,go_backwards", RECURRENT,
                         ids=[f"{c}-seq{int(r)}-back{int(g)}" for c, r, g in RECURRENT])
def test_return_state_and_initial_state_match_keras(cls, return_sequences, go_backwards):
    """``o, *states = layer(x, return_state=True)``, a second layer of the
    class started from those states (``initial_state``), the output and
    every state into the head: against ``predict``."""
    keras.utils.set_random_seed(0)
    inp = keras.Input((5, 3))
    out, *states = getattr(L, cls)(4, return_state=True, return_sequences=return_sequences,
                                   go_backwards=go_backwards)(inp)
    second = getattr(L, cls)(4, go_backwards=go_backwards)(inp, initial_state=list(states))
    parts = [L.Flatten()(out) if return_sequences else out] + list(states) + [second]
    m = keras.Model(inp, L.Dense(2)(L.Concatenate()(parts)))
    adapter = _check(m, _x(4, 5, 3))
    assert [op.n_outputs for op in adapter.layers[:1]] == [1 + len(states)]


@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
def test_initial_state_under_a_mask_matches_keras(cls):
    """The encoder-decoder pattern on one masked input: the decoder starts
    from the encoder's states and keeps them over masked steps."""
    keras.utils.set_random_seed(0)
    inp = keras.Input((9,))
    emb = L.Embedding(12, 4, mask_zero=True)(inp)
    _, *states = getattr(L, cls)(5, return_state=True)(emb)
    dec = getattr(L, cls)(5, return_sequences=True)(emb, initial_state=list(states))
    m = keras.Model(inp, L.Dense(2)(L.GlobalAveragePooling1D()(dec)))
    _check(m, _ids())


def test_sequential_with_return_state_inside_raises_as_keras():
    """A Sequential model whose ``return_state`` layer is followed by another
    layer: Keras refuses the tuple at the next layer, from the config too,
    and so does the port."""
    keras.utils.set_random_seed(0)
    m = keras.Sequential([keras.Input((5, 3)), L.LSTM(4), L.Dense(2)])
    cfg = json.loads(m.to_json())
    cfg["config"]["layers"][1]["config"]["return_state"] = True
    with pytest.raises(ValueError, match="input"):
        keras.models.model_from_json(json.dumps(cfg))
    with pytest.raises(ValueError, match="expects 1 input"):
        KerasModelAdapter(json.dumps(cfg), device="cpu")


def stateful_lstm(stateful=True, batch=8, seed=0):
    keras.utils.set_random_seed(seed)
    m = keras.Sequential([keras.Input(batch_shape=(batch, 6, 3)),
                          L.LSTM(5, stateful=stateful), L.Dense(3)])
    m.compile(optimizer=keras.optimizers.SGD(0.1),
              loss=keras.losses.CategoricalCrossentropy(from_logits=True),
              metrics=["accuracy"])
    return m


def _sequences(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6, 3)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[(x.sum(1) @ rng.normal(size=(3, 3))).argmax(1)]


def test_stateful_compiled_fit_matches_the_reference(monkeypatch):
    """2 workers, synchronous, batch 8 (the model's batch), 2 epochs: the
    reference's fit of the stateful model equals its fit of the same model
    without the option (its ``stateless_call`` starts every batch from
    zeros), and the port's equals the reference's."""
    monkeypatch.setattr(port_engine, "epoch_permutation", jax_permutation)
    x, y = _sequences()
    kw = dict(mode="synchronous", parameter_server_mode="jax", num_workers=2)
    fit = dict(epochs=2, batch_size=8, validation_split=0.25)
    fits = {}
    for stateful in (True, False):
        jsm = JSparkModel(stateful_lstm(stateful), **kw)
        jsm.fit(j_to_simple_rdd(JSparkContext("local[2]"), x, y), **fit)
        fits[stateful] = jsm
    for k in fits[True].training_histories[-1]:
        np.testing.assert_allclose(fits[True].training_histories[-1][k],
                                   fits[False].training_histories[-1][k], atol=0, rtol=0)
    tsm = SparkModel(stateful_lstm(True), device="cpu", **kw)
    tsm.fit(to_simple_rdd(SparkContext("local[2]"), x, y), **fit)
    assert_same_fit(tsm, fits[True])


def test_stateful_host_fit_matches_keras_fit():
    """Keras 3.13's own ``fit`` (the reference's host workers) of the
    stateful model: every batch from zeros, as without the option, across
    batches and epochs; the port's worker fit matches it."""
    x, y = _sequences()
    hists = {}
    for stateful in (True, False):
        m = stateful_lstm(stateful)
        np.random.seed(3)
        hists[stateful] = m.fit(x, y, epochs=2, batch_size=8, verbose=0,
                                validation_split=0.25).history
    assert hists[True] == hists[False]
    m = stateful_lstm(True)
    replica = KerasReplica(m.to_json(), m.get_weights(), None, None, ["accuracy"],
                           device="cpu")
    np.random.seed(3)
    got = replica.fit(x, y, epochs=2, batch_size=8, verbose=0, validation_split=0.25).history
    for k in hists[True]:
        np.testing.assert_allclose(got[k], hists[True][k], atol=1e-6, rtol=TOL)


# -- masks ----------------------------------------------------------------------


def _keras_masks(m, x):
    """Each layer's output mask as Keras attaches it (None where none), by
    calling the model's graph up to that layer eagerly."""
    from keras.src import backend

    out = {}
    for layer in m.layers[1:] if isinstance(m, keras.Model) and not isinstance(
            m, keras.Sequential) else m.layers:
        sub = keras.Model(m.inputs, layer.output)
        mask = backend.get_keras_mask(sub(x))
        out[layer.name] = None if mask is None else np.asarray(mask)
    return out


def _port_masks(m, x):
    """Each layer's output mask in the port's walk, from the sub-model that
    ends at the layer."""
    out = {}
    for layer in (m.layers[1:] if not isinstance(m, keras.Sequential) else m.layers):
        sub = keras.Model(m.inputs, layer.output)
        adapter = KerasModelAdapter(sub, device="cpu")
        tv, ntv = ({k: v[None] for k, v in d.items()} for d in adapter.state_values())
        with torch.no_grad():
            _, _, mask = adapter.stateless_call(tv, ntv, torch.from_numpy(x)[None],
                                                with_mask=True)
        out[layer.name] = None if mask is None else mask[0].numpy()
    return out


def _masked(build):
    keras.utils.set_random_seed(0)
    inp = keras.Input((9,))
    return keras.Model(inp, build(inp))


MASK_CASES = {
    "dense_activation_dropout": lambda i: L.Dense(2)(L.Dropout(0.3)(L.Activation("tanh")(
        L.Dense(5)(L.Embedding(12, 4, mask_zero=True)(i))))),
    "reshape_drops": lambda i: L.Dense(2)(L.Flatten()(L.Reshape((9, 2, 2))(
        L.Embedding(12, 4, mask_zero=True)(i)))),
    "conv1d_drops": lambda i: L.GlobalAveragePooling1D()(L.Conv1D(3, 2)(
        L.Embedding(12, 4, mask_zero=True)(i))),
    "global_average_1d": lambda i: L.Dense(2)(L.GlobalAveragePooling1D()(L.Dense(5)(
        L.Embedding(12, 4, mask_zero=True)(i)))),
    "global_max_1d_drops": lambda i: L.Dense(2)(L.GlobalMaxPooling1D()(
        L.Embedding(12, 4, mask_zero=True)(i))),
    "batch_norm": lambda i: L.LSTM(3)(L.BatchNormalization()(
        L.Embedding(12, 4, mask_zero=True)(i))),
    **{f"{merge.lower()}_{which}": (lambda merge, which: lambda i: L.GRU(3)(getattr(L, merge)()([
        L.Embedding(12, 4, mask_zero=True)(i),
        L.Embedding(12, 4, mask_zero=which == "both")(L.Activation("linear")(i))])))(merge, which)
       for merge in ("Add", "Subtract", "Multiply", "Average", "Maximum", "Minimum")
       for which in ("both", "one")},
    "concatenate_features": lambda i: L.GRU(3)(L.Concatenate()([
        L.Embedding(12, 4, mask_zero=True)(i), L.Embedding(12, 2)(i)])),
    "concatenate_time": lambda i: L.GRU(3)(L.Concatenate(axis=1)([
        L.Embedding(12, 4, mask_zero=True)(i), L.Embedding(12, 4)(i)])),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_mask_rules_match_keras_layer_by_layer(case):
    """Each layer's output mask against the one Keras attaches, and the
    model's output against ``predict``."""
    m = _masked(MASK_CASES[case])
    x = _ids()
    _randomise(m)
    keras_masks, port_masks = _keras_masks(m, x), _port_masks(m, x)
    assert set(keras_masks) == set(port_masks)
    for name, want in keras_masks.items():
        got = port_masks[name]
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=name)
    _check(m, x, randomise=False)


def test_masked_batch_normalization_moments_match_keras_training():
    """BatchNormalization under a mask in training: the moments over the
    unmasked steps (Keras's weighted ``_moments``) and the statistics moved
    from them, against Keras's own training call."""
    keras.utils.set_random_seed(0)
    m = keras.Sequential([keras.Input((9,)), L.Embedding(12, 4, mask_zero=True),
                          L.BatchNormalization(momentum=0.5)])
    _randomise(m)
    x = _ids()
    adapter = KerasModelAdapter(m, device="cpu")
    tv, ntv = ({k: v[None] for k, v in d.items()} for d in adapter.state_values())
    got, ntv2 = adapter.stateless_call(tv, ntv, torch.from_numpy(x)[None], training=True)
    want = np.asarray(m(x, training=True))
    np.testing.assert_allclose(got[0].numpy(), want, atol=TOL, rtol=TOL)
    bn = m.layers[1]
    for v in (bn.moving_mean, bn.moving_variance):
        name = f"{bn.name}/{v.path.split('/')[-1]}"
        np.testing.assert_allclose(ntv2[name][0].numpy(), np.asarray(v), atol=TOL, rtol=TOL)


def masked_tagger(seed=0):
    """A mask that reaches the loss: Embedding(mask_zero) → GRU returning
    sequences → a per-step softmax, mean squared error on one-hot tags."""
    keras.utils.set_random_seed(seed)
    m = keras.Sequential([keras.Input((9,)), L.Embedding(12, 4, mask_zero=True),
                          L.GRU(5, return_sequences=True), L.Dense(3, activation="softmax")])
    m.compile(optimizer=keras.optimizers.SGD(0.5), loss="mse", metrics=["mae"])
    return m


def _tags(n=48, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 12, size=(n, 9))
    x[np.arange(9)[None, :] >= rng.integers(3, 10, size=n)[:, None]] = 0
    return x.astype(np.float32), np.eye(3, dtype=np.float32)[x.astype(int) % 3]


def test_mask_reaching_the_loss_per_path(monkeypatch):
    """The compiled path's loss is the reference's own, which no mask
    reaches: its 2-worker fit matches ``elephas_tpu.SparkModel``'s. Keras's
    host fit weights the loss by the output's mask (its ``fit`` metrics do
    not see it; its ``evaluate`` and validation do): the port's worker fit
    matches Keras's, and ``SparkModel.evaluate``'s fall-back the
    reference's."""
    monkeypatch.setattr(port_engine, "epoch_permutation", jax_permutation)
    x, y = _tags()
    kw = dict(mode="synchronous", parameter_server_mode="jax", num_workers=2)
    fit = dict(epochs=2, batch_size=8, validation_split=0.25)
    jm = masked_tagger()
    _randomise(jm)
    w0 = [np.array(w) for w in jm.get_weights()]
    jsm = JSparkModel(jm, **kw)
    jsm.fit(j_to_simple_rdd(JSparkContext("local[2]"), x, y), **fit)
    tm = masked_tagger()
    tm.set_weights(w0)
    tsm = SparkModel(tm, device="cpu", **kw)
    tsm.fit(to_simple_rdd(SparkContext("local[2]"), x, y), **fit)
    assert_same_fit(tsm, jsm)
    np.testing.assert_allclose(tsm.predict(x), np.asarray(jsm.predict(x)), atol=TOL,
                               rtol=TOL)
    km = masked_tagger()
    km.set_weights(w0)
    replica = KerasReplica(km.to_json(), w0, None, None, ["mae"], device="cpu")
    np.random.seed(5)
    want = km.fit(x, y, epochs=2, batch_size=16, validation_split=0.25, verbose=0).history
    np.random.seed(5)
    got = replica.fit(x, y, epochs=2, batch_size=16, validation_split=0.25).history
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=TOL, err_msg=k)
    for a, b in zip(replica.get_weights(), km.get_weights()):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=TOL)


def masked_classifier(seed=0, vocab=30):
    """The bag-of-embeddings text classifier: Embedding(mask_zero) → Dense →
    GlobalAveragePooling1D (a masked mean) → a logits head."""
    keras.utils.set_random_seed(seed)
    m = keras.Sequential([keras.Input((12,)), L.Embedding(vocab, 8, mask_zero=True),
                          L.Dense(8, activation="relu"), L.GlobalAveragePooling1D(),
                          L.Dense(2)])
    m.compile(optimizer=keras.optimizers.SGD(0.2),
              loss=keras.losses.CategoricalCrossentropy(from_logits=True),
              metrics=["accuracy"])
    return m


def test_masked_classifier_fit_matches_jax_spark_model(monkeypatch):
    """2 workers, synchronous, 2 epochs, no validation (a padded row is all
    masked, and GlobalAveragePooling1D's mean of it is Keras's 0 / 0: the
    reference's validation sums take in the NaN of the workers it pads to
    its device count, where the port pads none, and so does its
    ``evaluate``; ROADMAP §3); then ``predict`` on every row."""
    from .test_torch_recurrent import padded_ids

    monkeypatch.setattr(port_engine, "epoch_permutation", jax_permutation)
    x, y1 = padded_ids(64, 30, 12)
    y = np.concatenate([1 - y1, y1], axis=1)
    kw = dict(mode="synchronous", parameter_server_mode="jax", num_workers=2)
    fit = dict(epochs=2, batch_size=8, validation_split=0.0)
    jm = masked_classifier()
    _randomise(jm)
    w0 = [np.array(w) for w in jm.get_weights()]
    jsm = JSparkModel(jm, **kw)
    jsm.fit(j_to_simple_rdd(JSparkContext("local[2]"), x, y), **fit)
    tm = masked_classifier()
    tm.set_weights(w0)
    tsm = SparkModel(tm, device="cpu", **kw)
    tsm.fit(to_simple_rdd(SparkContext("local[2]"), x, y), **fit)
    assert_same_fit(tsm, jsm)
    np.testing.assert_allclose(tsm.predict(x), np.asarray(jsm.predict(x)), atol=TOL,
                               rtol=TOL)


def ctc_model(seed=0):
    """Per-step logits over 6 classes (0 the blank) from 16 steps of 8
    features, trained with ``keras.losses.CTC()``."""
    keras.utils.set_random_seed(seed)
    m = keras.Sequential([keras.Input((16, 8)), L.Dense(16, activation="relu"),
                          L.Dense(6)])
    m.compile(optimizer=keras.optimizers.SGD(0.05), loss=keras.losses.CTC())
    return m


def ctc_data(n=64, seed=0):
    """Sequences whose labels (1-5, zero-padded to 4) are the argmax of
    their first four steps' projections."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 16, 8)).astype(np.float32)
    proj = rng.normal(size=(8, 5))
    y = (x[:, ::4] @ proj).argmax(-1) + 1
    y[np.arange(4)[None, :] >= rng.integers(1, 5, size=n)[:, None]] = 0
    return x, y.astype(np.float32)


def test_ctc_model_fit_matches_jax_spark_model(monkeypatch):
    """2 workers, synchronous, 2 epochs: the reference hands ``CTC()`` to
    Keras (one scalar a replica's batch, padded rows in it), and so does
    the port."""
    monkeypatch.setattr(port_engine, "epoch_permutation", jax_permutation)
    x, y = ctc_data()
    kw = dict(mode="synchronous", parameter_server_mode="jax", num_workers=2)
    fit = dict(epochs=2, batch_size=8, validation_split=0.25)
    jm = ctc_model()
    w0 = [np.array(w) for w in jm.get_weights()]
    jsm = JSparkModel(jm, **kw)
    jsm.fit(j_to_simple_rdd(JSparkContext("local[2]"), x, y), **fit)
    tm = ctc_model()
    tm.set_weights(w0)
    tsm = SparkModel(tm, device="cpu", **kw)
    tsm.fit(to_simple_rdd(SparkContext("local[2]"), x, y), **fit)
    assert_same_fit(tsm, jsm)


def test_other_call_arguments_raise_naming_them():
    """A call keyword the port does not read, or a positional argument past
    the first (but a recurrent layer's ``initial_state``), raises naming
    it; a ``training`` that is not a bool is Keras's own error."""
    m = _masked(MASK_CASES["dense_activation_dropout"])
    cfg = json.loads(m.to_json())
    layer = next(l for l in cfg["config"]["layers"] if l["class_name"] == "Dropout")
    node = layer["inbound_nodes"][0]
    for kwargs, err, match in (({"noise": 1.0}, NotImplementedError, "noise"),
                               ({"training": "yes"}, ValueError, "training")):
        node["kwargs"] = kwargs
        with pytest.raises(err, match=match):
            KerasModelAdapter(json.dumps(cfg), device="cpu")
    node["kwargs"] = {}
    node["args"] = node["args"] + [0.5]
    with pytest.raises(NotImplementedError, match="0.5"):
        KerasModelAdapter(json.dumps(cfg), device="cpu")


# -- what the reference does not run -------------------------------------------


def test_several_inputs_or_outputs_raise_beside_the_reference_failing():
    """A model of two inputs and one of two outputs: the port raises at
    construction, saying that the reference's entry points do not take
    one; the reference's ``SparkModel.fit``, ``predict`` and ``evaluate``
    fail on each with their own errors (they stack the rows into one
    ``x`` and one ``y`` array; its host fit fails too)."""
    keras.utils.set_random_seed(0)
    a, b = keras.Input((4,)), keras.Input((4,))
    two_in = keras.Model([a, b], L.Dense(2)(L.Concatenate()([a, b])))
    two_in.compile("sgd", "mse")
    inp = keras.Input((4,))
    two_out = keras.Model(inp, [L.Dense(2)(inp), L.Dense(2)(inp)])
    two_out.compile("sgd", "mse")
    rng = np.random.default_rng(0)
    x2, y1 = rng.normal(size=(64, 2, 4)).astype(np.float32), rng.normal(size=(64, 2))
    x1, y2 = rng.normal(size=(64, 4)).astype(np.float32), rng.normal(size=(64, 2, 2))
    for m, x, y, err, what in ((two_in, x2, y1, ValueError, "input"),
                               (two_out, x1, y2, AttributeError, "output")):
        jsm = JSparkModel(m, mode="synchronous", num_workers=2)
        with pytest.raises(err):
            jsm.fit(j_to_simple_rdd(JSparkContext("local[2]"), x, y.astype(np.float32)),
                    epochs=1, batch_size=16)
        for call in (lambda: jsm.predict(x), lambda: jsm.evaluate(x, y.astype(np.float32))):
            with pytest.raises(err):
                call()
        with pytest.raises(NotImplementedError, match=f"a model of 2 {what}s: the "
                                                      f"reference's entry points"):
            KerasModelAdapter(m, device="cpu")


def test_batch_normalization_over_several_axes_raises_with_keras_reason():
    """Keras 3.13's constructor refuses a list ``axis`` of two, so no Keras
    JSON carries one; a config edited to hold one raises saying so."""
    with pytest.raises(TypeError):
        L.BatchNormalization(axis=[1, 2])
    m = keras.Sequential([keras.Input((4, 3)), L.BatchNormalization()])
    cfg = json.loads(m.to_json())
    cfg["config"]["layers"][1]["config"]["axis"] = [1, 2]
    with pytest.raises(NotImplementedError, match="Keras's constructor refuses") as err:
        KerasModelAdapter(json.dumps(cfg), device="cpu")
    assert "item 13" not in str(err.value)


# -- the card's small models ----------------------------------------------------


def graph_option_models():
    """The small models ``chip_smoke.py``'s ``fit_graph_options`` fits on the
    card (the committed ``configs/graph_options.json``): the encoder-decoder
    LSTMs on one input (``return_state``, ``initial_state``), the masked
    bag-of-embeddings classifier, a ``stateful`` LSTM (batch 32), a ``ctc``
    tagger, and an MLP compiled with AUC, Precision and F1Score; each with
    a logits head where it has a cross-entropy."""
    def compiled(m, loss, lr, metrics=("accuracy",)):
        m.compile(optimizer=keras.optimizers.SGD(lr), loss=loss, metrics=list(metrics))
        return m

    xent = keras.losses.CategoricalCrossentropy(from_logits=True)
    keras.utils.set_random_seed(0)
    inp = keras.Input((12, 8), name="steps")
    out, h, c = L.LSTM(16, return_state=True, name="encoder")(inp)
    dec = L.LSTM(16, name="decoder")(inp, initial_state=[h, c])
    states = keras.Model(inp, L.Dense(10, name="logits")(L.Concatenate()([out, c, dec])))
    models = {"lstm_states": compiled(states, xent, 0.1)}
    keras.utils.set_random_seed(0)
    models["masked_classifier"] = compiled(keras.Sequential([
        keras.Input((20,)), L.Embedding(500, 16, mask_zero=True),
        L.Dense(16, activation="relu"), L.GlobalAveragePooling1D(), L.Dense(2)]), xent, 0.2)
    keras.utils.set_random_seed(0)
    models["stateful_lstm"] = compiled(keras.Sequential([
        keras.Input(batch_shape=(32, 12, 8)), L.LSTM(16, stateful=True), L.Dense(10)]),
        xent, 0.1)
    keras.utils.set_random_seed(0)
    models["ctc"] = compiled(keras.Sequential([
        keras.Input((16, 8)), L.Dense(16, activation="relu"), L.Dense(6)]),
        keras.losses.CTC(), 0.05, ())
    keras.utils.set_random_seed(0)
    models["metrics_mlp"] = compiled(keras.Sequential([
        keras.Input((32,)), L.Dense(32, activation="relu"), L.Dense(4)]), xent, 0.1,
        (keras.metrics.AUC(from_logits=True), keras.metrics.Precision(),
         keras.metrics.F1Score()))
    return models


def test_committed_graph_options_match_their_builders():
    """``configs/graph_options.json`` holds each small model's JSON as
    :func:`graph_option_models` writes it, and the port reads each."""
    committed = json.loads((CONFIGS / "graph_options.json").read_text())
    built = graph_option_models()
    assert sorted(committed) == sorted(built)
    for name, m in built.items():
        got = json.loads(_normalised(committed[name]))
        want = json.loads(_normalised(m.to_json()))
        assert _no_initializers(got["config"]) == _no_initializers(want["config"]), name
        assert got["compile_config"] == want["compile_config"], name
        adapter = KerasModelAdapter(committed[name], weights=m.get_weights(), device="cpu")
        assert len(adapter.get_weights()) == len(m.get_weights())
