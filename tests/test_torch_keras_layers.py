"""The port's Keras layers (``elephas_tpu_torch/models/adapters.py``) against
Keras's own: each layer the repo's examples build (Reshape, Conv2D,
MaxPooling2D, BatchNormalization, Embedding, LSTM, Conv1D), alone and in
the three committed example models, forward against ``model.predict``
(and, for BatchNormalization in training, against Keras's own training
call and its moved statistics), over the padding, stride, dilation,
``causal`` and ``return_sequences`` options; the options the port refuses;
the Embedding's range check.

Inputs are made with numpy from a seed; the weights are Keras's own,
read by the port through ``get_weights()``. Tolerance: atol = rtol = 1e-5,
float32 on both sides (convolutions and matmuls sum in other orders).
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import json
from pathlib import Path

import keras
import numpy as np
import pytest
import torch

from elephas_tpu_torch.models import KerasModelAdapter

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "elephas_tpu_torch" / "configs"
TOL = 1e-5


def _model(layers, input_shape, seed=0):
    keras.utils.set_random_seed(seed)
    m = keras.Sequential([keras.layers.Input(input_shape)] + layers)
    m.compile("adam", "mse")
    return m


def _randomise(m, seed=1):
    """Every weight drawn anew (moving variances positive), so that a bias,
    a gamma or a moving statistic left at its default hides nothing."""
    rng = np.random.default_rng(seed)
    ws = [rng.normal(size=w.shape).astype("float32") * 0.5 for w in m.get_weights()]
    for i, v in enumerate(m.weights):
        if v.path.endswith("moving_variance"):
            ws[i] = np.abs(ws[i]) + 0.5
    m.set_weights(ws)


def _port_predict(m, x):
    adapter = KerasModelAdapter(m, device="cpu")
    return adapter, adapter.predict(x, batch_size=len(x))


def _check_forward(layers, input_shape, x, seed=0):
    m = _model(layers, input_shape, seed)
    _randomise(m)
    want = m.predict(x, verbose=0)
    adapter, got = _port_predict(m, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    return adapter


def _images(n=5, h=9, w=7, c=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, h, w, c)).astype("float32")


CONV2D = [dict(padding=p, strides=s, dilation_rate=d)
          for p in ("valid", "same") for s, d in ((1, 1), (2, 1), (1, 2), (3, 1))]


@pytest.mark.parametrize("kw", CONV2D, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_conv2d_matches_keras(kw):
    """Odd heights and widths under ``same`` with a stride: the extra row and
    column go after, as XLA pads them."""
    _check_forward([keras.layers.Conv2D(4, (3, 2), activation="relu", **kw)], (9, 7, 3),
                   _images())


POOLS = [dict(pool_size=p, strides=s, padding=pad)
         for p, s in ((2, None), (3, None), (3, 1), (2, 3)) for pad in ("valid", "same")]


@pytest.mark.parametrize("kw", POOLS, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_max_pooling2d_matches_keras(kw):
    _check_forward([keras.layers.MaxPooling2D(**kw)], (9, 7, 3), _images())


CONV1D = [dict(padding=p, strides=s, dilation_rate=d)
          for p in ("valid", "same", "causal") for s, d in ((1, 1), (2, 1), (1, 3))]


@pytest.mark.parametrize("kw", CONV1D, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_conv1d_matches_keras(kw):
    x = np.random.default_rng(2).normal(size=(4, 11, 3)).astype("float32")
    _check_forward([keras.layers.Conv1D(5, 3, activation="tanh", **kw)], (11, 3), x)


@pytest.mark.parametrize("target", [(4, 6), (-1, 3), (2, -1, 2)])
def test_reshape_matches_keras(target):
    x = np.random.default_rng(3).normal(size=(3, 24)).astype("float32")
    _check_forward([keras.layers.Reshape(target), keras.layers.Flatten(),
                    keras.layers.Dense(5)], (24,), x)


@pytest.mark.parametrize("kw", [dict(), dict(center=False), dict(scale=False),
                                dict(momentum=0.9, epsilon=1e-5)], ids=str)
@pytest.mark.parametrize("shape", [(6,), (5, 4, 3)], ids=["dense", "image"])
def test_batch_normalization_matches_keras(kw, shape):
    """Inference: the moving statistics. Training: the batch's moments (the
    biased variance) and the statistics moved as Keras moves them."""
    x = np.random.default_rng(4).normal(2.0, 3.0, size=(7,) + shape).astype("float32")
    adapter = _check_forward([keras.layers.BatchNormalization(**kw)], shape, x)
    m = _model([keras.layers.BatchNormalization(**kw)], shape)
    _randomise(m)
    adapter.set_weights(m.get_weights())
    tv, ntv = ({k: v[None] for k, v in d.items()} for d in adapter.state_values())
    got, ntv2 = adapter.stateless_call(tv, ntv, torch.from_numpy(x)[None], training=True)
    want = np.asarray(m(x, training=True))            # moves Keras's statistics
    np.testing.assert_allclose(got[0].numpy(), want, atol=TOL, rtol=TOL)
    ntv_names = [n for n in ntv]
    assert [n.split("/")[-1] for n in ntv_names] == ["moving_mean", "moving_variance"]
    keras_ntv = [np.asarray(v) for v in m.non_trainable_variables
                 if v.path.endswith(("moving_mean", "moving_variance"))]
    for n, want_s in zip(ntv_names, keras_ntv):
        np.testing.assert_allclose(ntv2[n][0].numpy(), want_s, atol=TOL, rtol=TOL)


def test_embedding_matches_keras_and_refuses_ids_out_of_range():
    """Float ids (the engine stages ``x`` as float32; the example feeds
    float64) are truncated as Keras casts them; an id outside ``[0,
    input_dim)`` raises where the reference's gather reads no row."""
    ids = np.random.default_rng(5).integers(0, 13, size=(6, 9)).astype("float64")
    adapter = _check_forward([keras.layers.Embedding(13, 4), keras.layers.Flatten(),
                              keras.layers.Dense(3)], (9,), ids)
    for bad in (13, -1):
        x = ids.copy()
        x[2, 3] = bad
        with pytest.raises(ValueError, match=r"\[0, 13\)"):
            adapter.predict(x)


@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("kw", [dict(), dict(use_bias=False), dict(unit_forget_bias=False),
                                dict(activation="relu", recurrent_activation="hard_sigmoid")],
                         ids=str)
def test_lstm_matches_keras(return_sequences, kw):
    x = np.random.default_rng(6).normal(size=(5, 8, 3)).astype("float32")
    _check_forward([keras.layers.LSTM(4, return_sequences=return_sequences, **kw)],
                   (8, 3), x)


def _mnist_cnn(head=None, bn=False):
    """``examples/mnist_cnn_async.py``'s CNN (``bn``: a BatchNormalization after
    each Conv2D); ``head=None`` is the logits head of the committed JSON."""
    keras.utils.set_random_seed(0)
    layers = [keras.layers.Reshape((28, 28, 1)), keras.layers.Conv2D(16, 3, activation="relu")]
    layers += [keras.layers.BatchNormalization()] if bn else []
    layers += [keras.layers.MaxPooling2D(2), keras.layers.Conv2D(32, 3, activation="relu")]
    layers += [keras.layers.BatchNormalization()] if bn else []
    layers += [keras.layers.MaxPooling2D(2), keras.layers.Flatten(),
               keras.layers.Dense(64, activation="relu"), keras.layers.Dense(10, activation=head)]
    m = keras.Sequential(layers)
    m.build((None, 784))
    m.compile(optimizer="adam",
              loss=keras.losses.CategoricalCrossentropy(from_logits=head is None),
              metrics=["accuracy"])
    return m


def _imdb_lstm():
    """``examples/ml_pipeline_imdb_lstm.py``'s model."""
    keras.utils.set_random_seed(0)
    m = keras.Sequential([keras.layers.Embedding(2000, 32), keras.layers.LSTM(32),
                          keras.layers.Dense(1, activation="sigmoid")])
    m.build((None, 80))
    m.compile(optimizer="adam", loss="binary_crossentropy", metrics=["accuracy"])
    return m


def _layer_kinds(arch):
    return [(layer["class_name"], {k: v for k, v in layer["config"].items()
                                   if k not in ("name", "dtype") and "initializer" not in k})
            for layer in arch["config"]["layers"]]


EXAMPLES = [("mnist_cnn_logits.json", lambda: _mnist_cnn()),
            ("mnist_cnn_bn.json", lambda: _mnist_cnn(bn=True)),
            ("imdb_lstm.json", _imdb_lstm)]


def _head_sum_scale(adapter, x):
    """``(S, n)``: ``S[b, k] = sum_j |h_bj W_jk| + |b_k|`` of the model's last
    Dense, ``h`` its input from a float64 forward through the port's layers,
    and ``n`` the Dense's fan-in: the magnitude and length of the float32
    sum that rounds last before the output."""
    tv, ntv = adapter.state_values()
    p64 = {k: v.double()[None] for k, v in {**tv, **ntv}.items()}
    *body, head = adapter.layers
    h = torch.as_tensor(np.asarray(x, np.float64))[None]
    with torch.no_grad():
        for op in body:
            h = op(p64, h, False, None, None)
    kernel, bias = (p64[s.name][0] for s in head.weight_shapes())
    return (h[0].abs() @ kernel.abs() + bias.abs()).numpy(), kernel.shape[0]


@pytest.mark.parametrize("name,make", EXAMPLES, ids=[e[0] for e in EXAMPLES])
def test_committed_example_models_match_keras(name, make):
    """The committed JSON of each model the card drives is the example's
    model (layers, options, loss, optimizer); read with Keras's weights, the
    port's forward equals Keras ``predict`` on 16 samples at 1, 2, 3, 4, 6
    and 8 intra-op threads, each output within twice the float32 error of
    the head's sum, ``2 sqrt(n) eps32 S`` (two float32 evaluations of a sum
    of ``n`` terms whose magnitudes add up to ``S``, ``_head_sum_scale``):
    the logits are ~100 and sums of ~100-sized terms, so a fixed 1e-5 pins
    a near-zero logit below the rounding of its own sum, and the order of
    the sums changes with the thread count."""
    m = make()
    committed = json.loads((CONFIGS / name).read_text())
    assert _layer_kinds(committed) == _layer_kinds(json.loads(m.to_json()))
    assert committed["compile_config"]["loss"] == json.loads(m.to_json())["compile_config"]["loss"]
    _randomise(m)
    rng = np.random.default_rng(7)
    x = (rng.integers(0, 2000, size=(16, 80)).astype("float64") if "lstm" in name
         else rng.uniform(0, 1, size=(16, 784)).astype("float32"))
    adapter = KerasModelAdapter((CONFIGS / name).read_text(), weights=m.get_weights(),
                                device="cpu")
    want = m.predict(x, verbose=0)
    scale, n = _head_sum_scale(adapter, x)
    atol = 2 * np.sqrt(n) * np.finfo(np.float32).eps * scale
    threads = torch.get_num_threads()
    try:
        for t in (1, 2, 3, 4, 6, 8):
            torch.set_num_threads(t)
            err = np.abs(adapter.predict(x, batch_size=8) - want)
            assert np.all(err <= atol), (t, float((err / atol).max()))
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("layer,shape,match", [
    (lambda: keras.layers.LSTM(2, go_backwards=True, return_state=True), (5, 3),
     "return_state"),
    (lambda: keras.layers.GRU(2, return_state=True), (5, 3), "return_state"),
    (lambda: keras.layers.LSTM(2, return_state=True), (5, 3), "return_state"),
    (lambda: keras.layers.SimpleRNN(2, return_state=True), (5, 3), "return_state"),
    (lambda: keras.layers.Dense(2, dtype="bfloat16"), (4,), "'bfloat16'"),
    (lambda: keras.layers.Dense(2, dtype="float16"), (4,), "'float16'"),
])
def test_unported_layer_options_raise_naming_their_item(layer, shape, match):
    """The pure 16-bit policies still raise naming item 13. A Sequential
    model ending in a ``return_state`` layer is a model of several outputs
    in Keras 3.13 (its ``predict`` returns the output and the states),
    which the reference's entry points do not take: it raises saying so
    (``tests/test_torch_graph_options.py`` runs ``return_state`` inside a
    one-output graph)."""
    m = keras.Sequential([keras.layers.Input(shape), layer()])
    if match == "return_state":
        outs = m.predict(np.zeros((2,) + shape, np.float32), verbose=0)
        assert isinstance(outs, (list, tuple)) and len(outs) > 1
        with pytest.raises(NotImplementedError, match=f"a model of {len(outs)} outputs: "
                                                      f"the reference's entry points"):
            KerasModelAdapter(m, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=match) as err:
        KerasModelAdapter(m, device="cpu")
    assert "item 13" in str(err.value)


NEW_ACTIVATIONS = ["celu", "glu", "hard_shrink", "hard_tanh", "log_sigmoid", "soft_shrink",
                   "sparse_plus", "sparse_sigmoid", "sparsemax", "squareplus", "tanh_shrink"]


@pytest.mark.parametrize("name", NEW_ACTIVATIONS)
def test_keras_activations_match_keras(name):
    """The activations Keras 3.13 has beyond the first ported set, on a
    Dense layer and as an Activation layer, against Keras's ``predict``
    over inputs spread across every branch (|x| past 1 and inside it)."""
    keras.utils.set_random_seed(0)
    m = keras.Sequential([keras.Input((6,)), keras.layers.Dense(8, activation=name),
                          keras.layers.Activation(name)])
    rng = np.random.default_rng(len(name))
    m.set_weights([w + rng.normal(size=w.shape).astype(np.float32) for w in m.get_weights()])
    x = (rng.normal(size=(16, 6)) * 2).astype(np.float32)
    got = KerasModelAdapter(m, device="cpu").predict(x)
    np.testing.assert_allclose(got, m.predict(x, verbose=0), atol=TOL, rtol=TOL)


def test_identity_initializer_matches_keras():
    """``Identity(gain)``: ``gain`` times the identity of the kernel's 2-D
    shape, as ``model_from_json`` draws it (Keras 3.13 leaves ``gain`` out of
    the initializer's config, so the JSON's kernels take gain 1)."""
    m = keras.Sequential([keras.Input((5,)), keras.layers.Dense(
        7, kernel_initializer=keras.initializers.Identity(gain=0.5)),
        keras.layers.Dense(5, kernel_initializer="identity")])
    adapter = KerasModelAdapter(m.to_json(), device="cpu")
    rebuilt = keras.models.model_from_json(m.to_json())
    for a, b in zip(adapter.get_weights(), rebuilt.get_weights()):
        np.testing.assert_array_equal(a, b)
    assert float(adapter.get_weights()[0][0, 0]) == 1.0
