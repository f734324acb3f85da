"""The recurrent layers and masks of the port's adapter
(``elephas_tpu_torch/models/adapters.py``) against Keras's own: GRU with
and without ``reset_after``, SimpleRNN, ``go_backwards`` on LSTM, GRU and
SimpleRNN, and an ``Embedding(mask_zero=True)`` mask consumed by each
(through Dropout, stacked, ``zero_output_for_mask``), forward against
``model.predict`` and each returned sequence against Keras's own
intermediate output; the masks the port refuses (reaching a layer that
does not consume them, or the loss); a masked GRU's 2-worker synchronous
fit against ``elephas_tpu.SparkModel``'s; the committed
``configs/imdb_gru_masked.json`` against its builder.

Ids and inputs come from numpy with a seed, zeros (masked steps) at the
end, the start and inside the sequences; the weights are Keras's, drawn
anew and read by the port through ``get_weights()``. Tolerance: atol =
rtol = 1e-5, float32 on both sides.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import json
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

from .test_torch_functional import _randomise, assert_same_fit, jax_permutation

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "elephas_tpu_torch" / "configs"
TOL = 1e-5
L = keras.layers


def _seq(layers, input_shape, x):
    keras.utils.set_random_seed(0)
    m = keras.Sequential([keras.Input(input_shape)] + layers)
    _randomise(m)
    want = m.predict(x, verbose=0)
    adapter = KerasModelAdapter(m, device="cpu")
    got = adapter.predict(x, batch_size=len(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    return m, adapter


def _steps(n=5, t=8, d=3, seed=6):
    return np.random.default_rng(seed).normal(size=(n, t, d)).astype("float32")


def ids(n=6, t=9, vocab=12, seed=3):
    """Ids in [1, vocab) with zeros: a right-padded row, a left-padded one,
    one with a hole, an all-zero row and rows without zeros."""
    x = np.random.default_rng(seed).integers(1, vocab, size=(n, t))
    x[0, 5:] = 0
    x[1, :3] = 0
    x[2, 4] = 0
    x[3] = 0
    return x.astype("float64")


GRU = [dict(), dict(reset_after=False), dict(use_bias=False),
       dict(reset_after=False, use_bias=False),
       dict(activation="relu", recurrent_activation="hard_sigmoid")]


@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("kw", GRU, ids=str)
def test_gru_matches_keras(return_sequences, kw):
    """Gates z, r, h; ``reset_after`` (the default: bias ``[2, 3u]``, the
    reset gate on the recurrent projection) and without it (``[3u]``, the
    reset gate on the state before the projection)."""
    _, adapter = _seq([L.GRU(4, return_sequences=return_sequences, **kw)], (8, 3), _steps())
    if kw.get("use_bias", True):
        want = (2, 12) if kw.get("reset_after", True) else (12,)
        assert adapter.get_weights()[-1].shape == want


@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("kw", [dict(), dict(use_bias=False), dict(activation="relu")],
                         ids=str)
def test_simple_rnn_matches_keras(return_sequences, kw):
    _seq([L.SimpleRNN(4, return_sequences=return_sequences, **kw)], (8, 3), _steps())


@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
def test_go_backwards_matches_keras(cls, return_sequences):
    """The sequence read from its end; the returned sequence in the order
    the steps ran (Keras does not flip it back)."""
    _seq([getattr(L, cls)(4, go_backwards=True, return_sequences=return_sequences)], (8, 3),
         _steps())


MASKED = [(cls, back) for cls in ("LSTM", "GRU", "SimpleRNN") for back in (False, True)]


@pytest.mark.parametrize("cls,go_backwards", MASKED,
                         ids=[f"{c}-{'back' if b else 'fwd'}" for c, b in MASKED])
def test_masked_recurrent_matches_keras(cls, go_backwards):
    """``Embedding(mask_zero=True)``, Dropout (which hands the mask on), a
    masked layer returning its sequence, a second masked layer, a Dense:
    a masked step keeps the state and repeats the previous output. The
    first layer's sequence is held to Keras's own output of that layer."""
    layer = getattr(L, cls)
    x = ids()
    m, adapter = _seq([L.Embedding(12, 5, mask_zero=True), L.Dropout(0.3),
                       layer(4, return_sequences=True, go_backwards=go_backwards),
                       layer(3, go_backwards=go_backwards), L.Dense(2)], (9,), x)
    want = keras.Model(m.inputs, m.layers[2].output).predict(x, verbose=0)
    tv, ntv = adapter.state_values()
    p = {k: v[None] for k, v in {**tv, **ntv}.items()}
    h = torch.from_numpy(x.astype(np.float32))[None]
    emb, _, rnn = adapter.layers[:3]
    with torch.no_grad():
        got = rnn(p, emb(p, h, False, None, None), False, None, None,
                  mask=emb.compute_mask(h))
    np.testing.assert_allclose(got[0].numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cls", ["GRU", "SimpleRNN"])
def test_zero_output_for_mask_matches_keras(cls):
    """``zero_output_for_mask=True``: a masked step outputs zeros, the state
    still carried."""
    x = ids(seed=4)
    m, adapter = _seq([L.Embedding(12, 5, mask_zero=True),
                       getattr(L, cls)(4, return_sequences=True, zero_output_for_mask=True),
                       L.GRU(3)], (9,), x)
    want = keras.Model(m.inputs, m.layers[1].output).predict(x, verbose=0)
    assert (want[0, 5:] == 0).all()
    tv, _ = adapter.state_values()
    p = {k: v[None] for k, v in tv.items()}
    h = torch.from_numpy(x.astype(np.float32))[None]
    emb, rnn = adapter.layers[:2]
    with torch.no_grad():
        got = rnn(p, emb(p, h, False, None, None), False, None, None,
                  mask=emb.compute_mask(h))
    np.testing.assert_allclose(got[0].numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("layers,match", [
    (lambda: [L.Embedding(12, 4, mask_zero=True), L.GRU(3, return_sequences=True)],
     "the loss"),
    (lambda: [L.Embedding(12, 4, mask_zero=True), L.GRU(3, return_sequences=True),
              L.Dense(2)], "Dense"),
    (lambda: [L.Embedding(12, 4, mask_zero=True), L.GlobalAveragePooling1D()],
     "GlobalAveragePooling1D"),
    (lambda: [L.GRU(3, stateful=True)], "stateful"),
])
def test_masks_and_options_still_queued_raise(layers, match):
    """Each case this test once found refused runs as Keras 3.13 runs it,
    within 1e-5 of ``model.predict``: a mask reaching the model's output
    (``tests/test_torch_graph_options.py`` holds what the loss does with
    it), a mask handed on by Dense, GlobalAveragePooling1D's masked mean
    (NaN on the all-masked row, as Keras's 0 / 0), and ``stateful=True``,
    which starts every batch from zeros as the reference's
    ``stateless_call`` does and refuses a batch of another size as Keras
    does."""
    stateful = match == "stateful"
    shape = (9, 3) if stateful else (9,)
    keras.utils.set_random_seed(0)
    m = keras.Sequential([keras.Input(shape, batch_size=4)] + layers())
    _randomise(m)
    x = _steps(4, 9, 3) if stateful else ids(4)
    want = m.predict(x, batch_size=4, verbose=0)
    adapter = KerasModelAdapter(m, device="cpu")
    got = adapter.predict(x, batch_size=4)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    if stateful:
        np.testing.assert_allclose(adapter.predict(x, batch_size=4), got, atol=0, rtol=0)
        with pytest.raises(ValueError, match="stateful"):
            adapter.predict(x[:3], batch_size=3)


def imdb_gru_masked(vocab=2000, maxlen=80, units=32):
    """``examples/ml_pipeline_imdb_lstm.py``'s model with a GRU in place of
    its LSTM and a mask on the ids' zeros."""
    keras.utils.set_random_seed(0)
    m = keras.Sequential([L.Embedding(vocab, units, mask_zero=True), L.GRU(units),
                          L.Dense(1, activation="sigmoid")])
    m.build((None, maxlen))
    m.compile(optimizer="adam", loss="binary_crossentropy", metrics=["accuracy"])
    return m


def padded_ids(n, vocab, maxlen, seed=0):
    """Sequences of random lengths in [maxlen / 4, maxlen], right-padded with
    zeros, labelled by whether their mean id is under ``vocab / 2``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, vocab, size=(n, maxlen))
    lengths = rng.integers(maxlen // 4, maxlen + 1, size=n)
    x[np.arange(maxlen)[None, :] >= lengths[:, None]] = 0
    y = np.array([x[i, :lengths[i]].mean() < vocab / 2 for i in range(n)], np.float32)
    return x.astype(np.float64), y[:, None]


def test_masked_gru_fit_matches_jax_spark_model(monkeypatch):
    """2 workers, synchronous, epoch frequency, 2 epochs, validation 0.25:
    the port's ``SparkModel`` against ``elephas_tpu.SparkModel`` with the
    JAX engine's order put in."""
    monkeypatch.setattr(port_engine, "epoch_permutation", jax_permutation)
    x, y = padded_ids(64, 30, 12)
    kw = dict(mode="synchronous", parameter_server_mode="jax", num_workers=2)
    fit = dict(epochs=2, batch_size=8, validation_split=0.25)
    jsm = JSparkModel(imdb_gru_masked(30, 12, 8), **kw)
    jsm.fit(j_to_simple_rdd(JSparkContext("local[2]"), x, y), **fit)
    tsm = SparkModel(imdb_gru_masked(30, 12, 8), device="cpu", **kw)
    tsm.fit(to_simple_rdd(SparkContext("local[2]"), x, y), **fit)
    assert_same_fit(tsm, jsm)


def test_committed_imdb_gru_masked_matches_keras():
    """The committed JSON is :func:`imdb_gru_masked`'s model (layers,
    options, loss); read with Keras's weights its forward is Keras's on
    padded ids."""
    m = imdb_gru_masked()
    committed = json.loads((CONFIGS / "imdb_gru_masked.json").read_text())
    strip = lambda arch: [(layer["class_name"], {  # noqa: E731
        k: v for k, v in layer["config"].items() if k not in ("name", "dtype")
        and "initializer" not in k}) for layer in arch["config"]["layers"]]
    arch = json.loads(m.to_json())
    assert strip(committed) == strip(arch)
    assert committed["compile_config"]["loss"] == arch["compile_config"]["loss"]
    _randomise(m)
    x, _ = padded_ids(8, 2000, 80, seed=2)
    adapter = KerasModelAdapter((CONFIGS / "imdb_gru_masked.json").read_text(),
                                weights=m.get_weights(), device="cpu")
    np.testing.assert_allclose(adapter.predict(x, batch_size=8), m.predict(x, verbose=0),
                               atol=TOL, rtol=TOL)


# -- dropout and recurrent_dropout ------------------------------------------------

DROPOUT = [("LSTM", dict(dropout=0.3)), ("LSTM", dict(dropout=0.3, recurrent_dropout=0.2)),
           ("LSTM", dict(recurrent_dropout=0.4)),
           ("GRU", dict(dropout=0.3)), ("GRU", dict(dropout=0.3, recurrent_dropout=0.2)),
           ("GRU", dict(dropout=0.2, recurrent_dropout=0.3, reset_after=False)),
           ("SimpleRNN", dict(dropout=0.3, recurrent_dropout=0.2))]
DROPOUT_IDS = [f"{c}-{kw}" for c, kw in DROPOUT]


@pytest.mark.parametrize("cls,kw", DROPOUT, ids=DROPOUT_IDS)
def test_dropout_off_in_inference_matches_keras(cls, kw):
    """``dropout`` and ``recurrent_dropout`` act in training only: the
    forward equals Keras's ``predict`` (Keras's implementation 1, a matmul
    a gate, when ``recurrent_dropout`` is set)."""
    _seq([getattr(L, cls)(4, return_sequences=True, **kw), L.Flatten(), L.Dense(2)],
         (8, 3), _steps())


def _op(cls, kw, units=4):
    m = keras.Sequential([keras.Input((8, 3)), getattr(L, cls)(units, **kw)])
    return m, KerasModelAdapter(m, device="cpu")


@pytest.mark.parametrize("cls,kw", DROPOUT, ids=DROPOUT_IDS)
def test_dropout_masks_fixed_over_time_and_keep_rate(cls, kw):
    """One training call draws its masks once (none carry a time axis): a
    mask a gate with ``recurrent_dropout`` on LSTM and GRU, else one; values
    0 and ``1 / (1 - rate)``; over 20,000 entries the kept share within 3
    sigma of ``1 - rate``. A second call draws new masks."""
    _, adapter = _seq([getattr(L, cls)(4, **kw)], (8, 3), _steps())
    op = adapter.layers[0]
    drawn = []
    real = op.draw_masks

    def spy(*a):
        drawn.append(real(*a))
        return drawn[-1]

    op.draw_masks = spy
    tv, ntv = ({k: v[None] for k, v in d.items()} for d in adapter.state_values())
    x = torch.from_numpy(_steps())[None]
    gen = torch.Generator().manual_seed(0)
    adapter.stateless_call(tv, ntv, x, True, gen)
    adapter.stateless_call(tv, ntv, x, True, gen)
    assert len(drawn) == 2
    per_gate = cls != "SimpleRNN" and kw.get("recurrent_dropout", 0) > 0
    n_masks = {"LSTM": 4, "GRU": 3}.get(cls, 1) if per_gate else 1
    for (ins, recs), (ins2, _) in zip(drawn[:1], drawn[1:]):
        for masks, rate, width in ((ins, kw.get("dropout", 0), 3),
                                   (recs, kw.get("recurrent_dropout", 0), 4)):
            if not rate:
                assert masks is None
                continue
            assert len(masks) == n_masks
            for m_ in masks:
                assert tuple(m_.shape) == (1, 5, width)
                vals = set(np.unique(m_.numpy()).tolist())
                assert vals <= {0.0, np.float32(1 / (1 - rate))}
        if ins is not None:
            assert not torch.equal(ins[0], ins2[0])
    rate = kw.get("dropout") or kw.get("recurrent_dropout")
    big = op.draw_masks(1, 2000, torch.zeros(1, dtype=torch.float32), gen)
    m_ = (big[0] if kw.get("dropout") else big[1])[0]
    kept = float((m_ > 0).float().mean())
    sigma = np.sqrt(rate * (1 - rate) / m_.numel())
    assert abs(kept - (1 - rate)) < 3 * sigma


@pytest.mark.parametrize("cls,kw", DROPOUT, ids=DROPOUT_IDS)
def test_dropout_training_step_matches_keras_cell(cls, kw):
    """With the masks fixed, a training call equals Keras's own cell given
    the same masks (each cell caches its masks for a call: they are put in
    its cache before the call), every step of the returned sequence."""
    import jax.numpy as jnp

    keras.utils.set_random_seed(0)
    layer = getattr(L, cls)(4, return_sequences=True, **kw)
    m = keras.Sequential([keras.Input((8, 3)), layer])
    _randomise(m)
    adapter = KerasModelAdapter(m, device="cpu")
    op = adapter.layers[0]
    rng = np.random.default_rng(9)
    per_gate = cls != "SimpleRNN" and kw.get("recurrent_dropout", 0) > 0
    n = {"LSTM": 4, "GRU": 3}.get(cls, 1) if per_gate else 1

    def masks(rate, width):
        if not rate:
            return None
        keep = 1 - rate
        return [(rng.random((5, width)) < keep).astype(np.float32) / np.float32(keep)
                for _ in range(n)]

    ins, recs = masks(kw.get("dropout", 0), 3), masks(kw.get("recurrent_dropout", 0), 4)
    op.draw_masks = lambda *a: tuple(None if ms is None else
                                     [torch.from_numpy(v)[None] for v in ms]
                                     for ms in (ins, recs))
    tv, ntv = ({k: v[None] for k, v in d.items()} for d in adapter.state_values())
    x = _steps()
    got = adapter.stateless_call(tv, ntv, torch.from_numpy(x)[None], True, None)[0][0]

    def keras_masks(ms):
        if ms is None:
            return None
        return [jnp.asarray(v) for v in ms] if per_gate else jnp.asarray(ms[0])

    layer.cell._dropout_mask = keras_masks(ins)
    layer.cell._recurrent_dropout_mask = keras_masks(recs)
    want = np.asarray(layer(x, training=True))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
