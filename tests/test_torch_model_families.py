"""The repo's example model families through the port's fit paths, against
the JAX package's: the MNIST CNN (Reshape, Conv2D, MaxPooling2D), the same
CNN with BatchNormalization, the IMDB model (Embedding, LSTM) and an
Embedding → causal Conv1D model, each at a small size.

- Each model through ``SparkModel.fit`` on the compiled path against the
  JAX ``SparkModel``: synchronous, 4 workers, ``validation_split=0.2``.
- A BatchNormalization model through ``CompiledTrainer`` in every schedule
  (synchronous at epoch and batch frequency, asynchronous and hogwild at
  both), on ragged blocks (a partial last batch of zero rows feeding the
  batch statistics, as in the reference), with and without a
  ``worker_valid`` mask: the merged moving statistics included.
- ``build_grad_step`` keeps the replica axis for a model with statistics:
  each replica normalises over its own rows and moves its own statistics.
- The host parameter-server path with BatchNormalization against the
  reference's (its workers push the statistics' deltas too).
- A checkpointed BatchNormalization fit, resumed by a new ``SparkModel``,
  against the uninterrupted fit; ``save`` → ``load_spark_model`` the same
  bits.

As in ``tests/test_torch_engine.py`` the JAX engine's epoch order is put
into the port and dropout is off. Tolerance: histories, weights and
moving statistics within atol = rtol = 1e-4 (float32 in two libraries: the
convolutions, the LSTM's 10 steps and the batch moments sum in other
orders, over up to 16 optimizer steps); the host path at the reference
host test's atol 1e-6 + rtol 1e-5, and the resumed fit at the reference
checkpoint test's rtol 1e-5 / atol 1e-6.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import jax
import keras
import numpy as np
import pytest
import torch

from elephas_tpu import SparkModel as JSparkModel
from elephas_tpu.data import SparkContext as JSparkContext
from elephas_tpu.models.adapters import KerasModelAdapter as JAdapter
from elephas_tpu.parallel.engine import CompiledTrainer as JTrainer
from elephas_tpu.utils import to_simple_rdd as j_to_simple_rdd
from elephas_tpu_torch import SparkModel
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.models import KerasModelAdapter
from elephas_tpu_torch.models.optimizers import to_torch_optimizer
from elephas_tpu_torch.parallel import CompiledTrainer, engine as port_engine
from elephas_tpu_torch.spark_model import load_spark_model
from elephas_tpu_torch.utils import to_simple_rdd

from .test_torch_host_fit import restore_global_rngs  # noqa: F401 (autouse)

TOL = 1e-4


def _jax_permutation(seed, n_workers, epoch, n_rows):
    """The JAX engine's epoch order on its 8 CPU devices (workers padded to
    a multiple of the device count, ``engine.py:261, 324, 640``)."""
    wp = -(-n_workers // jax.device_count()) * jax.device_count()
    keys = jax.random.split(jax.random.PRNGKey(seed), wp)
    return np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(keys[w], epoch),
                                                       n_rows))
                     for w in range(n_workers)])


@pytest.fixture(autouse=True)
def jax_order(monkeypatch):
    monkeypatch.setattr(port_engine, "epoch_permutation", _jax_permutation)


def _compiled(layers, input_shape, loss, seed=1):
    """``layers()`` built after seeding Keras, so that every call draws the
    same initial weights."""
    keras.utils.set_random_seed(seed)
    m = keras.Sequential(layers())
    m.build((None,) + input_shape)
    m.compile("adam", loss, metrics=["accuracy"])
    return m


def _cnn(bn=False):
    """``examples/mnist_cnn_async.py``'s layers on 12 x 12 images, a logits
    head (``bn``: a BatchNormalization after each Conv2D)."""
    def norm():
        return [keras.layers.BatchNormalization()] if bn else []

    return _compiled(
        lambda: [keras.layers.Reshape((12, 12, 1)), keras.layers.Conv2D(4, 3, activation="relu"),
         *norm(), keras.layers.MaxPooling2D(2),
         keras.layers.Conv2D(6, 3, activation="relu", padding="same"),
         *norm(),
         keras.layers.MaxPooling2D(2, padding="same"), keras.layers.Flatten(),
         keras.layers.Dense(8, activation="relu"), keras.layers.Dense(4)],
        (144,), keras.losses.CategoricalCrossentropy(from_logits=True))


def _lstm():
    """``examples/ml_pipeline_imdb_lstm.py``'s layers over 50 ids, length 10."""
    return _compiled(lambda: [keras.layers.Embedding(50, 8), keras.layers.LSTM(8),
                      keras.layers.Dense(1, activation="sigmoid")], (10,),
                     "binary_crossentropy")


def _conv1d():
    return _compiled(lambda: [keras.layers.Embedding(50, 6),
                      keras.layers.Conv1D(5, 3, padding="causal", activation="relu"),
                      keras.layers.Conv1D(4, 2, strides=2), keras.layers.Flatten(),
                      keras.layers.Dense(1, activation="sigmoid")], (10,),
                     "binary_crossentropy")


def _bn_mlp():
    """The reference's BatchNormalization family (``tests/integration/
    test_model_families.py:20``), its first Dense without a bias: a bias
    right before BatchNormalization has a gradient of exactly zero, so
    each package's rounding noise is all Adam sees of it, and Adam steps
    that noise by the learning rate in whatever direction it points."""
    return _compiled(lambda: [keras.layers.Dense(16, use_bias=False),
                              keras.layers.BatchNormalization(),
                      keras.layers.Activation("relu"),
                      keras.layers.Dense(3, activation="softmax")], (10,),
                     "categorical_crossentropy")


def _images(n=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, 144)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[(x @ rng.normal(size=(144, 4))).argmax(1)]
    return x, y


def _ids(n=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 50, size=(n, 10)).astype(np.float64)
    return x, (x[:, :5].mean(1) > x[:, 5:].mean(1)).astype(np.float32)[:, None]


def _tabular(n=120, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 2.0, size=(n, 10)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x @ rng.normal(size=(10, 3))).argmax(1)]
    return x, y


def _assert_same(got_hist, want_hist, got_w, want_w, tol=TOL):
    assert set(got_hist) == set(want_hist)
    for k in want_hist:
        np.testing.assert_allclose(got_hist[k], want_hist[k], atol=tol, rtol=tol, err_msg=k)
    assert len(got_w) == len(want_w)
    for a, b in zip(got_w, want_w):
        np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=tol)


FAMILIES = [("cnn", _cnn, _images), ("cnn_bn", lambda: _cnn(bn=True), _images),
            ("lstm", _lstm, _ids), ("conv1d", _conv1d, _ids)]


@pytest.mark.parametrize("make,data", [f[1:] for f in FAMILIES],
                         ids=[f[0] for f in FAMILIES])
def test_example_family_fit_matches_jax_spark_model(make, data):
    x, y = data()
    jsm = JSparkModel(make(), mode="synchronous", num_workers=4)
    jsm.fit(j_to_simple_rdd(JSparkContext("local[4]"), x, y), epochs=2, batch_size=8,
            validation_split=0.2)
    tsm = SparkModel(make(), mode="synchronous", num_workers=4, device="cpu")
    tsm.fit(to_simple_rdd(SparkContext("local[4]"), x, y), epochs=2, batch_size=8,
            validation_split=0.2)
    th = tsm.training_histories[-1]
    assert set(th) == {"loss", "accuracy", "val_loss", "val_accuracy"}
    _assert_same(th, jsm.training_histories[-1], tsm.master_network.get_weights(),
                 jsm.master_network.get_weights())
    np.testing.assert_allclose(tsm.predict(x[:16]), jsm.predict(x[:16]), atol=TOL, rtol=TOL)


def _ragged_blocks(n_workers, x, y):
    """Unequal blocks: partial last batches of zero rows, and after the
    shuffle some all-padding batches."""
    n = len(x)
    cuts = np.clip(np.cumsum([n // n_workers + 9 * w for w in range(n_workers)]), 0, n)[:-1]
    return list(zip(np.split(x, cuts), np.split(y, cuts)))


BN_SCHEDULES = [(mode, freq, valid)
                for mode, freq in [("synchronous", "epoch"), ("synchronous", "batch"),
                                   ("asynchronous", "epoch"), ("asynchronous", "batch"),
                                   ("hogwild", "epoch"), ("hogwild", "batch")]
                for valid in (None, [1.0, 0.0, 1.0])]


@pytest.mark.parametrize("mode,frequency,worker_valid", BN_SCHEDULES,
                         ids=[f"{m}-{f}-{'masked' if v else 'all'}" for m, f, v in BN_SCHEDULES])
def test_batchnorm_every_schedule_matches_jax(mode, frequency, worker_valid):
    x, y = _tabular()
    blocks = _ragged_blocks(3, x, y)
    merge = "mean" if mode != "synchronous" else "auto"
    jt = JTrainer(JAdapter(_bn_mlp()), mode=mode, frequency=frequency, merge=merge)
    tt = CompiledTrainer(KerasModelAdapter(_bn_mlp(), device="cpu"), mode=mode,
                         frequency=frequency, merge=merge)
    kw = dict(epochs=2, batch_size=8, validation_split=0.2, seed=3,
              worker_valid=worker_valid)
    want, got = jt.fit(blocks, **kw), tt.fit(blocks, **kw)
    _assert_same(got.history, want.history, got.weights, want.weights)
    w0 = KerasModelAdapter(_bn_mlp(), device="cpu").get_weights()
    moved = [not np.allclose(a, b) for a, b in zip(got.weights[3:5], w0[3:5])]
    assert all(moved), "the moving statistics did not move"
    ge, we = tt.evaluate(x, y, batch_size=7), jt.evaluate(x, y, batch_size=7)
    for k in we:
        np.testing.assert_allclose(ge[k], we[k], atol=TOL, rtol=TOL)


def test_batchnorm_cnn_asynchronous_batch_merges_match_jax():
    """Conv2D and BatchNormalization's statistics merged after every batch,
    summed (the asynchronous default)."""
    x, y = _images(72)
    blocks = _ragged_blocks(2, x, y)
    jt = JTrainer(JAdapter(_cnn(bn=True)), mode="asynchronous", frequency="batch")
    tt = CompiledTrainer(KerasModelAdapter(_cnn(bn=True), device="cpu"),
                         mode="asynchronous", frequency="batch")
    want = jt.fit(blocks, epochs=1, batch_size=16, validation_split=0.1)
    got = tt.fit(blocks, epochs=1, batch_size=16, validation_split=0.1)
    _assert_same(got.history, want.history, got.weights, want.weights)


def test_grad_step_keeps_each_replica_with_statistics():
    """For a model with BatchNormalization the gradient-synchronous step
    runs each replica on its own rows: replica ``l``'s statistics move by
    its own batch's moments, and the gradient is the sum of the replicas'
    own gradients. One flattened replica of ``L * B`` rows would take the
    moments over every worker's rows at once."""
    adapter = KerasModelAdapter(_bn_mlp(), device="cpu")
    rng = np.random.default_rng(9)
    L, B = 3, 6
    x = torch.from_numpy(rng.normal(size=(L, B, 10)).astype(np.float32))
    x = x + torch.arange(L, dtype=torch.float32)[:, None, None] * 2.0
    y = torch.eye(3)[torch.from_numpy(rng.integers(0, 3, size=(L, B)))]
    sw = torch.ones(L, B)
    sw[2] = 0.0                                  # an all-padding replica keeps its statistics
    tv, ntv = adapter.state_values()
    ntv_stack = {k: v[None].expand((L,) + tuple(v.shape)).clone() for k, v in ntv.items()}
    grads, ntv2, stats = adapter.build_grad_step()(tv, ntv_stack, x, y, sw, None)
    one = adapter.build_grad_step()
    want_grads = {k: torch.zeros_like(v) for k, v in tv.items()}
    for r in range(L):
        g, n, _ = one(tv, {k: v[r:r + 1] for k, v in ntv_stack.items()}, x[r:r + 1],
                      y[r:r + 1], sw[r:r + 1], None)
        want_grads = {k: want_grads[k] + g[k] for k in g}
        for k in n:
            torch.testing.assert_close(ntv2[k][r], n[k][0], rtol=0, atol=0)
    for k in grads:
        torch.testing.assert_close(grads[k], want_grads[k], rtol=1e-5, atol=1e-6)
    # the moving mean starts at 0: it moves to 0.01 x each replica's own mean
    stacked = {k: v[None].expand((L,) + tuple(v.shape)) for k, v in tv.items()}
    h = adapter.layers[0](stacked, x, True, None, None)      # the Dense before it
    name = next(k for k in ntv if k.endswith("moving_mean"))
    torch.testing.assert_close(ntv2[name][:2], 0.01 * h[:2].mean(1), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(ntv2[name][2], ntv_stack[name][2], rtol=0, atol=0)
    assert float(stats[2][2]) == 0.0


def test_replica_step_moves_statistics_and_keeps_an_all_padding_replica():
    adapter = KerasModelAdapter(_bn_mlp(), device="cpu")
    opt = to_torch_optimizer("sgd")
    tv, ntv = ({k: v[None].expand((2,) + tuple(v.shape)).clone() for k, v in d.items()}
               for d in adapter.state_values())
    x = torch.randn(2, 4, 10, generator=torch.Generator().manual_seed(0))
    y = torch.eye(3)[[0, 1, 2, 0]].expand(2, 4, 3)
    sw = torch.tensor([[1.0] * 4, [0.0] * 4])
    tv2, ntv2, _, _ = adapter.build_train_step(opt)(
        tv, ntv, opt.init(tv, count_shape=(2,)), x, y, sw, None)
    for k in ntv:
        assert not torch.equal(ntv2[k][0], ntv[k][0])
        assert torch.equal(ntv2[k][1], ntv[k][1])


HOST = [(dict(mode="asynchronous", frequency="epoch"), 1),
        (dict(mode="asynchronous", frequency="batch"), 1),
        (dict(mode="synchronous", comm="host"), 4)]


@pytest.mark.parametrize("kw,workers", HOST, ids=["async-epoch", "async-batch", "sync"])
def test_host_path_with_batchnorm_matches_reference(kw, workers):
    """Keras's ``model.fit`` moves the statistics over each batch's rows (the
    last batch short) and the workers' deltas carry them; seeded
    ``np.random`` orders, ``shuffle=False`` (the asynchronous epoch workers
    shuffle all the same, as the reference's)."""
    x, y = _tabular(150)
    jm = _bn_mlp()
    w0 = [np.array(w) for w in jm.get_weights()]
    fit = dict(epochs=3, batch_size=32, validation_split=0.1, shuffle=False)
    np.random.seed(7)
    jsm = JSparkModel(jm, num_workers=workers, port=0, **kw)
    jsm.fit(j_to_simple_rdd(JSparkContext(f"local[{workers}]"), x, y), **fit)
    tm = _bn_mlp()
    tm.set_weights(w0)
    np.random.seed(7)
    tsm = SparkModel(tm, num_workers=workers, port=0, device="cpu", **kw)
    tsm.fit(to_simple_rdd(SparkContext(f"local[{workers}]"), x, y), **fit)
    got, want = tsm.master_network.get_weights(), jsm.master_network.get_weights()
    assert len(got) == len(want) == 7
    assert not np.allclose(got[3], w0[3]), "the merged moving mean did not move"
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-5)


def test_checkpointed_batchnorm_fit_resumes_to_the_uninterrupted_fit(tmp_path):
    """Synchronous, epoch frequency: the replica stacks of the parameters and
    of the statistics are saved at each checkpoint and continued on
    resume, so the chunked fit merges once, as the uninterrupted one."""
    x, y = _images(96)
    init = [np.array(w) for w in _cnn(bn=True).get_weights()]

    def fit(sm, epochs, **kw):
        sm.fit(to_simple_rdd(SparkContext("local[4]"), x, y), epochs=epochs,
               batch_size=8, validation_split=0.1, **kw)

    def model():
        sm = SparkModel(_cnn(bn=True), mode="synchronous", num_workers=4, device="cpu")
        sm.master_network.set_weights(init)
        return sm

    plain = model()
    fit(plain, 4)
    ckpt = str(tmp_path / "ckpt")
    first = model()
    fit(first, 2, checkpoint_dir=ckpt, checkpoint_frequency=2)
    second = model()
    second.master_network.set_weights([w * 0 for w in init])
    fit(second, 4, checkpoint_dir=ckpt, checkpoint_frequency=2, resume=True)
    for a, b in zip(second.master_network.get_weights(), plain.master_network.get_weights()):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(first.training_histories[-1]["loss"]
                               + second.training_histories[-1]["loss"],
                               plain.training_histories[-1]["loss"], rtol=1e-5, atol=1e-6)
    path = str(tmp_path / "model.npz")
    second.save(path)
    loaded = load_spark_model(path, device="cpu")
    for a, b in zip(loaded.master_network.get_weights(), second.master_network.get_weights()):
        assert np.array_equal(a, b)
    assert np.array_equal(loaded.predict(x), second.predict(x))
