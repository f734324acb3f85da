"""The port's compiled-path engine (``elephas_tpu_torch/parallel/engine.py``)
against the JAX package's on the same data and weights, with the JAX
engine's epoch order put in (its ``jax.random`` order depends on the device
count) and dropout off: the five schedules (synchronous at epoch and batch
frequency, asynchronous at both, hogwild at epoch) x both heads (logits,
where the loss runs K1's plain versions, and softmax, where it runs no
kernel) through ``SparkModel.fit`` with 3 or 4 workers and
``validation_split=0.2``; then ``CompiledTrainer`` options (merge
overrides, ``worker_valid``, optimizer-state carrying, other losses).

Tolerance: histories and final weights within atol = rtol = 1e-5: float32
on both sides, the same update rules; the sums over replicas, rows and
devices run in other orders, which moves results by a few ulps per step
(the largest difference seen over these fits is 2.4e-7).
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import jax
import keras
import numpy as np
import pytest

from elephas_tpu import SparkModel as JSparkModel
from elephas_tpu.data import SparkContext as JSparkContext
from elephas_tpu.models.adapters import KerasModelAdapter as JAdapter
from elephas_tpu.parallel.engine import CompiledTrainer as JTrainer
from elephas_tpu.utils import to_simple_rdd as j_to_simple_rdd
from elephas_tpu_torch import SparkModel
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.models import KerasModelAdapter
from elephas_tpu_torch.parallel import CompiledTrainer, engine as port_engine
from elephas_tpu_torch.utils import to_simple_rdd

TOL = 1e-5


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


def _toy(logits=True, loss=None, optimizer="adam"):
    keras.utils.set_random_seed(1)
    m = keras.Sequential([keras.layers.Dense(16, activation="relu"),
                          keras.layers.Dropout(0.0),
                          keras.layers.Dense(4, activation=None if logits else "softmax")])
    m.build((None, 8))
    m.compile(optimizer, loss or keras.losses.CategoricalCrossentropy(from_logits=logits),
              metrics=["accuracy"])
    return m


def _data(n=150, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[(x @ rng.normal(size=(8, 4))).argmax(1)]
    return x, y


def _assert_same(got_hist, want_hist, got_w, want_w):
    assert set(got_hist) == set(want_hist)
    for k in want_hist:
        np.testing.assert_allclose(got_hist[k], want_hist[k], atol=TOL, rtol=TOL, err_msg=k)
    for a, b in zip(got_w, want_w):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


SCHEDULES = [("synchronous", "epoch"), ("synchronous", "batch"),
             ("asynchronous", "epoch"), ("asynchronous", "batch"),
             ("hogwild", "epoch")]
MATRIX = [(mode, freq, logits, 3 + (i + logits) % 2)
          for i, (mode, freq) in enumerate(SCHEDULES) for logits in (True, False)]


@pytest.mark.parametrize("mode,frequency,logits,n_workers", MATRIX,
                         ids=[f"{m}-{f}-{'logits' if lg else 'softmax'}-w{w}"
                              for m, f, lg, w in MATRIX])
def test_schedule_matches_jax_spark_model(mode, frequency, logits, n_workers):
    x, y = _data()
    jsm = JSparkModel(_toy(logits), mode=mode, frequency=frequency,
                      parameter_server_mode="jax", num_workers=n_workers)
    jsm.fit(j_to_simple_rdd(JSparkContext("local[4]"), x, y), epochs=2, batch_size=8,
            validation_split=0.2)
    tsm = SparkModel(_toy(logits), mode=mode, frequency=frequency,
                     parameter_server_mode="jax", num_workers=n_workers, device="cpu")
    tsm.fit(to_simple_rdd(SparkContext("local[4]"), x, y), epochs=2, batch_size=8,
            validation_split=0.2)
    jh, th = jsm.training_histories[-1], tsm.training_histories[-1]
    assert set(th) == {"loss", "accuracy", "val_loss", "val_accuracy"}
    assert th["loss"][-1] < th["loss"][0]
    _assert_same(th, jh, tsm.master_network.get_weights(), jsm.master_network.get_weights())


def _blocks(n_workers, n=150, seed=0, ragged=True):
    """Per-worker blocks of unequal size (one worker's last batch all
    padding after the shuffle is then common)."""
    x, y = _data(n, seed)
    cuts = np.cumsum([n // n_workers + (7 * w if ragged else 0) for w in range(n_workers)])
    cuts = np.clip(cuts, 0, n)[:-1]
    return list(zip(np.split(x, cuts), np.split(y, cuts)))


def _trainers(mode, frequency, merge="auto", **model_kw):
    jt = JTrainer(JAdapter(_toy(**model_kw)), mode=mode, frequency=frequency, merge=merge)
    tt = CompiledTrainer(KerasModelAdapter(_toy(**model_kw), device="cpu"), mode=mode,
                         frequency=frequency, merge=merge)
    return jt, tt


@pytest.mark.parametrize("mode,frequency,merge", [
    ("synchronous", "epoch", "sum"), ("asynchronous", "epoch", "mean"),
    ("hogwild", "batch", "mean")])
def test_merge_overrides_and_ragged_blocks(mode, frequency, merge):
    blocks = _blocks(3)
    jt, tt = _trainers(mode, frequency, merge)
    want = jt.fit(blocks, epochs=2, batch_size=8, validation_split=0.2, seed=3)
    got = tt.fit(blocks, epochs=2, batch_size=8, validation_split=0.2, seed=3)
    _assert_same(got.history, want.history, got.weights, want.weights)


@pytest.mark.parametrize("mode,frequency", [("synchronous", "epoch"),
                                            ("asynchronous", "batch")])
def test_worker_valid_excludes_workers_from_the_merge(mode, frequency):
    blocks = _blocks(4, ragged=False)
    jt, tt = _trainers(mode, frequency)
    kw = dict(epochs=2, batch_size=8, worker_valid=[1.0, 0.0, 1.0, 1.0])
    want = jt.fit(blocks, **kw)
    got = tt.fit(blocks, **kw)
    _assert_same(got.history, want.history, got.weights, want.weights)
    with pytest.raises(ValueError, match="every worker"):
        tt.fit(blocks, epochs=1, batch_size=8, worker_valid=[0.0] * 4)
    with pytest.raises(ValueError, match="entries"):
        tt.fit(blocks, epochs=1, batch_size=8, worker_valid=[1.0])


@pytest.mark.parametrize("mode,frequency", [("synchronous", "epoch"),
                                            ("synchronous", "batch")])
def test_optimizer_state_carries_across_fits(mode, frequency):
    blocks = _blocks(2, ragged=False)
    jt, tt = _trainers(mode, frequency)
    jr = jt.fit(blocks, epochs=1, batch_size=8, keep_opt_state=True)
    tr = tt.fit(blocks, epochs=1, batch_size=8, keep_opt_state=True)
    assert tr.opt_state is not None
    want = jt.fit(blocks, epochs=1, batch_size=8, seed=1, opt_state=jr.opt_state)
    got = tt.fit(blocks, epochs=1, batch_size=8, seed=1, opt_state=tr.opt_state)
    _assert_same(got.history, want.history, got.weights, want.weights)
    assert got.opt_state is None                 # not kept unless asked


@pytest.mark.parametrize("loss,logits,opt", [
    ("sparse_categorical_crossentropy", False, "sgd"),
    ("mse", True, "rmsprop"),
    (keras.losses.BinaryCrossentropy(from_logits=True), True, "adagrad")])
def test_other_losses_and_optimizers_through_the_engine(loss, logits, opt):
    blocks = _blocks(3)
    if loss == "sparse_categorical_crossentropy":
        blocks = [(bx, by.argmax(1).astype(np.float32)) for bx, by in blocks]
    jt, tt = _trainers("asynchronous", "epoch", loss=loss, logits=logits, optimizer=opt)
    want = jt.fit(blocks, epochs=2, batch_size=8, validation_split=0.1)
    got = tt.fit(blocks, epochs=2, batch_size=8, validation_split=0.1)
    _assert_same(got.history, want.history, got.weights, want.weights)
    x, y = blocks[0]
    np.testing.assert_allclose(tt.predict(x, batch_size=5), jt.predict(x, batch_size=5),
                               atol=TOL, rtol=TOL)
    ge, we = tt.evaluate(x, y, batch_size=7), jt.evaluate(x, y, batch_size=7)
    assert set(ge) == set(we)
    for k in we:
        np.testing.assert_allclose(ge[k], we[k], atol=TOL, rtol=TOL)


def test_bad_schedules_raise():
    adapter = KerasModelAdapter(_toy(), device="cpu")
    with pytest.raises(ValueError, match="mode"):
        CompiledTrainer(adapter, mode="bulk")
    with pytest.raises(ValueError, match="frequency"):
        CompiledTrainer(adapter, frequency="step")
    with pytest.raises(ValueError, match="merge='sum'"):
        CompiledTrainer(adapter, mode="synchronous", frequency="batch", merge="sum")
    with pytest.raises(ValueError, match="No worker data"):
        CompiledTrainer(adapter).fit([], epochs=1, batch_size=8)
    assert CompiledTrainer(adapter, remat=True).remat is True
    inp = keras.Input((8,))
    two_out = keras.Model(inp, [keras.layers.Dense(4)(inp), keras.layers.Dense(4)(inp)])
    with pytest.raises(NotImplementedError, match="reference's entry points do not take"):
        CompiledTrainer(KerasModelAdapter(two_out, device="cpu"))
