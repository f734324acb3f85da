"""``remat=True`` in the port (``KerasModelAdapter.build_train_step`` /
``build_grad_step``, ``CompiledTrainer``, ``SparkModel``): the reference
wraps its step's ``_loss`` (the model's ``stateless_call`` and the
per-sample loss) in ``jax.checkpoint``; the port runs the same region
under ``torch.utils.checkpoint``.

- The flag reaches the step: a layer runs twice a train (and grad) step
  with ``remat=True``, once without (the reference's
  ``test_remat_flag_reaches_the_compiled_program`` reads the same from its
  jaxpr).
- Recomputing changes nothing: with Dropout (drawn from the step's
  explicit generator, which ``preserve_rng_state`` does not save) and
  BatchNormalization (whose moved statistics leave the region), the
  ``remat=True`` steps give the ``False`` steps' parameters, gradients,
  statistics, optimizer state and metrics within 1e-6, and leave the
  generator where they leave it.
- Fits with ``remat=True`` through ``CompiledTrainer`` and ``SparkModel``
  match the reference's ``remat=True`` fits at the engine tests' pins
  (atol = rtol = 1e-5; the JAX engine's order put in, dropout off).
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
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
from elephas_tpu_torch.parallel import CompiledTrainer, engine as port_engine
from elephas_tpu_torch.utils import to_simple_rdd

from .test_torch_functional import assert_same_fit, jax_permutation

TOL = 1e-5
L = keras.layers


def _model(rate=0.3, optimizer="adam"):
    """Dense (no bias: BatchNormalization cancels its gradient, and Adam
    would step by the rounding of a zero), BatchNormalization, ReLU,
    Dropout(``rate``), a logits Dense: categorical cross-entropy from logits
    (K1's plain versions on the CPU)."""
    keras.utils.set_random_seed(4)
    m = keras.Sequential([keras.Input((6,)), L.Dense(12, use_bias=False, name="hidden"),
                          L.BatchNormalization(name="bn"), L.Activation("relu"),
                          L.Dropout(rate), L.Dense(4, name="logits")])
    m.compile(optimizer, keras.losses.CategoricalCrossentropy(from_logits=True),
              metrics=["accuracy"])
    return m


def _data(n=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[(x @ rng.normal(size=(6, 4))).argmax(1)]
    return x, y


def _batch(R=3, B=8):
    """``R`` replicas of ``B`` rows, the last replica's last 3 rows padding."""
    x, y = _data(R * B)
    sw = torch.ones(R, B)
    sw[-1, -3:] = 0.0
    return (torch.from_numpy(x.reshape(R, B, 6)), torch.from_numpy(y.reshape(R, B, 4)), sw)


def _stacked(adapter, R):
    tv, ntv = adapter.state_values()
    return ({k: v[None].expand((R,) + tuple(v.shape)).clone() for k, v in tv.items()},
            {k: v[None].expand((R,) + tuple(v.shape)).clone() for k, v in ntv.items()})


def _count_calls(adapter, index):
    """Count the calls of the adapter's ``index``-th op."""
    op, calls = adapter.layers[index], []
    base = type(op)

    class Counted(base):
        def __call__(self, *args, **kw):
            calls.append(1)
            return base.__call__(self, *args, **kw)

    op.__class__ = Counted
    return calls


@pytest.mark.parametrize("step", ["train", "grad"])
def test_remat_flag_reaches_the_step(step):
    """A layer's forward runs twice a step with ``remat=True`` (the forward
    and the backward's recompute), once without; the evaluation step never
    recomputes."""
    x, y, sw = _batch()
    for remat, want in ((False, 1), (True, 2)):
        adapter = KerasModelAdapter(_model(), device="cpu")
        calls = _count_calls(adapter, 0)
        tv, ntv = _stacked(adapter, 3)
        gen = torch.Generator().manual_seed(0)
        if step == "train":
            opt = adapter.make_optimizer()
            adapter.build_train_step(opt, remat)(tv, ntv, opt.init(tv, count_shape=(3,)),
                                                 x, y, sw, gen)
        else:
            adapter.build_grad_step(remat)(adapter.state_values()[0], ntv, x, y, sw, gen)
        assert len(calls) == want, (remat, len(calls))
    adapter.build_eval_step()(tv, ntv, x, y, sw)
    assert len(calls) == 3


def _close(a, b, what):
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=f"{what} {k}")


def test_remat_steps_match_plain_steps_with_dropout_and_batch_norm():
    """Two train steps and a grad step from one generator seed: the same
    parameters, optimizer state, moved statistics, metrics and gradients
    (1e-6), and the same generator state after each step; the dropout
    masks are drawn (a step without dropout gives other gradients)."""
    x, y, sw = _batch()
    out = {}
    for remat in (False, True):
        adapter = KerasModelAdapter(_model(), device="cpu")
        opt = adapter.make_optimizer()
        tv, ntv = _stacked(adapter, 3)
        state = opt.init(tv, count_shape=(3,))
        gen = torch.Generator().manual_seed(11)
        step = adapter.build_train_step(opt, remat)
        gen_states = []
        for _ in range(2):
            tv, ntv, state, stats = step(tv, ntv, state, x, y, sw, gen)
            gen_states.append(gen.get_state())
        grads, gntv, gstats = adapter.build_grad_step(remat)(
            adapter.state_values()[0], ntv, x, y, sw, gen)
        gen_states.append(gen.get_state())
        out[remat] = (tv, ntv, state, stats, grads, gntv, gstats, gen_states)
    plain, remat = out[False], out[True]
    _close(remat[0], plain[0], "tv")
    _close(remat[1], plain[1], "ntv")
    _close(remat[2].mu, plain[2].mu, "adam mu")
    _close(remat[2].nu, plain[2].nu, "adam nu")
    assert torch.equal(remat[2].count, plain[2].count)
    _close(dict(enumerate(remat[3])), dict(enumerate(plain[3])), "stats")
    _close(remat[4], plain[4], "grads")
    _close(remat[5], plain[5], "grad step ntv")
    _close(dict(enumerate(remat[6])), dict(enumerate(plain[6])), "grad step stats")
    for a, b in zip(remat[7], plain[7]):
        assert torch.equal(a, b)
    # the masks are drawn: without dropout the gradients differ
    adapter = KerasModelAdapter(_model(rate=0.0), device="cpu")
    nodrop = adapter.build_grad_step(True)(adapter.state_values()[0], plain[1], x, y, sw,
                                           torch.Generator().manual_seed(11))[0]
    assert any(not torch.allclose(nodrop[k], plain[4][k]) for k in nodrop)


def test_remat_leaves_the_default_generator_when_none_is_given():
    """Without an explicit generator the dropout draws from the default one,
    which the checkpoint saves and restores for the recompute
    (``preserve_rng_state``): the same gradients as without remat."""
    x, y, sw = _batch()
    got = {}
    for remat in (False, True):
        adapter = KerasModelAdapter(_model(), device="cpu")
        tv, ntv = _stacked(adapter, 3)
        with torch.random.fork_rng():
            torch.manual_seed(5)
            got[remat] = adapter.build_grad_step(remat)(adapter.state_values()[0], ntv, x, y,
                                                        sw, None)[0]
            got[remat]["after"] = torch.rand(1)
    _close(got[True], got[False], "grads")


@pytest.mark.parametrize("mode,frequency", [("synchronous", "epoch"),
                                            ("synchronous", "batch")])
def test_compiled_trainer_remat_fit_matches_reference(mode, frequency, monkeypatch):
    """``CompiledTrainer(remat=True)`` against the reference's, 3 workers
    of unequal blocks, 2 epochs, validation 0.2."""
    monkeypatch.setattr(port_engine, "epoch_permutation", jax_permutation)
    x, y = _data(150)
    blocks = [(x[:40], y[:40]), (x[40:95], y[40:95]), (x[95:], y[95:])]
    jt = JTrainer(JAdapter(_model(rate=0.0)), mode=mode, frequency=frequency, remat=True)
    tt = CompiledTrainer(KerasModelAdapter(_model(rate=0.0), device="cpu"), mode=mode,
                         frequency=frequency, remat=True)
    kw = dict(epochs=2, batch_size=8, validation_split=0.2, seed=3)
    want, got = jt.fit(blocks, **kw), tt.fit(blocks, **kw)
    assert set(got.history) == set(want.history)
    for k in want.history:
        np.testing.assert_allclose(got.history[k], want.history[k], atol=TOL, rtol=TOL,
                                   err_msg=k)
    for a, b in zip(got.weights, want.weights):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


def test_spark_model_remat_fit_matches_reference(monkeypatch):
    """``SparkModel(remat=True)`` (synchronous, 2 workers, the reference's
    default ``parameter_server_mode``) against ``elephas_tpu.SparkModel(
    remat=True)``: histories and weights, moving statistics included."""
    monkeypatch.setattr(port_engine, "epoch_permutation", jax_permutation)
    x, y = _data(120)
    kw = dict(mode="synchronous", num_workers=2, remat=True)
    fit = dict(epochs=2, batch_size=8, validation_split=0.25)
    jsm = JSparkModel(_model(rate=0.0), **kw)
    jsm.fit(j_to_simple_rdd(JSparkContext("local[2]"), x, y), **fit)
    tsm = SparkModel(_model(rate=0.0), device="cpu", **kw)
    assert tsm.remat is True
    tsm.fit(to_simple_rdd(SparkContext("local[2]"), x, y), **fit)
    assert_same_fit(tsm, jsm)
