"""The port's distributed hyperparameter search
(``elephas_tpu_torch/hyperparam.py``) against the JAX package's.

- ``TPESampler.suggest`` proposes the reference's parameter vectors over
  the same seeded trials (the cases of ``tests/integration/test_tpe.py``).
- ``compute_trials`` with a framework-free model function, whose loss is a
  fixed function of its parameters: the same ``params`` and ``loss`` per
  partition as the reference's, each trial recording the device it ran on
  (``"cpu"`` here; the card test holds the pinning).
- ``minimize`` and ``best_models`` over a Keras model function (the
  reference test's): the port rebuilds the best trials as its adapter,
  whose predictions match the trained Keras model's (1e-5).
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import contextlib
import math
import random
import threading

import keras
import numpy as np
import pytest

import elephas_tpu.hyperparam as jh
import elephas_tpu_torch.hyperparam as th
from elephas_tpu.data import SparkContext as JSparkContext
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.hyperparam import (STATUS_OK, HyperParamModel, VotingModel, choice,
                                          uniform)
from elephas_tpu_torch.models import KerasModelAdapter


@pytest.fixture(autouse=True)
def restore_global_rngs():
    from keras.src.backend.common import global_state
    from keras.src.random import seed_generator
    from keras.src.utils import rng_utils

    keys = (rng_utils.GLOBAL_RANDOM_SEED, seed_generator.GLOBAL_SEED_GENERATOR)
    saved = [global_state.get_global_attribute(k) for k in keys]
    np_state, py_state = np.random.get_state(), random.getstate()
    yield
    np.random.set_state(np_state)
    random.setstate(py_state)
    for k, v in zip(keys, saved):
        global_state.set_global_attribute(k, v)


# -- the TPE sampler (tests/integration/test_tpe.py's cases) --------------------------


def _spaces(mod, kinds):
    make = {"uniform": lambda: mod._Uniform(0.0, 10.0), "unit": lambda: mod._Uniform(0, 1),
            "log": lambda: mod._LogUniform(1e-5, 1.0), "log4": lambda: mod._LogUniform(1e-4, 1e-1),
            "choice": lambda: mod._Choice([16, 32, 64, 128]),
            "ab": lambda: mod._Choice(["a", "b"]), "q": lambda: mod._QUniform(0, 100, 10)}
    return [make[k]() for k in kinds]


TPE_CASES = {
    "startup": (["unit"], lambda p: 0.0, 0, 0, 1),
    "concentrates": (["uniform"], lambda p: (p[0] - 2.0) ** 2, 40, 1, 50),
    "loguniform": (["log"], lambda p: abs(math.log10(p[0]) + 3.0), 40, 2, 50),
    "choice": (["choice"], lambda p: 0.0 if p[0] == 64 else 1.0, 40, 3, 60),
    "mixed": (["unit", "ab", "q", "log4"],
              lambda p: p[0] + (0.0 if p[1] == "b" else 1.0) + abs(p[2] - 50) / 100, 30, 7, 20),
}


@pytest.mark.parametrize("case", sorted(TPE_CASES))
def test_tpe_draws_match_reference(case):
    kinds, loss, n_trials, seed, n_draws = TPE_CASES[case]
    draws = []
    for mod in (th, jh):
        spaces = _spaces(mod, kinds)
        rng = random.Random(0)
        trials = []
        for _ in range(n_trials):
            params = [s.sample(rng) for s in spaces]
            trials.append({"loss": loss(params), "status": mod.STATUS_OK, "params": params})
        sampler = mod.TPESampler(spaces)
        rng = random.Random(seed)
        draws.append([sampler.suggest(trials, rng) for _ in range(n_draws)])
    assert draws[0] == draws[1]


# -- compute_trials with a framework-free model ---------------------------------------


class _Fixed:
    """A trained "model" without a framework: its JSON and weights are its
    parameters."""

    def __init__(self, units, rate):
        self.units, self.rate = units, rate

    def to_json(self):
        return f'{{"units": {self.units}, "rate": {self.rate!r}}}'

    def get_weights(self):
        return [np.full((2,), self.rate, np.float32)]


def fixed_data():
    return (np.zeros(1),) * 4


def fixed_model(x_train, y_train, x_test, y_test):
    units = {{choice([8, 16, 32])}}
    rate = {{uniform(0.0, 0.3)}}
    return {"loss": abs(units - 16) / 16 + (rate - 0.1) ** 2, "status": STATUS_OK,
            "model": _Fixed(units, rate)}


@pytest.mark.parametrize("workers,evals", [(2, 6), (3, 4)])
def test_compute_trials_matches_reference(workers, evals):
    got = HyperParamModel(SparkContext("local[4]"), workers, device="cpu").compute_trials(
        fixed_model, fixed_data, evals, keep_weights_top=2)
    want = jh.HyperParamModel(JSparkContext("local[4]"), workers).compute_trials(
        fixed_model, fixed_data, evals, keep_weights_top=2)
    assert len(got) == len(want) == workers * evals
    for g, w in zip(got, want):
        assert (g["params"], g["loss"], g["status"], g["model_json"]) == \
            (w["params"], w["loss"], w["status"], w["model_json"])
        assert (g["weights"] is None) == (w["weights"] is None)
        assert g["device"] == "cpu"
    assert sum(t["weights"] is not None for t in got) == 2 * workers


# -- minimize / best_models over Keras models (the reference test's model) -------------


_TRAINED = []
_TRAINED_LOCK = threading.Lock()


def keras_data():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(256, 8)).astype("float32")
    w = rng.normal(size=(8, 2))
    y = np.eye(2, dtype="float32")[(x @ w).argmax(1)]
    return x[:192], y[:192], x[192:], y[192:]


def keras_model(x_train, y_train, x_test, y_test):
    import keras

    m = keras.Sequential(
        [
            keras.layers.Dense({{choice([8, 16, 32])}}, activation="relu"),
            keras.layers.Dropout({{uniform(0.0, 0.3)}}),
            keras.layers.Dense(2, activation="softmax"),
        ]
    )
    m.build((None, 8))
    m.compile(optimizer="adam", loss="categorical_crossentropy", metrics=["accuracy"])
    m.fit(x_train, y_train, epochs=3, batch_size=32, verbose=0)
    loss, acc = m.evaluate(x_test, y_test, verbose=0)
    with _TRAINED_LOCK:
        _TRAINED.append(m)
    return {"loss": -acc, "status": STATUS_OK, "model": m}


def _trained_like(adapter):
    """The Keras model a trial trained whose weights the adapter holds."""
    got = adapter.get_weights()
    matches = [m for m in _TRAINED if len(m.get_weights()) == len(got)
               and all(np.array_equal(a, b) for a, b in zip(m.get_weights(), got))]
    assert len(matches) == 1
    return matches[0]


@contextlib.contextmanager
def _fresh_trained():
    keras.utils.set_random_seed(0)
    _TRAINED.clear()
    try:
        yield
    finally:
        _TRAINED.clear()


def test_minimize_rebuilds_the_best_trial_as_the_port_adapter():
    with _fresh_trained():
        best = HyperParamModel(SparkContext("local[2]"), 2, device="cpu").minimize(
            keras_model, keras_data, max_evals=1)
        assert isinstance(best, KerasModelAdapter) and best.device.type == "cpu"
        x_te = keras_data()[2]
        np.testing.assert_allclose(best.predict(x_te, verbose=0),
                                   _trained_like(best).predict(x_te, verbose=0),
                                   atol=1e-5, rtol=1e-5)


def test_best_models_vote_with_port_adapters():
    with _fresh_trained():
        ensemble = HyperParamModel(SparkContext("local[2]"), 2, device="cpu").best_models(
            nb_models=2, model=keras_model, data=keras_data, max_evals=1)
        assert isinstance(ensemble, VotingModel) and len(ensemble.models) == 2
        x_te = keras_data()[2]
        want = np.mean([_trained_like(m).predict(x_te, verbose=0)
                        for m in ensemble.models], axis=0)
        preds = ensemble.predict(x_te)
        assert preds.shape == (64, 2)
        np.testing.assert_allclose(preds, want, atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(ensemble.predict_classes(x_te), preds.argmax(-1))


def test_search_without_successful_trials_raises():
    def failing_model(x_train, y_train, x_test, y_test):
        return {"loss": {{uniform(0.0, 1.0)}}, "status": "fail", "model": _Fixed(1, 0.0)}

    hp = HyperParamModel(SparkContext("local[2]"), 2, device="cpu")
    with pytest.raises(ValueError, match="no successful trials"):
        hp.minimize(failing_model, fixed_data, max_evals=2)
    with pytest.raises(ValueError, match="no successful trials"):
        hp.best_models(1, failing_model, fixed_data, max_evals=2)
