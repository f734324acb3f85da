"""The port's checkpoints (``elephas_tpu_torch/utils/checkpoint.py``),
checkpointed fits and ``save`` / ``load_spark_model`` against the JAX
package's.

- ``atomic_write`` leaves the previous version on a crash; ``has_checkpoint``
  rejects a partial directory.
- ``weights.npz`` and ``meta.json`` cross between the packages both ways;
  the port's optimizer-state files round-trip without pickle; a JAX-package
  checkpoint's pickled optimizer state is refused with a warning.
- A synchronous fit checkpointed after 2 epochs and resumed by a new
  ``SparkModel`` to 4 reproduces the uninterrupted 4-epoch fit at the
  reference test's rtol 1e-5 / atol 1e-6 (``tests/integration/
  test_checkpoint.py``), with dropout on; a checkpointed fit merges once,
  as the uninterrupted one; a stale ``worker_state`` warns.
- ``save`` → ``load_spark_model`` → ``predict`` gives the same bits, and the
  sidecar carries the reference's keys.
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import json
import os
import warnings

import keras
import numpy as np
import pytest
import torch

from elephas_tpu import SparkModel as JSparkModel
from elephas_tpu.data import SparkContext as JSparkContext
from elephas_tpu.utils import checkpoint as jckpt
from elephas_tpu.utils import to_simple_rdd as j_to_simple_rdd
from elephas_tpu_torch import SparkModel
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.models.optimizers import AdamState
from elephas_tpu_torch.spark_model import load_spark_model
from elephas_tpu_torch.utils import checkpoint as tckpt
from elephas_tpu_torch.utils import to_simple_rdd

from .conftest import make_classifier
from .test_torch_host_fit import restore_global_rngs  # noqa: F401 (autouse)


def _dropout_model():
    keras.utils.set_random_seed(2)
    m = keras.Sequential([keras.layers.Dense(32, activation="relu"),
                          keras.layers.Dropout(0.2),
                          keras.layers.Dense(3, activation="softmax")])
    m.build((None, 10))
    m.compile("adam", "categorical_crossentropy", metrics=["accuracy"])
    return m


def test_atomic_write_keeps_the_previous_version_on_a_crash(tmp_path):
    path = str(tmp_path / "f.bin")
    with tckpt.atomic_write(path) as f:
        f.write(b"first")
    with pytest.raises(RuntimeError, match="crash"):
        with tckpt.atomic_write(path) as f:
            f.write(b"second, torn")
            raise RuntimeError("crash")
    assert open(path, "rb").read() == b"first"
    assert os.listdir(tmp_path) == ["f.bin"]      # no temp sibling left


def test_has_checkpoint_rejects_partial_directories(tmp_path):
    d = str(tmp_path / "c")
    assert not tckpt.has_checkpoint(d)
    tckpt.save_checkpoint(d, [np.ones(3)], {"epoch": 1})
    assert tckpt.has_checkpoint(d)
    os.unlink(os.path.join(d, "weights.npz"))
    assert not tckpt.has_checkpoint(d)             # meta without weights
    tckpt.save_checkpoint(d, [np.ones(3)], {"epoch": 1})
    with open(os.path.join(d, "meta.json"), "w") as f:
        f.write('{"epoch": ')                       # a truncated meta
    assert not tckpt.has_checkpoint(d)
    os.unlink(os.path.join(d, "meta.json"))
    assert not tckpt.has_checkpoint(d)


def test_checkpoints_cross_between_the_packages(tmp_path):
    rng = np.random.default_rng(0)
    weights = [rng.normal(size=(5, 4)).astype(np.float32), np.arange(4, dtype=np.float32)]
    meta = {"epoch": 3, "epochs": 8, "mode": "synchronous"}
    opt = AdamState(torch.tensor([2, 2], dtype=torch.int32),
                    {"d/kernel": torch.ones(2, 5, 4)}, {"d/kernel": torch.full((2, 5, 4), 3.0)})
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    tckpt.save_checkpoint(port_dir, weights, meta, opt)
    jckpt.save_checkpoint(ref_dir, weights, meta, {"mu": np.ones(3, np.float32)})
    for name in ("weights.npz", "meta.json"):
        assert open(os.path.join(port_dir, name), "rb").read() == \
            open(os.path.join(ref_dir, name), "rb").read()
    # the reference reads the port's weights and meta (and no optimizer state)
    w, m, o = jckpt.load_checkpoint(port_dir)
    assert m == meta and o is None
    for a, b in zip(w, weights):
        np.testing.assert_array_equal(a, b)
    # the port reads its own optimizer state back, exactly, without pickle
    w, m, o = tckpt.load_checkpoint(port_dir)
    assert m == meta and isinstance(o, AdamState)
    assert torch.equal(o.count, opt.count) and torch.equal(o.nu["d/kernel"], opt.nu["d/kernel"])
    assert not any(n.endswith(".pkl") for n in os.listdir(port_dir))
    # the port reads the reference's weights and meta, and refuses its pickle
    with pytest.warns(RuntimeWarning, match="JAX"):
        w, m, o = tckpt.load_checkpoint(ref_dir)
    assert m == meta and o is None
    for a, b in zip(w, weights):
        np.testing.assert_array_equal(a, b)


def test_pytree_round_trip_and_place_like(tmp_path):
    tree = {"tv_stack": {"k": torch.arange(6.0).reshape(2, 3)}, "steps": [np.int64(4)],
            "opt": AdamState(torch.zeros((), dtype=torch.int32), {}, {})}
    tckpt.save_pytree(str(tmp_path / "t"), tree)
    back = tckpt.load_pytree(str(tmp_path / "t"))
    assert torch.equal(back["tv_stack"]["k"], tree["tv_stack"]["k"])
    assert int(back["steps"][0]) == 4 and isinstance(back["opt"], AdamState)
    template = {"tv_stack": {"k": torch.zeros(2, 3, dtype=torch.float64)}}
    placed = tckpt.place_like(template, {"tv_stack": {"k": np.ones((2, 3), np.float32)}})
    assert placed["tv_stack"]["k"].dtype == torch.float64
    with pytest.raises(TypeError, match="numeric"):
        tckpt.save_pytree(str(tmp_path / "bad"), {"x": np.array(["a"])})
    with pytest.raises(NotImplementedError, match="item 6"):
        tckpt.save_sharded_pytree(str(tmp_path / "s"), tree)
    with pytest.raises(NotImplementedError, match="item 6"):
        tckpt.load_sharded_pytree(str(tmp_path / "s"))


def _fit(sm, x, y, **kw):
    sm.fit(to_simple_rdd(SparkContext("local[4]"), x, y), batch_size=16,
           validation_split=0.1, **kw)


def test_resumed_sync_fit_reproduces_the_uninterrupted_one(tmp_path, toy_classification):
    x, y = toy_classification
    model = _dropout_model()
    init = [np.array(w) for w in model.get_weights()]
    ckpt = str(tmp_path / "ckpt")
    plain = SparkModel(model, mode="synchronous", num_workers=4, device="cpu")
    _fit(plain, x, y, epochs=4)
    chunked = SparkModel(model, mode="synchronous", num_workers=4, device="cpu")
    chunked.master_network.set_weights(init)
    _fit(chunked, x, y, epochs=4, checkpoint_dir=str(tmp_path / "every"),
         checkpoint_frequency=1)
    first = SparkModel(model, mode="synchronous", num_workers=4, device="cpu")
    first.master_network.set_weights(init)
    _fit(first, x, y, epochs=2, checkpoint_dir=ckpt, checkpoint_frequency=2)
    assert tckpt.load_checkpoint(ckpt)[1]["epoch"] == 2
    # "crash": a NEW SparkModel resumes epochs 2..4 from the checkpoint
    second = SparkModel(make_classifier_like(model), mode="synchronous", num_workers=4,
                        device="cpu")
    _fit(second, x, y, epochs=4, checkpoint_dir=ckpt, checkpoint_frequency=2, resume=True)
    assert len(second.training_histories[-1]["loss"]) == 2
    for sm in (chunked, second):
        for a, b in zip(sm.master_network.get_weights(), plain.master_network.get_weights()):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(chunked.training_histories[-1]["loss"],
                               plain.training_histories[-1]["loss"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(first.training_histories[-1]["loss"]
                               + second.training_histories[-1]["loss"],
                               plain.training_histories[-1]["loss"], rtol=1e-5, atol=1e-6)
    w, meta, opt = tckpt.load_checkpoint(ckpt)
    assert meta == {"epoch": 4, "epochs": 4, "mode": "synchronous"}
    assert opt.count.tolist() == [4 * 9] * 4     # 9 batches an epoch, per worker


def test_state_parameter_dicts_are_written_by_position(tmp_path, toy_classification):
    """The optimizer state and the worker stacks name no parameter: each
    parameter dict is written in ``weights.npz``'s order and takes the
    loading model's names; a model of another parameter count is refused."""
    x, y = toy_classification
    ckpt = str(tmp_path / "ckpt")
    sm = SparkModel(make_classifier(), mode="synchronous", num_workers=4, device="cpu")
    _fit(sm, x, y, epochs=1, checkpoint_dir=ckpt, checkpoint_frequency=1)
    names = list(sm.master_network.state_values()[0])
    for f in ("opt_state.json", os.path.join("worker_state", "structure.json")):
        text = open(os.path.join(ckpt, f)).read()
        assert '"params"' in text and not any(f'"{n}"' in text for n in names), f
    opt = tckpt.load_checkpoint(ckpt)[2]
    assert isinstance(opt.mu, tckpt.Positional) and len(opt.mu) == len(names)
    renamed = [f"p{i}" for i in range(len(names))]
    back = tckpt.params_by_name(opt, renamed)
    assert list(back.mu) == renamed
    torch.testing.assert_close(back.nu["p1"], opt.nu[1], rtol=0, atol=0)
    assert tckpt.params_by_position(back, renamed).mu == opt.mu
    with pytest.raises(ValueError, match="parameters"):
        tckpt.params_by_name(opt, renamed[:-1])


def make_classifier_like(model):
    """A fresh model of the same architecture with other weights."""
    keras.utils.set_random_seed(9)
    return keras.models.model_from_json(model.to_json())


def test_resume_with_stale_worker_state_warns(tmp_path, toy_classification):
    x, y = toy_classification
    ckpt = str(tmp_path / "ckpt")
    sm = SparkModel(make_classifier(), mode="synchronous", num_workers=4, device="cpu")
    _fit(sm, x, y, epochs=2, checkpoint_dir=ckpt, checkpoint_frequency=2)
    ws = tckpt.load_pytree(os.path.join(ckpt, "worker_state"))
    ws["epoch"] = np.int64(1)                      # a crash between the writes
    tckpt.save_pytree(os.path.join(ckpt, "worker_state"), ws)
    again = SparkModel(make_classifier(), mode="synchronous", num_workers=4, device="cpu")
    with pytest.warns(RuntimeWarning, match="stamped epoch 1"):
        _fit(again, x, y, epochs=3, checkpoint_dir=ckpt, checkpoint_frequency=2,
             resume=True)
    assert tckpt.load_checkpoint(ckpt)[1]["epoch"] == 3


def test_checkpointed_async_fit_and_reference_resume(tmp_path, toy_classification):
    """An asynchronous compiled-path fit checkpoints per chunk (no worker
    stacks); the JAX package resumes from the port's checkpoint weights."""
    x, y = toy_classification
    ckpt = str(tmp_path / "ckpt")
    sm = SparkModel(make_classifier(), mode="asynchronous", parameter_server_mode="jax",
                    num_workers=2, device="cpu")
    _fit(sm, x, y, epochs=2, checkpoint_dir=ckpt, checkpoint_frequency=1)
    assert not os.path.exists(os.path.join(ckpt, "worker_state"))
    assert len(sm.training_histories[-1]["loss"]) == 2
    jsm = JSparkModel(make_classifier(), mode="asynchronous", parameter_server_mode="jax",
                      num_workers=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsm.fit(j_to_simple_rdd(JSparkContext("local[2]"), x, y), epochs=3, batch_size=16,
                validation_split=0.1, checkpoint_dir=ckpt, checkpoint_frequency=1,
                resume=True)
    assert len(jsm.training_histories[-1]["loss"]) == 1
    assert jckpt.load_checkpoint(ckpt)[1]["epoch"] == 3


def test_save_load_round_trips_predictions_exactly(tmp_path, toy_classification):
    x, y = toy_classification
    sm = SparkModel(make_classifier(), mode="asynchronous", frequency="batch",
                    num_workers=2, batch_size=16, port=0, device="cpu")
    sm.fit(to_simple_rdd(SparkContext("local[2]"), x, y), epochs=1, batch_size=16)
    path = str(tmp_path / "model.npz")
    sm.save(path)
    loaded = load_spark_model(path, device="cpu")
    assert np.array_equal(loaded.predict(x), sm.predict(x))
    assert loaded.get_config() == sm.get_config()
    sidecar = json.load(open(path + ".elephas.json"))
    assert set(sidecar) == set(JSparkModel(make_classifier()).get_config())
    assert json.loads(loaded.master_network.to_json()) == json.loads(
        sm.master_network.to_json())
