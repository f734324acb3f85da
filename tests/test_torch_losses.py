"""The port's per-sample losses, accuracies and optimizers
(``elephas_tpu_torch/models/losses.py``, ``models/optimizers.py``) against
the JAX package's (``resolve_per_sample_loss``, ``resolve_accuracy``,
``to_optax``) on the same numpy inputs.

Loss specs come three ways, as the port meets them: strings, Keras loss
objects (read duck-typed) and the Keras-serialized dicts a model's JSON
``compile_config`` carries. Losses within atol = rtol = 1e-5 (float32
reductions in another order); accuracies exactly. Optimizers: 5 steps of
each from the same parameters and gradients, every parameter within
atol = rtol = 1e-5 (float32, the same update rules op for op), bf16
moments within 1e-3 (both sides round the moments to bf16 each step, and a
rounding that differs in one ulp moves the update by up to 2**-8 of it).
"""

from . import _torch_threads  # noqa: F401  (two intra-op threads a process)
import warnings

import jax
import jax.numpy as jnp
import keras
import numpy as np
import pytest
import torch

from elephas_tpu.models import losses as JL
from elephas_tpu.models.optimizers import to_optax
from elephas_tpu_torch.models import losses as TL
from elephas_tpu_torch.models.optimizers import to_torch_optimizer

TOL = 1e-5


def _data(kind, rng, B=12, C=5):
    """``(y_true, y_pred)`` numpy arrays for a loss family."""
    if kind == "onehot":
        return (np.eye(C, dtype=np.float32)[rng.integers(0, C, size=B)],
                rng.normal(size=(B, C)).astype(np.float32))
    if kind == "probs":
        p = rng.random((B, C)).astype(np.float32) + 0.05
        return (np.eye(C, dtype=np.float32)[rng.integers(0, C, size=B)],
                (p / p.sum(-1, keepdims=True)).astype(np.float32))
    if kind == "onehot3d":
        return (np.eye(C, dtype=np.float32)[rng.integers(0, C, size=(B, 3))],
                rng.normal(size=(B, 3, C)).astype(np.float32))
    if kind == "sparse":
        return (rng.integers(0, C, size=(B,)).astype(np.float32),
                rng.normal(size=(B, C)).astype(np.float32))
    if kind == "sparse_probs":
        p = rng.random((B, C)).astype(np.float32) + 0.05
        return (rng.integers(0, C, size=(B, 1)).astype(np.float32),
                (p / p.sum(-1, keepdims=True)).astype(np.float32))
    if kind == "binary":
        return (rng.integers(0, 2, size=(B, 1)).astype(np.float32),
                rng.normal(size=(B, 1)).astype(np.float32))
    if kind == "binary_probs":
        return (rng.integers(0, 2, size=(B, 3)).astype(np.float32),
                rng.random((B, 3)).astype(np.float32))
    if kind == "regression":
        return (rng.normal(size=(B, 4)).astype(np.float32) * 2,
                rng.normal(size=(B, 4)).astype(np.float32))
    if kind == "scalar_vs_unit":     # _align_rank: y_true [B], y_pred [B, 1]
        return (rng.normal(size=(B,)).astype(np.float32),
                rng.normal(size=(B, 1)).astype(np.float32))
    if kind == "unit_vs_scalar":     # _align_rank: y_true [B, 1], y_pred [B]
        return (rng.normal(size=(B, 1)).astype(np.float32),
                rng.normal(size=(B,)).astype(np.float32))
    raise ValueError(kind)


# (name for ids, Keras object factory, string spec or None, data kind)
LOSSES = [
    ("mse", lambda: keras.losses.MeanSquaredError(), "mse", "regression"),
    ("mse_align", lambda: keras.losses.MeanSquaredError(), "mean_squared_error",
     "scalar_vs_unit"),
    ("mse_align_back", lambda: keras.losses.MeanSquaredError(), "mse", "unit_vs_scalar"),
    ("mae", lambda: keras.losses.MeanAbsoluteError(), "mae", "regression"),
    ("mae_align", lambda: keras.losses.MeanAbsoluteError(), "mae", "scalar_vs_unit"),
    ("bce", lambda: keras.losses.BinaryCrossentropy(), "binary_crossentropy",
     "binary_probs"),
    ("bce_logits", lambda: keras.losses.BinaryCrossentropy(from_logits=True), None,
     "binary"),
    ("bce_align", lambda: keras.losses.BinaryCrossentropy(from_logits=True), None,
     "scalar_vs_unit"),
    ("cce", lambda: keras.losses.CategoricalCrossentropy(), "categorical_crossentropy",
     "probs"),
    ("cce_logits", lambda: keras.losses.CategoricalCrossentropy(from_logits=True), None,
     "onehot"),
    ("cce_logits_3d", lambda: keras.losses.CategoricalCrossentropy(from_logits=True),
     None, "onehot3d"),
    ("scce", lambda: keras.losses.SparseCategoricalCrossentropy(),
     "sparse_categorical_crossentropy", "sparse_probs"),
    ("scce_logits", lambda: keras.losses.SparseCategoricalCrossentropy(from_logits=True),
     None, "sparse"),
    ("hinge", lambda: keras.losses.Hinge(), "hinge", "binary"),
    ("huber", lambda: keras.losses.Huber(delta=0.7), None, "regression"),
    ("huber_default", lambda: keras.losses.Huber(), "huber", "regression"),
]


def _spec(make, string, form):
    if form == "string":
        return string
    obj = make()
    return obj if form == "object" else keras.losses.serialize(obj)


def _jax_spec(spec):
    """The JAX package never meets a serialized dict (its adapter reads the
    live Keras model's loss object); it gets the object the dict stands for."""
    return keras.losses.deserialize(spec) if isinstance(spec, dict) else spec


LOSS_CASES = [(i, name, make, string, kind, form)
              for i, (name, make, string, kind) in enumerate(LOSSES)
              for form in ("object", "json", "string")
              if form != "string" or string is not None]


@pytest.mark.parametrize("i,name,make,string,kind,form", LOSS_CASES,
                         ids=[f"{c[1]}-{c[5]}" for c in LOSS_CASES])
def test_per_sample_loss_matches_jax(i, name, make, string, kind, form):
    spec = _spec(make, string, form)
    rng = np.random.default_rng(i)
    yt, yp = _data(kind, rng)
    want = JL.resolve_per_sample_loss(_jax_spec(spec))(jnp.asarray(yt), jnp.asarray(yp))
    got = TL.resolve_per_sample_loss(spec)(torch.from_numpy(yt), torch.from_numpy(yp))
    assert tuple(got.shape) == tuple(want.shape) == (yt.shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


ACCURACIES = [("cce", "categorical_crossentropy", "onehot"),
              ("cce_3d", "categorical_crossentropy", "onehot3d"),
              ("scce", "sparse_categorical_crossentropy", "sparse"),
              ("bce", "binary_crossentropy", "binary_probs"),
              ("mse_default", "mse", "onehot")]


@pytest.mark.parametrize("name,spec,kind", ACCURACIES, ids=[a[0] for a in ACCURACIES])
def test_accuracy_matches_jax(name, spec, kind):
    rng = np.random.default_rng(5)
    yt, yp = _data(kind, rng, B=40)
    for s in (spec, keras.losses.get(spec), keras.losses.serialize(keras.losses.get(spec))):
        want = JL.resolve_accuracy(_jax_spec(s))(jnp.asarray(yt), jnp.asarray(yp))
        got = TL.resolve_accuracy(s)(torch.from_numpy(yt), torch.from_numpy(yp))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compile_config_loss_reads_like_the_object():
    """What a model's JSON carries resolves to the same loss as the object."""
    m = keras.Sequential([keras.layers.Dense(3)])
    m.build((None, 4))
    m.compile("adam", keras.losses.CategoricalCrossentropy(from_logits=True))
    import json
    cfg = json.loads(m.to_json())["compile_config"]["loss"]
    assert TL._loss_name_and_config(cfg) == ("categorical_crossentropy",
                                             {**cfg["config"]})
    assert TL._loss_name_and_config(cfg)[1]["from_logits"] is True
    fn_spec = keras.losses.serialize(keras.losses.mean_squared_error)
    assert TL._loss_name_and_config(fn_spec)[0] == "mean_squared_error"


# the losses the reference hands to Keras: (name, Keras object factory, the
# string, data kind); objects with options where their class has them
KERAS_FALLBACK = [
    ("kl_divergence", lambda: keras.losses.KLDivergence(), "kl_divergence", "probs"),
    ("kld", lambda: keras.losses.KLDivergence(reduction="sum"), "kld", "probs"),
    ("poisson", lambda: keras.losses.Poisson(), "poisson", "positive"),
    ("log_cosh", lambda: keras.losses.LogCosh(), "log_cosh", "regression"),
    ("squared_hinge", lambda: keras.losses.SquaredHinge(), "squared_hinge", "binary"),
    ("categorical_hinge", lambda: keras.losses.CategoricalHinge(), "categorical_hinge",
     "onehot"),
    ("cosine_similarity", lambda: keras.losses.CosineSimilarity(axis=-1),
     "cosine_similarity", "regression"),
    ("mape", lambda: keras.losses.MeanAbsolutePercentageError(), "mape", "regression"),
    ("msle", lambda: keras.losses.MeanSquaredLogarithmicError(reduction=None),
     "mean_squared_logarithmic_error", "positive"),
    ("binary_focal", lambda: keras.losses.BinaryFocalCrossentropy(
        apply_class_balancing=True, alpha=0.3, gamma=1.5, label_smoothing=0.1),
     "binary_focal_crossentropy", "binary_probs"),
    ("binary_focal_logits", lambda: keras.losses.BinaryFocalCrossentropy(from_logits=True),
     "binary_focal_crossentropy", "binary"),
    ("categorical_focal", lambda: keras.losses.CategoricalFocalCrossentropy(
        alpha=0.4, gamma=1.0, from_logits=True, label_smoothing=0.05),
     "categorical_focal_crossentropy", "onehot"),
    ("generalized_ce", lambda: keras.losses.CategoricalGeneralizedCrossEntropy(q=0.7),
     "categorical_generalized_cross_entropy", "sparse_probs_flat"),
    ("dice", lambda: keras.losses.Dice(), "dice", "binary_probs"),
    ("dice_axis", lambda: keras.losses.Dice(axis=-1), "dice", "binary_probs"),
    ("tversky", lambda: keras.losses.Tversky(alpha=0.3, beta=0.7), "tversky",
     "binary_probs"),
]


def _fallback_data(kind, rng, B=12):
    if kind == "positive":
        return (rng.random((B, 4)).astype(np.float32) * 3,
                rng.random((B, 4)).astype(np.float32) + 0.1)
    if kind == "sparse_probs_flat":
        p = rng.random((B, 5)).astype(np.float32) + 0.05
        return (rng.integers(0, 5, size=(B,)).astype(np.float32),
                (p / p.sum(-1, keepdims=True)).astype(np.float32))
    return _data(kind, rng, B=B)


# Keras 3.13 registers CategoricalGeneralizedCrossEntropy's class only: its
# name does not resolve (in the reference as in the port) and Keras does not
# deserialize the class (the reference meets the object, the port its dict)
FALLBACK_CASES = [(i, name, make, string, kind, form)
                  for i, (name, make, string, kind) in enumerate(KERAS_FALLBACK)
                  for form in ("string", "object", "json")
                  if not (name == "generalized_ce" and form == "string")]


@pytest.mark.parametrize("i,name,make,string,kind,form", FALLBACK_CASES,
                         ids=[f"{c[1]}-{c[5]}" for c in FALLBACK_CASES])
def test_keras_fallback_loss_matches_jax(i, name, make, string, kind, form):
    """Every loss the reference hands to Keras, as a string (Keras's
    function: per-sample values), an object and its serialized dict (a
    Loss: one scalar under its reduction, broadcast to every row): the
    port against the reference's ``resolve_per_sample_loss`` on the same
    batch, and on a padded one (zero rows appended, as the engine pads),
    whose scalar the zero rows enter on both sides. Then over a replica
    stack: each replica's scalar is its own."""
    spec = _spec(make, string, form)
    rng = np.random.default_rng(100 + i)
    yt, yp = _fallback_data(kind, rng)
    port = TL.resolve_per_sample_loss(spec)
    assert isinstance(port, TL.KerasFallbackLoss)
    assert port.object_form == (form != "string")
    ref = JL.resolve_per_sample_loss(make() if name == "generalized_ce" else _jax_spec(spec))
    pad = [(yt, yp), (np.concatenate([yt, np.zeros((4,) + yt.shape[1:], yt.dtype)]),
                      np.concatenate([yp, np.zeros((4,) + yp.shape[1:], yp.dtype) + 0.5]))]
    for t, p in pad:
        want = np.asarray(ref(jnp.asarray(t), jnp.asarray(p)))
        got = port(torch.from_numpy(t), torch.from_numpy(p))
        assert tuple(got.shape) == want.shape == (t.shape[0],)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    stack = port.grouped(torch.from_numpy(np.stack([yt, pad[1][0][:12]])),
                         torch.from_numpy(np.stack([yp, pad[1][1][-12:]])))
    for l, (t, p) in enumerate(((yt, yp), (pad[1][0][:12], pad[1][1][-12:]))):
        np.testing.assert_allclose(stack[l].numpy(),
                                   np.asarray(ref(jnp.asarray(t), jnp.asarray(p))),
                                   atol=TOL, rtol=TOL)


def test_generalized_cross_entropy_string_does_not_resolve():
    """``"categorical_generalized_cross_entropy"`` is no name Keras 3.13's
    ``keras.losses.get`` resolves: both packages refuse it."""
    with pytest.raises(ValueError, match="interpret"):
        JL.resolve_per_sample_loss("categorical_generalized_cross_entropy")
    with pytest.raises(ValueError, match="interpret"):
        TL.resolve_per_sample_loss("categorical_generalized_cross_entropy")


def test_loss_without_an_implementation_raises():
    """CTC and Circle, which this test once found refused, take only the
    engine's two tensors in Keras 3.13: each form resolves and holds the
    reference's fall-back at 1e-5 (``test_ctc_and_circle_match_the_reference``
    holds them over padded batches and replica stacks); a loss Keras does
    not have still raises."""
    rng = np.random.default_rng(9)
    labels = rng.integers(1, 5, size=(4, 3)).astype(np.float32)
    logits = rng.normal(size=(4, 8, 5)).astype(np.float32)
    for spec in (keras.losses.CTC(), "ctc"):
        want = np.asarray(JL.resolve_per_sample_loss(spec)(jnp.asarray(labels),
                                                          jnp.asarray(logits)))
        got = TL.resolve_per_sample_loss(spec)(torch.from_numpy(labels),
                                               torch.from_numpy(logits))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    emb = rng.normal(size=(6, 4)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    ids = rng.integers(0, 2, size=6).astype(np.float32)
    want = np.asarray(JL.resolve_per_sample_loss("circle")(jnp.asarray(ids), jnp.asarray(emb)))
    got = TL.resolve_per_sample_loss("circle")(torch.from_numpy(ids), torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    with pytest.raises(NotImplementedError, match="not_a_loss"):
        TL.resolve_per_sample_loss("not_a_loss")


CTC_CIRCLE = [
    ("ctc", "string", lambda: "ctc"),
    ("ctc", "object", lambda: keras.losses.CTC()),
    ("ctc", "json", lambda: keras.losses.serialize(keras.losses.CTC())),
    ("ctc", "object-sum", lambda: keras.losses.CTC(reduction="sum")),
    ("circle", "string", lambda: "circle"),
    ("circle", "object", lambda: keras.losses.Circle()),
    ("circle", "json-options", lambda: keras.losses.serialize(
        keras.losses.Circle(gamma=20.0, margin=0.3, remove_diagonal=False))),
    ("circle", "object-sum", lambda: keras.losses.Circle(reduction="sum")),
    ("circle", "object-weighted-mean",
     lambda: keras.losses.Circle(reduction="mean_with_sample_weight")),
    ("circle", "object-none", lambda: keras.losses.Circle(reduction=None)),
]


def _ctc_circle_data(name, rng, B=12):
    if name == "ctc":
        labels = rng.integers(1, 5, size=(B, 4)).astype(np.float32)
        labels[0, 2:], labels[1, 1:] = 0, 0
        labels[2] = [3, 3, 3, 3]        # repeats: needs 7 of the 8 steps
        return labels, rng.normal(size=(B, 8, 5)).astype(np.float32)
    emb = rng.normal(size=(B, 6)).astype(np.float32)
    return (rng.integers(0, 3, size=B).astype(np.float32),
            emb / np.linalg.norm(emb, axis=1, keepdims=True))


@pytest.mark.parametrize("name,form,make", CTC_CIRCLE,
                         ids=[f"{n}-{f}" for n, f, _ in CTC_CIRCLE])
def test_ctc_and_circle_match_the_reference(name, form, make):
    """``ctc`` and ``circle`` in each form against the reference's
    fall-back: a batch, a padded one (zero rows appended, as the engine
    pads: they enter circle's pairs and a Loss object's scalar on both
    sides), and a replica stack, each replica's batch its own (circle
    pairs within a replica, never across the stack)."""
    spec = make()
    rng = np.random.default_rng(21)
    yt, yp = _ctc_circle_data(name, rng)
    port = TL.resolve_per_sample_loss(spec)
    ref = JL.resolve_per_sample_loss(spec)
    pad = [(yt, yp), (np.concatenate([yt, np.zeros((4,) + yt.shape[1:], yt.dtype)]),
                      np.concatenate([yp, np.zeros((4,) + yp.shape[1:], yp.dtype) + 0.5]))]
    for t, p in pad:
        want = np.asarray(ref(jnp.asarray(t), jnp.asarray(p)))
        got = port(torch.from_numpy(t), torch.from_numpy(p))
        assert tuple(got.shape) == want.shape == (t.shape[0],)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    second = (pad[1][0][-12:], pad[1][1][-12:])
    stack = port.grouped(torch.from_numpy(np.stack([yt, second[0]])),
                         torch.from_numpy(np.stack([yp, second[1]])))
    for l, (t, p) in enumerate(((yt, yp), second)):
        np.testing.assert_allclose(stack[l].numpy(), np.asarray(ref(jnp.asarray(t),
                                                                    jnp.asarray(p))),
                                   atol=TOL, rtol=TOL)


def test_ctc_gradient_and_infeasible_labels_match_the_reference():
    """The gradient of ``ctc`` through the reference's JAX fall-back and the
    port's recursion; labels that 3 steps cannot emit cost Keras's large
    finite value (its ``-1e5`` for an impossible transition), not ``inf``."""
    rng = np.random.default_rng(22)
    labels, logits = _ctc_circle_data("ctc", rng)
    ref = JL.resolve_per_sample_loss("ctc")
    want = np.asarray(jax.grad(lambda p: jnp.sum(ref(jnp.asarray(labels), p)))(
        jnp.asarray(logits)))
    pt = torch.from_numpy(logits).requires_grad_()
    TL.resolve_per_sample_loss("ctc")(torch.from_numpy(labels), pt).sum().backward()
    np.testing.assert_allclose(pt.grad.numpy(), want, atol=TOL, rtol=TOL)
    short = rng.normal(size=(12, 3, 5)).astype(np.float32)
    got = TL.resolve_per_sample_loss("ctc")(torch.from_numpy(labels), torch.from_numpy(short))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref(jnp.asarray(labels),
                                                           jnp.asarray(short))),
                               atol=TOL, rtol=TOL)
    assert np.isfinite(got.numpy()).all() and float(got.max()) > 1e4


# -- optimizers ---------------------------------------------------------------

OPTIMIZERS = [
    ("sgd", lambda: keras.optimizers.SGD(0.05)),
    ("sgd_momentum", lambda: keras.optimizers.SGD(0.05, momentum=0.9)),
    ("sgd_nesterov", lambda: keras.optimizers.SGD(0.05, momentum=0.9, nesterov=True)),
    ("adam", lambda: keras.optimizers.Adam(0.01)),
    ("adam_string", lambda: "adam"),
    ("adam_bf16_moments", lambda: {"class_name": "Adam",
                                   "config": {"learning_rate": 0.01,
                                              "moment_dtype": "bfloat16"}}),
    ("adamw", lambda: keras.optimizers.AdamW(0.01, weight_decay=0.05)),
    ("nadam", lambda: keras.optimizers.Nadam(0.01)),
    ("rmsprop", lambda: keras.optimizers.RMSprop(0.01)),
    ("rmsprop_centered_momentum", lambda: keras.optimizers.RMSprop(
        0.01, momentum=0.5, centered=True)),
    ("adagrad", lambda: keras.optimizers.Adagrad(0.05)),
    ("adadelta", lambda: keras.optimizers.Adadelta(1.0)),
    ("adamax", lambda: keras.optimizers.Adamax(0.01)),
    ("lion", lambda: keras.optimizers.Lion(0.001)),
    ("schedule", lambda: keras.optimizers.serialize(keras.optimizers.Adam(
        keras.optimizers.schedules.ExponentialDecay(0.02, 10, 0.5)))),
]


@pytest.mark.parametrize("name,make", OPTIMIZERS, ids=[o[0] for o in OPTIMIZERS])
def test_optimizer_matches_optax(name, make):
    spec = make()
    if not isinstance(spec, (str, dict)):
        spec = keras.optimizers.serialize(spec)    # what SparkModel ships
    rng = np.random.default_rng(11)
    params = {"kernel": rng.normal(size=(6, 4)).astype(np.float32),
              "bias": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    jopt = to_optax(spec)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    topt = to_torch_optimizer(spec)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = topt.init(tp)
    for g in grads:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = jax.tree_util.tree_map(jnp.add, jp, ju)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
    tol = 1e-3 if name == "adam_bf16_moments" else TOL
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=tol, rtol=tol)


def test_stacked_step_counts_are_per_replica():
    """A replica stack carries one step count a replica: a stack of two
    whose second replica skipped a step matches that replica alone."""
    spec = keras.optimizers.serialize(keras.optimizers.Adam(0.01))
    opt = to_torch_optimizer(spec)
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
    g = [torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32)) for _ in range(3)]
    state = opt.init({"w": p}, count_shape=(2,))
    assert tuple(state.count.shape) == (2,)
    stack = {"w": p.clone()}
    for i, gi in enumerate(g):
        u, new = opt.update({"w": gi}, state, stack)
        if i == 1:      # replica 1 skips step 2 (an all-padding batch)
            keep = torch.tensor([True, False])
            state = type(new)(torch.where(keep, new.count, state.count),
                              {"w": torch.where(keep[:, None], new.mu["w"], state.mu["w"])},
                              {"w": torch.where(keep[:, None], new.nu["w"], state.nu["w"])})
            stack = {"w": torch.where(keep[:, None], stack["w"] + u["w"], stack["w"])}
        else:
            state, stack = new, {"w": stack["w"] + u["w"]}
    assert state.count.tolist() == [3, 2]
    alone = {"w": p[1].clone()}
    s1 = opt.init(alone)
    for gi in (g[0][1], g[2][1]):
        u, s1 = opt.update({"w": gi}, s1, alone)
        alone = {"w": alone["w"] + u["w"]}
    torch.testing.assert_close(stack["w"][1], alone["w"], atol=0, rtol=0)


def test_unknown_optimizer_falls_back_to_sgd_with_a_warning():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        opt = to_torch_optimizer({"class_name": "Ftrl", "config": {"learning_rate": 0.1}})
    assert any("SGD" in str(w.message) for w in caught)
    p = {"w": torch.ones(2)}
    u, _ = opt.update({"w": torch.ones(2)}, opt.init(p), p)
    torch.testing.assert_close(u["w"], torch.full((2,), -0.1))
