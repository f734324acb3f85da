"""Functional optimizers for the LM train step (port of the Adam family in
``elephas_tpu/models/optimizers.py``).

Each optimizer is a pair of pure functions over dicts of tensors, as the
reference's optax transformations are: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, the updates to be
applied as ``(p + u).to(p.dtype)``. The fused variants add
``fused_apply(grads, state, params) -> (params, state)``, which performs
the same arithmetic and the apply in one pass per parameter and is
bit-identical to ``update`` followed by that apply.

None of this is a kernel: the reference leaves the update to XLA's fusion,
and the port to eager PyTorch. Every function here returns new tensors and
never updates its arguments in place, so a caller may keep the previous
params and state. The step count stays on the tensors' device and the
bias corrections are computed there, so a step needs no host sync.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    """The reference's ``optax.ScaleByAdamState``: the step count (0-d
    int32) and the first and second moments, dicts shaped like the
    params."""

    count: torch.Tensor
    mu: Params
    nu: Params


class GradientTransformation(NamedTuple):
    """``init`` and ``update``, as an optax ``GradientTransformation``."""

    init: Callable
    update: Callable


class FusedOptimizer(NamedTuple):
    """A :class:`GradientTransformation` plus ``fused_apply(grads, state,
    params) -> (params, state)``, which collapses the update math and the
    dtype-preserving apply into one expression per parameter. The state is
    the same as the unfused path's, so the two interoperate."""

    init: Callable
    update: Callable
    fused_apply: Callable


def _zero_count(params: Params, count_shape=()) -> torch.Tensor:
    """The step count of a fresh state: int32 zeros of ``count_shape``,
    ``()`` for one set of params, ``(L,)`` for a stack of ``L`` replicas
    whose leading axis is the replica (each replica keeps its own count,
    as ``jax.vmap(optimizer.init)`` gives the reference's)."""
    first = next(iter(params.values()))
    return torch.zeros(count_shape, dtype=torch.int32, device=first.device)


def _lead(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (shaped like a step count) viewed to broadcast over ``like``
    from the leading axes."""
    return t.reshape(t.shape + (1,) * (like.dim() - t.dim()))


def _adam_fns(learning_rate: float, b1: float, b2: float, eps: float,
              moment_dtype: torch.dtype):
    """``(init, update, fused_apply)`` of Adam with moments stored in
    ``moment_dtype`` and every operation in float32."""
    step_size = -float(learning_rate)

    def init(params: Params, count_shape=()) -> AdamState:
        zeros = {k: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
                 for k, p in params.items()}
        return AdamState(
            count=_zero_count(params, count_shape),
            mu=zeros,
            nu={k: torch.zeros_like(z) for k, z in zeros.items()})

    def corrections(count):
        c = count.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=c.device)
        return (1.0 - torch.pow(one * b1, c), 1.0 - torch.pow(one * b2, c))

    # Every step below rounds exactly as the out-of-place expression in its
    # comment; the in-place forms work on fresh float32 temporaries only
    # (never on an argument), which keeps one parameter's transient memory
    # at about two float32 copies of it: at Mixtral width one expert stack
    # is 3.8 GB.
    def moments(g, m, v):
        g32 = g.to(torch.float32)
        # b1 * m + (1 - b1) * g
        m32 = m.to(torch.float32, copy=True).mul_(b1).add_((1.0 - b1) * g32)
        # b2 * v + (1 - b2) * g * g
        v32 = v.to(torch.float32, copy=True).mul_(b2).add_((1.0 - b2) * g32 * g32)
        return m32, v32

    def step_and_moments(g, m, v, bc1, bc2):
        """``(u, mu, nu)``: the scaled update ``((m / bc1) / (sqrt(v / bc2)
        + eps)) * step_size`` in float32 and the new stored moments."""
        m32, v32 = moments(g, m, v)
        # copies even for float32 moments: m32 and v32 are reused in place
        mu = m32.to(moment_dtype, copy=True)
        nu = v32.to(moment_dtype, copy=True)
        den = v32.div_(_lead(bc2, v32)).sqrt_().add_(eps)
        return m32.div_(_lead(bc1, m32)).div_(den).mul_(step_size), mu, nu

    def update(grads: Params, state: AdamState, params=None):
        del params
        count = state.count + 1
        bc1, bc2 = corrections(count)
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            # optax.scale(-learning_rate) is the step_size factor
            updates[k], mu[k], nu[k] = step_and_moments(
                g, state.mu[k], state.nu[k], bc1, bc2)
        return updates, AdamState(count, mu, nu)

    def fused_apply(grads: Params, state: AdamState, params: Params):
        count = state.count + 1
        bc1, bc2 = corrections(count)
        out, mu, nu = {}, {}, {}
        for k, g in grads.items():
            u, mu[k], nu[k] = step_and_moments(g, state.mu[k], state.nu[k],
                                               bc1, bc2)
            p = params[k]
            out[k] = (p + u).to(p.dtype)
        return out, AdamState(count, mu, nu)

    return init, update, fused_apply


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """``optax.adam``'s update rule with float32 moments: ``m̂ / (√v̂ +
    eps)`` scaled by ``-learning_rate``, bias corrections from the step
    count. No ``fused_apply``, as in the reference (``fused_apply=True``
    with it is refused by the train step)."""
    init, update, _ = _adam_fns(learning_rate, b1, b2, eps, torch.float32)
    return GradientTransformation(init, update)


def scale_by_adam_compact(b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8,
                          moment_dtype: torch.dtype = torch.bfloat16
                          ) -> GradientTransformation:
    """Adam moments stored in ``moment_dtype`` (bfloat16 by default, half
    the optimizer memory), every operation in float32; the updates are the
    unscaled ``m̂ / (√v̂ + eps)``."""
    init, update, _ = _adam_fns(-1.0, b1, b2, eps, moment_dtype)
    return GradientTransformation(init, update)


def adam_compact(learning_rate: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 moment_dtype: torch.dtype = torch.bfloat16) -> FusedOptimizer:
    """:func:`scale_by_adam_compact` with the ``-learning_rate`` scale, a
    drop-in for :func:`adam` with half the optimizer memory, and its
    ``fused_apply``."""
    return FusedOptimizer(*_adam_fns(learning_rate, b1, b2, eps, moment_dtype))


def fused_adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> FusedOptimizer:
    """Plain Adam (float32 moments) with ``fused_apply``:
    :func:`adam_compact` at ``moment_dtype=torch.float32``."""
    return adam_compact(learning_rate, b1, b2, eps, moment_dtype=torch.float32)


# -- the Keras-spec optimizers of the MLP fit (port of ``to_optax``) ---------
#
# Each follows the update rule of the optax transformation the reference
# builds, operation for operation, over dicts of tensors; the step count
# may be a stack ``[L]`` (one count a replica), as ``_lead`` broadcasts it.


class TraceState(NamedTuple):
    """``optax.TraceState``: the momentum accumulator."""

    trace: Params


class RmsState(NamedTuple):
    """``optax.ScaleByRmsState`` (``mu`` empty) or, centred,
    ``ScaleByRStdDevState``; ``trace`` is the momentum stage's."""

    mu: Params
    nu: Params
    trace: Params


class RssState(NamedTuple):
    """``optax.ScaleByRssState``: the running sum of squared gradients."""

    sum_of_squares: Params


class AdaDeltaState(NamedTuple):
    """``optax.ScaleByAdaDeltaState``."""

    e_g: Params
    e_x: Params


class LionState(NamedTuple):
    """``optax.ScaleByLionState``."""

    count: torch.Tensor
    mu: Params


def _full_like(params: Params, value: float) -> Params:
    return {k: torch.full_like(p, value) for k, p in params.items()}


def _moment(g, t, decay: float, order: int):
    """optax's ``update_moment``: ``(1 - decay) * g**order + decay * t``."""
    return (1 - decay) * (g if order == 1 else g * g) + decay * t


def _bias_correction(moment, decay: float, count):
    """optax's ``bias_correction``: ``moment / (1 - decay**count)``, the
    power in float32 and the division in the moment's dtype."""
    c = count.to(torch.float32)
    base = torch.full((), decay, dtype=torch.float32, device=c.device)
    bc = 1 - torch.pow(base, c)
    return moment / _lead(bc, moment).to(moment.dtype)


def _trace_step(g, t, momentum: float, nesterov: bool):
    """optax's ``trace``: ``(updates, new trace)``."""
    new = g + momentum * t
    return (g + momentum * new if nesterov else new), new


def sgd(learning_rate: float, momentum=None, nesterov: bool = False
        ) -> GradientTransformation:
    """``optax.sgd``: an optional momentum trace, then ``-learning_rate``."""
    lr = float(learning_rate)

    def init(params: Params, count_shape=()):
        return TraceState({k: torch.zeros_like(p) for k, p in params.items()}
                          if momentum is not None else {})

    def update(grads: Params, state: TraceState, params=None):
        if momentum is None:
            return {k: g * -lr for k, g in grads.items()}, state
        out, trace = {}, {}
        for k, g in grads.items():
            u, trace[k] = _trace_step(g, state.trace[k], momentum, nesterov)
            out[k] = u * -lr
        return out, TraceState(trace)

    return GradientTransformation(init, update)


def _adam_family(learning_rate: float, b1: float, b2: float, eps: float,
                 weight_decay: float = 0.0, nesterov: bool = False
                 ) -> GradientTransformation:
    """``optax.adam`` (``nesterov``: ``optax.nadam``), with ``weight_decay``
    ``optax.adamw``: ``scale_by_adam``, ``add_decayed_weights``, then
    ``-learning_rate``."""
    lr = float(learning_rate)

    def init(params: Params, count_shape=()):
        return AdamState(_zero_count(params, count_shape),
                         {k: torch.zeros_like(p) for k, p in params.items()},
                         {k: torch.zeros_like(p) for k, p in params.items()})

    def update(grads: Params, state: AdamState, params=None):
        count = state.count + 1
        out, mu, nu = {}, {}, {}
        for k, g in grads.items():
            mu[k] = _moment(g, state.mu[k], b1, 1)
            nu[k] = _moment(g, state.nu[k], b2, 2)
            if nesterov:
                m_hat = (b1 * _bias_correction(mu[k], b1, count + 1)
                         + (1 - b1) * _bias_correction(g, b1, count))
            else:
                m_hat = _bias_correction(mu[k], b1, count)
            u = m_hat / (torch.sqrt(_bias_correction(nu[k], b2, count)) + eps)
            if weight_decay:
                u = u + weight_decay * params[k]
            out[k] = u * -lr
        return out, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def rmsprop(learning_rate: float, decay: float = 0.9, eps: float = 1e-8,
            momentum=None, centered: bool = False) -> GradientTransformation:
    """``optax.rmsprop`` (``eps`` inside the square root, no bias
    correction): ``scale_by_rms`` or, centred, ``scale_by_stddev``, then
    ``-learning_rate``, then the momentum trace."""
    lr = float(learning_rate)

    def init(params: Params, count_shape=()):
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return RmsState(dict(zeros) if centered else {}, _full_like(params, 0.0),
                        dict(zeros) if momentum is not None else {})

    def update(grads: Params, state: RmsState, params=None):
        out, mu, nu, trace = {}, {}, {}, {}
        for k, g in grads.items():
            nu[k] = _moment(g, state.nu[k], decay, 2)
            if centered:
                mu[k] = _moment(g, state.mu[k], decay, 1)
                u = torch.rsqrt(nu[k] - mu[k] * mu[k] + eps) * g
            else:
                u = torch.rsqrt(nu[k] + eps) * g
            u = u * -lr
            if momentum is not None:
                u, trace[k] = _trace_step(u, state.trace[k], momentum, False)
            out[k] = u
        return out, RmsState(mu, nu, trace)

    return GradientTransformation(init, update)


def adagrad(learning_rate: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> GradientTransformation:
    """``optax.adagrad``: ``scale_by_rss``, then ``-learning_rate``."""
    lr = float(learning_rate)

    def init(params: Params, count_shape=()):
        return RssState(_full_like(params, initial_accumulator_value))

    def update(grads: Params, state: RssState, params=None):
        out, acc = {}, {}
        for k, g in grads.items():
            acc[k] = g * g + state.sum_of_squares[k]
            inv = torch.where(acc[k] > 0, torch.rsqrt(acc[k] + eps), 0.0)
            out[k] = (inv * g) * -lr
        return out, RssState(acc)

    return GradientTransformation(init, update)


def adadelta(learning_rate: float, rho: float = 0.9, eps: float = 1e-6
             ) -> GradientTransformation:
    """``optax.adadelta`` (no weight decay): ``scale_by_adadelta``, then
    ``-learning_rate``."""
    lr = float(learning_rate)

    def init(params: Params, count_shape=()):
        return AdaDeltaState({k: torch.zeros_like(p) for k, p in params.items()},
                             {k: torch.zeros_like(p) for k, p in params.items()})

    def update(grads: Params, state: AdaDeltaState, params=None):
        out, e_g, e_x = {}, {}, {}
        for k, g in grads.items():
            e_g[k] = _moment(g, state.e_g[k], rho, 2)
            u = torch.sqrt(state.e_x[k] + eps) / torch.sqrt(e_g[k] + eps) * g
            e_x[k] = _moment(u, state.e_x[k], rho, 2)
            out[k] = u * -lr
        return out, AdaDeltaState(e_g, e_x)

    return GradientTransformation(init, update)


def adamax(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8) -> GradientTransformation:
    """``optax.adamax``: ``scale_by_adamax``, then ``-learning_rate``."""
    lr = float(learning_rate)

    def init(params: Params, count_shape=()):
        return AdamState(_zero_count(params, count_shape),
                         {k: torch.zeros_like(p) for k, p in params.items()},
                         {k: torch.zeros_like(p) for k, p in params.items()})

    def update(grads: Params, state: AdamState, params=None):
        count = state.count + 1
        out, mu, nu = {}, {}, {}
        for k, g in grads.items():
            mu[k] = _moment(g, state.mu[k], b1, 1)
            nu[k] = torch.maximum(torch.abs(g) + eps, b2 * state.nu[k])
            out[k] = (_bias_correction(mu[k], b1, count) / nu[k]) * -lr
        return out, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def lion(learning_rate: float, b1: float = 0.9, b2: float = 0.99,
         weight_decay: float = 1e-3) -> GradientTransformation:
    """``optax.lion``: ``scale_by_lion``, ``add_decayed_weights``, then
    ``-learning_rate``."""
    lr = float(learning_rate)

    def init(params: Params, count_shape=()):
        return LionState(_zero_count(params, count_shape),
                         {k: torch.zeros_like(p) for k, p in params.items()})

    def update(grads: Params, state: LionState, params=None):
        out, mu = {}, {}
        for k, g in grads.items():
            u = torch.sign((1.0 - b1) * g + b1 * state.mu[k])
            mu[k] = _moment(g, state.mu[k], b2, 1)
            out[k] = (u + weight_decay * params[k]) * -lr
        return out, LionState(state.count + 1, mu)

    return GradientTransformation(init, update)


# -- Keras's own update rules, for the host path's workers --------------------
#
# The reference's host workers compile a Keras replica and train it with
# Keras's optimizer, whose rules differ from optax's in the order of their
# operations: Keras's Adam folds both bias corrections into the step size
# and adds ``epsilon`` to ``sqrt(v)``; its SGD keeps a velocity that holds
# the learning rate. These follow Keras operation for operation.


class KerasAdamState(NamedTuple):
    """Keras Adam's slots: the step count (``iterations``, 0-d or ``[L]``),
    the momentums, the velocities and, with ``amsgrad``, the velocity hats
    (empty otherwise)."""

    count: torch.Tensor
    mu: Params
    nu: Params
    nu_hat: Params


def keras_sgd(learning_rate: float = 0.01, momentum: float = 0.0,
              nesterov: bool = False) -> GradientTransformation:
    """``keras.optimizers.SGD``'s update: ``-(g * lr)``, or with momentum
    the velocity ``m = m * momentum - g * lr`` (Nesterov: ``m * momentum -
    g * lr`` after that)."""
    lr, mom = float(learning_rate), float(momentum)

    def init(params: Params, count_shape=()):
        return TraceState({k: torch.zeros_like(p) for k, p in params.items()}
                          if mom else {})

    def update(grads: Params, state: TraceState, params=None):
        if not mom:
            return {k: -(g * lr) for k, g in grads.items()}, state
        out, trace = {}, {}
        for k, g in grads.items():
            m = state.trace[k] * mom - g * lr
            trace[k] = m
            out[k] = m * mom - g * lr if nesterov else m
        return out, TraceState(trace)

    return GradientTransformation(init, update)


def keras_adam(learning_rate: float = 0.001, beta_1: float = 0.9,
               beta_2: float = 0.999, epsilon: float = 1e-7,
               amsgrad: bool = False) -> GradientTransformation:
    """``keras.optimizers.Adam``'s update: ``alpha = lr * sqrt(1 - b2**t) /
    (1 - b1**t)``, ``m += (g - m) * (1 - b1)``, ``v += (g * g - v) * (1 -
    b2)``, then ``-(m * alpha) / (sqrt(v) + epsilon)``, every operation in
    float32 and the powers of the float32 betas."""
    lr = float(learning_rate)

    def init(params: Params, count_shape=()):
        def zeros():
            return {k: torch.zeros_like(p) for k, p in params.items()}

        return KerasAdamState(_zero_count(params, count_shape), zeros(), zeros(),
                              zeros() if amsgrad else {})

    def update(grads: Params, state: KerasAdamState, params=None):
        count = state.count + 1
        t = count.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=t.device)
        alpha = lr * torch.sqrt(1 - torch.pow(one * beta_2, t)) / (
            1 - torch.pow(one * beta_1, t))
        out, mu, nu, nu_hat = {}, {}, {}, {}
        for k, g in grads.items():
            mu[k] = state.mu[k] + (g - state.mu[k]) * (1 - beta_1)
            nu[k] = state.nu[k] + (g * g - state.nu[k]) * (1 - beta_2)
            v = nu[k]
            if amsgrad:
                v = nu_hat[k] = torch.maximum(state.nu_hat[k], nu[k])
            out[k] = -((mu[k] * _lead(alpha, g)) / (torch.sqrt(v) + epsilon))
        return out, KerasAdamState(count, mu, nu, nu_hat)

    return GradientTransformation(init, update)


def to_keras_optimizer(optimizer_spec: Any):
    """The optimizer of a Keras spec with Keras's own update rule, for the
    host path's workers: :func:`keras_sgd` and :func:`keras_adam`; any other
    optimizer takes :func:`to_torch_optimizer`'s (optax's) rule."""
    name, cfg = _normalize(keras_compiled_spec(optimizer_spec))
    lr = _extract_lr(cfg)
    if name == "sgd":
        return keras_sgd(lr, momentum=float(cfg.get("momentum", 0.0) or 0.0),
                         nesterov=bool(cfg.get("nesterov", False)))
    if name == "adam" and not cfg.get("moment_dtype"):
        return keras_adam(lr, beta_1=float(cfg.get("beta_1", 0.9)),
                          beta_2=float(cfg.get("beta_2", 0.999)),
                          epsilon=float(cfg.get("epsilon", 1e-7)),
                          amsgrad=bool(cfg.get("amsgrad", False)))
    return to_torch_optimizer(optimizer_spec)


def keras_compiled_spec(optimizer_spec: Any):
    """The spec of the optimizer that Keras's ``model.compile(optimizer=
    optimizer_spec)`` holds: a spec without a learning rate (a bare name)
    takes Keras's default rate for its class, 0.01 for SGD and 0.001 for
    the rest, rounded to float32 as Keras keeps it; a spec with one is
    returned as it is."""
    name, cfg = _normalize(optimizer_spec)
    if "learning_rate" in cfg or "lr" in cfg:
        return optimizer_spec
    rate = torch.tensor(0.01 if name == "sgd" else 0.001, dtype=torch.float32)
    return {"class_name": name, "config": {**cfg, "learning_rate": float(rate)}}


def _extract_lr(cfg: dict) -> float:
    lr = cfg.get("learning_rate", cfg.get("lr", 0.001))
    if isinstance(lr, dict):
        # Serialized Keras LearningRateSchedule — use its initial rate.
        inner = lr.get("config", {})
        lr = inner.get("initial_learning_rate", 0.001)
    return float(lr)


def _normalize(optimizer_spec) -> Tuple[str, dict]:
    """Spec (string / Keras optimizer / config dict) → (name, config)."""
    if isinstance(optimizer_spec, str):
        return optimizer_spec.lower(), {}
    if isinstance(optimizer_spec, dict):
        # Either a raw get_config() dict or keras.optimizers.serialize output.
        if "class_name" in optimizer_spec:
            return (
                optimizer_spec["class_name"].lower(),
                dict(optimizer_spec.get("config", {})),
            )
        return optimizer_spec.get("name", "sgd").lower(), dict(optimizer_spec)
    if hasattr(optimizer_spec, "get_config"):
        cfg = optimizer_spec.get_config()
        name = cfg.get("name", type(optimizer_spec).__name__).lower()
        return name, cfg
    raise TypeError(f"Cannot interpret optimizer spec: {optimizer_spec!r}")


_MOMENT_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                  "float32": torch.float32}


def to_torch_optimizer(optimizer_spec: Any):
    """The optimizer matching a Keras optimizer spec, with the reference's
    hyperparameter mapping and optax's update rules (port of ``to_optax``).

    Returns a :class:`GradientTransformation` (``adam`` with a
    ``moment_dtype`` in its config: :func:`adam_compact`, a
    :class:`FusedOptimizer`) whose ``init(params, count_shape=())`` takes
    the shape of the step count, ``(L,)`` for a stack of ``L`` replicas.
    An optimizer without a mapping falls back to SGD with a warning, as
    the reference does."""
    name, cfg = _normalize(optimizer_spec)
    lr = _extract_lr(cfg)

    def f(key, default):
        return float(cfg.get(key, default))

    if name == "sgd":
        momentum = float(cfg.get("momentum", 0.0) or 0.0)
        return sgd(lr, momentum=momentum or None,
                   nesterov=bool(cfg.get("nesterov", False)))
    if name == "adam":
        if cfg.get("moment_dtype"):
            mdt = cfg["moment_dtype"]
            return adam_compact(lr, b1=f("beta_1", 0.9), b2=f("beta_2", 0.999),
                                eps=f("epsilon", 1e-7),
                                moment_dtype=_MOMENT_DTYPES.get(str(mdt), mdt))
        return adam(lr, b1=f("beta_1", 0.9), b2=f("beta_2", 0.999),
                    eps=f("epsilon", 1e-7))
    if name in ("adamw", "nadam"):
        return _adam_family(
            lr, b1=f("beta_1", 0.9), b2=f("beta_2", 0.999), eps=f("epsilon", 1e-7),
            weight_decay=(float(cfg.get("weight_decay", 0.004) or 0.0)
                          if name == "adamw" else 0.0),
            nesterov=name == "nadam")
    if name == "rmsprop":
        return rmsprop(lr, decay=f("rho", 0.9), eps=f("epsilon", 1e-7),
                       momentum=float(cfg.get("momentum", 0.0) or 0.0),
                       centered=bool(cfg.get("centered", False)))
    if name == "adagrad":
        return adagrad(lr, initial_accumulator_value=f("initial_accumulator_value", 0.1),
                       eps=f("epsilon", 1e-7))
    if name == "adadelta":
        return adadelta(lr, rho=f("rho", 0.95), eps=f("epsilon", 1e-7))
    if name == "adamax":
        return adamax(lr, b1=f("beta_1", 0.9), b2=f("beta_2", 0.999),
                      eps=f("epsilon", 1e-7))
    if name == "lion":
        return lion(lr, b1=f("beta_1", 0.9), b2=f("beta_2", 0.99))

    warnings.warn(
        f"Optimizer '{name}' has no mapping; falling back to SGD(lr={lr}).")
    return sgd(lr)
