"""Keras loss spec → per-sample PyTorch loss function (port of
``elephas_tpu/models/losses.py``).

The engine (``parallel/engine.py``) needs *per-sample* losses so that
padded samples (partition sizes rarely divide the batch size) can be
masked with zero sample-weights without changing the gradient's scale:
the weighted mean ``sum(l_i * w_i) / sum(w_i)`` then reproduces what
``model.fit`` computes on the real, unpadded batch.

A spec is what Keras ``compile(loss=...)`` takes and what a model's JSON
``compile_config`` carries: a string, a Keras-serialized dict
(``{"class_name": ..., "config": {...}}``), or an object with ``name`` and
``get_config()`` (a Keras loss, read duck-typed; nothing here imports
Keras). ``categorical_crossentropy(from_logits=True)`` on 2-D outputs runs
the fused loss of ``ops/fused_xent.py`` (K1 on a CUDA tensor).

The reference implements seven losses itself and reads only ``from_logits``
and ``delta`` of them (``CategoricalCrossentropy(label_smoothing=0.1)``
trains as without the option, here too); any other loss it hands to Keras's
``keras.losses.get(spec)``. The port has no Keras, so the losses Keras 3.13
has beyond those seven are ported here as Keras computes them
(:data:`KERAS_LOSSES`), in the two shapes the reference's fall-back takes:

- a name (or a serialized function) resolves to Keras's loss *function*:
  per-sample values in ``y_pred``'s dtype (``y_true`` cast to it), the
  mean taken over any axes past the first; a function that returns one
  value (``dice`` and ``tversky`` sum over every axis) is broadcast to
  every row;
- a Loss *object* (a serialized ``{"class_name", "config"}`` dict or an
  object read duck-typed) converts both tensors to its ``dtype`` (float32
  unless its config says otherwise), brings their ranks together, and
  reduces by its ``reduction`` to one scalar, which the reference
  broadcasts to every row. So a padded batch's zero rows enter that
  scalar, as they do in the reference.

Those scalars belong to one replica's batch: :class:`KerasFallbackLoss`
takes them per replica over a replica stack (:meth:`~KerasFallbackLoss.grouped`),
as it takes the functions whose values couple a batch's rows (``dice``,
``tversky``, ``circle``). Keras 3.13's ``ctc(y_true, y_pred)`` and
``circle(y_true, y_pred)`` take only the two tensors the engine carries:
``ctc`` integer labels and per-step logits, ``circle`` integer labels and
embeddings, its pairs formed across each replica's padded batch, padded
rows included, as the reference's fall-back receives that batch.

The metrics section ports what Keras ``compile(metrics=...)`` resolves from a
name or a config (:func:`resolve_metric`): the functions of
``keras.metrics`` and their aliases, per-sample values that Keras's
``MeanMetricWrapper`` averages; ``"accuracy"`` resolves from the shapes of
``y_true`` and ``y_pred`` as Keras resolves it; and the stateful classes
(``AUC``, ``Precision``, ``F1Score``, the IoU family, ...) of
:mod:`.stateful_metrics`, whose state is a vector summed over the batches.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.fused_xent import categorical_crossentropy_from_logits
from .stateful_metrics import STATEFUL_METRICS, StatefulMetric, build_stateful

_EPS = 1e-7

# the ROADMAP item the refused losses and metrics wait for
LOSSES_ITEM = ("ROADMAP queue 1 item 13 (Keras losses and metrics beyond those the port "
               "interprets)")
# the metrics still to port: part four of that item
METRICS_ITEM = "ROADMAP queue 1 item 13, part four (the metric classes left)"


def _mean_rest(per):
    """Mean over every axis but the first (``[B]`` stays ``[B]``)."""
    return per.reshape(per.shape[0], -1).mean(dim=-1) if per.dim() > 1 else per


def _mse(y_true, y_pred):
    return _mean_rest(torch.square(y_pred - y_true))


def _mae(y_true, y_pred):
    return _mean_rest(torch.abs(y_pred - y_true))


def _binary_crossentropy(from_logits: bool):
    def fn(y_true, y_pred):
        y_true = y_true.reshape(y_pred.shape).to(y_pred.dtype)
        if from_logits:
            # log-sum-exp stable form: max(x,0) - x*z + log(1+exp(-|x|))
            x = y_pred
            per = torch.clamp(x, min=0) - x * y_true + torch.log1p(torch.exp(-torch.abs(x)))
        else:
            p = torch.clamp(y_pred, _EPS, 1.0 - _EPS)
            per = -(y_true * torch.log(p) + (1.0 - y_true) * torch.log(1.0 - p))
        return _mean_rest(per)

    return fn


def _categorical_crossentropy(from_logits: bool):
    def fn(y_true, y_pred):
        y_true = y_true.to(y_pred.dtype)
        if from_logits:
            if y_pred.dim() == 2:
                # the hot path: K1 on a CUDA tensor (one pass per row, the
                # softmax recomputed in the backward), its plain version on
                # a CPU tensor
                return categorical_crossentropy_from_logits(y_pred, y_true)
            logp = torch.log_softmax(y_pred, dim=-1)
        else:
            logp = torch.log(torch.clamp(y_pred, _EPS, 1.0))
        per = -(y_true * logp).sum(dim=-1)
        return _mean_rest(per)

    return fn


def _sparse_categorical_crossentropy(from_logits: bool):
    def fn(y_true, y_pred):
        labels = y_true.reshape(y_pred.shape[:-1]).to(torch.int64)
        if from_logits:
            logp = torch.log_softmax(y_pred, dim=-1)
        else:
            logp = torch.log(torch.clamp(y_pred, _EPS, 1.0))
        per = -torch.gather(logp, -1, labels[..., None])[..., 0]
        return _mean_rest(per)

    return fn


def _hinge(y_true, y_pred):
    # Keras hinge maps {0,1} labels to {-1,1}.
    y = torch.where(y_true <= 0, -1.0, 1.0).to(y_pred.dtype)
    return _mean_rest(torch.clamp(1.0 - y * y_pred, min=0.0))


def _huber(delta: float = 1.0):
    def fn(y_true, y_pred):
        err = y_pred - y_true.to(y_pred.dtype)
        abs_err = torch.abs(err)
        quad = torch.clamp(abs_err, max=delta)
        return _mean_rest(0.5 * quad * quad + delta * (abs_err - quad))

    return fn


_ALIASES = {
    "mse": "mean_squared_error",
    "mae": "mean_absolute_error",
    "bce": "binary_crossentropy",
}


def _snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


def _loss_name_and_config(loss_spec) -> Tuple[str, dict]:
    """Normalize a loss spec (string / Keras-serialized dict / Keras loss
    object / callable) to ``(name, cfg)``."""
    if isinstance(loss_spec, str):
        name = loss_spec.lower()
        return _ALIASES.get(name, name), {}
    if isinstance(loss_spec, dict):
        cfg = loss_spec.get("config", loss_spec)
        if loss_spec.get("class_name") == "function" and isinstance(cfg, str):
            name = cfg          # a serialized loss function: config is its name
            cfg = {}
        else:
            cfg = dict(cfg) if isinstance(cfg, dict) else {}
            name = cfg.get("name") or _snake(str(loss_spec.get("class_name", "")))
        name = str(name).lower()
        return _ALIASES.get(name, name), cfg
    cfg = {}
    if hasattr(loss_spec, "get_config"):
        try:
            cfg = loss_spec.get_config() or {}
        except Exception:
            cfg = {}
    name = getattr(loss_spec, "name", None) or getattr(loss_spec, "__name__", "")
    name = str(name).lower()
    return _ALIASES.get(name, name), cfg


def _align_rank(fn: Callable) -> Callable:
    """Match Keras's implicit rank alignment: scalar-per-sample targets
    (``y_true [B]``) against a trailing-unit output (``y_pred [B, 1]``) get
    a trailing axis. Without this, elementwise losses would silently
    broadcast ``[B,1] - [B]`` to ``[B,B]``."""
    def aligned(y_true, y_pred):
        if y_true.dim() == y_pred.dim() - 1 and y_pred.shape[-1] == 1:
            y_true = y_true[..., None]
        elif y_true.dim() == y_pred.dim() + 1 and y_true.shape[-1] == 1:
            y_true = y_true[..., 0]
        return fn(y_true, y_pred)

    return aligned


def resolve_per_sample_loss(loss_spec) -> Callable:
    """Return ``fn(y_true, y_pred) -> [batch]`` per-sample losses.

    Accepts the specs Keras ``compile(loss=...)`` does, as strings, dicts
    or duck-typed objects. A loss the reference hands to Keras comes back
    as a :class:`KerasFallbackLoss`."""
    name, cfg = _loss_name_and_config(loss_spec)
    from_logits = bool(cfg.get("from_logits", False))

    if name in ("mean_squared_error",):
        return _align_rank(_mse)
    if name in ("mean_absolute_error",):
        return _align_rank(_mae)
    if name == "binary_crossentropy":
        return _align_rank(_binary_crossentropy(from_logits))
    if name == "categorical_crossentropy":
        return _categorical_crossentropy(from_logits)
    if name == "sparse_categorical_crossentropy":
        return _sparse_categorical_crossentropy(from_logits)
    if name == "hinge":
        return _align_rank(_hinge)
    if name in ("huber", "huber_loss"):
        return _align_rank(_huber(float(cfg.get("delta", 1.0))))
    return KerasFallbackLoss(loss_spec)


# -- Keras's own loss functions (what the reference's fall-back calls) --------
#
# Each follows ``keras/src/losses/losses.py`` of Keras 3.13 operation for
# operation, in ``y_pred``'s dtype, with Keras's epsilon (1e-7).


def _same_rank(a, b):
    """Keras's ``squeeze_or_expand_to_same_rank``: ranks one apart meet by
    expanding a rank-1 tensor or squeezing a trailing unit axis."""
    if a.dim() == b.dim() + 1 and a.shape[-1] == 1:
        if b.dim() == 1:
            b = b[..., None]
        else:
            a = a[..., 0]
    if b.dim() == a.dim() + 1 and b.shape[-1] == 1:
        if a.dim() == 1:
            a = a[..., None]
        else:
            b = b[..., 0]
    return a, b


def _cast(y_true, y_pred, same_rank=False):
    y_true = y_true.to(y_pred.dtype)
    return _same_rank(y_true, y_pred) if same_rank else (y_true, y_pred)


def _hinge_labels(y_true):
    """``{0, 1}`` labels to ``{-1, 1}``; any other labels as they are (a
    select on the device, as Keras's ``ops.cond``: no read back)."""
    is_binary = ((y_true == 0) | (y_true == 1)).all()
    return torch.where(is_binary, 2.0 * y_true - 1.0, y_true)


def _k_mse(y_true, y_pred):
    t, p = _cast(y_true, y_pred, True)
    return torch.square(t - p).mean(dim=-1)


def _k_mae(y_true, y_pred):
    t, p = _cast(y_true, y_pred, True)
    return torch.abs(t - p).mean(dim=-1)


def _k_mape(y_true, y_pred):
    t, p = _cast(y_true, y_pred, True)
    eps = torch.tensor(_EPS, dtype=p.dtype, device=p.device)
    return 100.0 * torch.abs((t - p) / torch.maximum(torch.abs(t), eps)).mean(dim=-1)


def _k_msle(y_true, y_pred):
    t, p = _cast(y_true, y_pred, True)
    eps = torch.tensor(_EPS, dtype=p.dtype, device=p.device)
    first = torch.log(torch.maximum(p, eps) + 1.0)
    second = torch.log(torch.maximum(t, eps) + 1.0)
    return torch.square(first - second).mean(dim=-1)


def _k_hinge(y_true, y_pred):
    t, p = _cast(y_true, y_pred)
    return torch.clamp(1.0 - _hinge_labels(t) * p, min=0.0).mean(dim=-1)


def _k_squared_hinge(y_true, y_pred):
    t, p = _cast(y_true, y_pred)
    return torch.square(torch.clamp(1.0 - _hinge_labels(t) * p, min=0.0)).mean(dim=-1)


def _k_categorical_hinge(y_true, y_pred):
    t, p = _cast(y_true, y_pred)
    pos = (t * p).sum(dim=-1)
    neg = ((1.0 - t) * p).amax(dim=-1)
    return torch.clamp(neg - pos + 1.0, min=0.0)


def _k_huber(y_true, y_pred, delta=1.0):
    t, p = _cast(y_true, y_pred, True)
    err = p - t
    a = torch.abs(err)
    d = torch.tensor(float(delta), dtype=p.dtype, device=p.device)
    return torch.where(a <= d, 0.5 * torch.square(err), d * a - 0.5 * torch.square(d)
                       ).mean(dim=-1)


def _k_log_cosh(y_true, y_pred):
    t, p = _cast(y_true, y_pred, True)
    x = p - t
    return (x + F.softplus(x * -2.0) - math.log(2.0)).mean(dim=-1)


def _k_kl_divergence(y_true, y_pred):
    t, p = _cast(y_true, y_pred)
    t, p = torch.clamp(t, _EPS, 1.0), torch.clamp(p, _EPS, 1.0)
    return (t * torch.log(t / p)).sum(dim=-1)


def _k_poisson(y_true, y_pred):
    t, p = _cast(y_true, y_pred)
    return (p - t * torch.log(p + _EPS)).mean(dim=-1)


def _l2_normalize(x, axis):
    inv = torch.rsqrt(torch.square(x).sum(dim=axis, keepdim=True))
    return x * torch.clamp(inv, max=1.0 / _EPS)


def _k_cosine_similarity(y_true, y_pred, axis=-1):
    t, p = _cast(y_true, y_pred, True)
    return -(_l2_normalize(t, axis) * _l2_normalize(p, axis)).sum(dim=axis)


def _bce_elems(t, p, from_logits):
    if from_logits:
        return -t * F.logsigmoid(p) - (1.0 - t) * F.logsigmoid(-p)
    p = torch.clamp(p, _EPS, 1.0 - _EPS)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def _k_binary_crossentropy(y_true, y_pred, from_logits=False, label_smoothing=0.0,
                           axis=-1):
    t, p = _cast(y_true, y_pred)
    if label_smoothing:
        t = t * (1.0 - label_smoothing) + 0.5 * label_smoothing
    return _bce_elems(t, p, from_logits).mean(dim=axis)


def _log_probs(p, from_logits, axis):
    if from_logits:
        return torch.log_softmax(p, dim=axis)
    p = p / p.sum(dim=axis, keepdim=True)
    return torch.log(torch.clamp(p, _EPS, 1.0 - _EPS))


def _k_categorical_crossentropy(y_true, y_pred, from_logits=False, label_smoothing=0.0,
                                axis=-1):
    t, p = _cast(y_true, y_pred)
    if label_smoothing:
        t = t * (1.0 - label_smoothing) + label_smoothing / t.shape[-1]
    return -(t * _log_probs(p, from_logits, axis)).sum(dim=axis)


def _k_sparse_categorical_crossentropy(y_true, y_pred, from_logits=False,
                                       ignore_class=None, axis=-1):
    if ignore_class is not None:
        raise NotImplementedError(f"sparse_categorical_crossentropy ignore_class="
                                  f"{ignore_class} waits for {LOSSES_ITEM}")
    t = y_true
    if t.dim() == y_pred.dim() and t.shape[-1] == 1:
        t = t[..., 0]
    logp = _log_probs(y_pred, from_logits, axis)
    return -torch.gather(logp, -1, t.to(torch.int64)[..., None])[..., 0]


def _k_binary_focal_crossentropy(y_true, y_pred, apply_class_balancing=False, alpha=0.25,
                                 gamma=2.0, from_logits=False, label_smoothing=0.0,
                                 axis=-1):
    t, p = _cast(y_true, y_pred)
    if label_smoothing:
        t = t * (1.0 - label_smoothing) + 0.5 * label_smoothing
    if from_logits:
        p = torch.sigmoid(p)
    bce = _bce_elems(t, p, False)
    p_t = t * p + (1 - t) * (1 - p)
    focal = torch.pow(1.0 - p_t, gamma) * bce
    if apply_class_balancing:
        focal = (t * alpha + (1 - t) * (1 - alpha)) * focal
    return focal.mean(dim=axis)


def _k_categorical_focal_crossentropy(y_true, y_pred, alpha=0.25, gamma=2.0,
                                      from_logits=False, label_smoothing=0.0, axis=-1):
    t, p = _cast(y_true, y_pred)
    if label_smoothing:
        t = t * (1.0 - label_smoothing) + label_smoothing / t.shape[-1]
    if from_logits:
        p = torch.softmax(p, dim=axis)
    out = torch.clamp(p / p.sum(dim=axis, keepdim=True), _EPS, 1.0 - _EPS)
    cce = -t * torch.log(out)
    return (torch.pow(1.0 - out, gamma) * alpha * cce).sum(dim=axis)


def _k_categorical_generalized_cross_entropy(y_true, y_pred, q):
    onehot = F.one_hot(y_true.to(torch.int64), y_pred.shape[-1]).to(y_pred.dtype)
    p = (y_pred * onehot).sum(dim=-1)
    return (1 - torch.pow(p, q)) / q


def _dims(x, axis):
    return tuple(range(x.dim())) if axis is None else axis


def _k_dice(y_true, y_pred, axis=None):
    t, p = _cast(y_true, y_pred)
    d = _dims(t, axis)
    inter = (t * p).sum(dim=d)
    return 1 - 2.0 * inter / (t.sum(dim=d) + p.sum(dim=d) + _EPS)


def _k_tversky(y_true, y_pred, alpha=0.5, beta=0.5, axis=None):
    t, p = _cast(y_true, y_pred)
    d = _dims(t, axis)
    inter = (t * p).sum(dim=d)
    fp = ((1 - p) * t).sum(dim=d)
    fn = (p * (1 - t)).sum(dim=d)
    return 1 - inter / (inter + fp * alpha + fn * beta + _EPS)


_LOG_EPSILON = -1e5        # the log of "impossible" in Keras's JAX ctc_loss


def _log_add(a, b):
    return torch.logaddexp(a, b)


def _k_ctc(y_true, y_pred):
    """Keras's ``ctc``: integer labels ``[B, max_len]`` (0 the blank and the
    padding; the label length the count of non-zero labels), logits ``[B,
    T, C]`` over every step, the loss per sample. Computed as Keras's JAX
    backend computes ``ops.ctc_loss`` (optax's forward recursion in log
    space, ``log_softmax`` in at least float32, ``-1e5`` for an impossible
    transition): a label sequence that no alignment of T steps can emit
    costs a large finite value, not ``inf``."""
    if y_true.dim() != 2:
        raise ValueError(f"Targets `y_true` are expected to be a tensor of shape "
                         f"`(batch_size, max_length)` in integer format. Received: "
                         f"y_true.shape={tuple(y_true.shape)}")
    if y_pred.dim() != 3:
        raise ValueError(f"Logits `y_pred` are expected to be a tensor of shape "
                         f"`(batch_size, max_length, num_classes)`. Received: "
                         f"y_pred.shape={tuple(y_pred.shape)}")
    target = y_true.to(torch.int64)
    B, T, C = y_pred.shape
    N = target.shape[1]
    label_len = (target != 0).sum(dim=-1)
    logp = torch.log_softmax(y_pred.to(torch.promote_types(y_pred.dtype, torch.float32)),
                             dim=-1)
    repeat = F.pad((target[:, :-1] == target[:, 1:]).to(logp.dtype), (0, 1))
    phi_step = logp[:, :, 0:1].transpose(0, 1)                              # [T, B, 1]
    emit_step = torch.einsum("btk,bnk->btn", logp,
                             F.one_hot(target, C).to(logp.dtype)).transpose(0, 1)
    phi = torch.full((B, N + 1), _LOG_EPSILON, dtype=logp.dtype, device=logp.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((B, N), _LOG_EPSILON, dtype=logp.dtype, device=logp.device)

    def add_to_phi(p, score):
        return torch.cat([p[:, :1], _log_add(p[:, 1:], score)], dim=1)

    for t in range(T):
        prev_phi = add_to_phi(phi, emit + _LOG_EPSILON * repeat)
        next_emit = _log_add(prev_phi[:, :-1] + emit_step[t], emit + emit_step[t])
        next_phi = add_to_phi(prev_phi + phi_step[t],
                              emit + phi_step[t] + _LOG_EPSILON * (1.0 - repeat))
        phi, emit = next_phi, next_emit
    last = add_to_phi(phi, emit)
    return -torch.gather(last, 1, label_len[:, None])[:, 0]


def _k_circle(y_true, y_pred, ref_labels=None, ref_embeddings=None, remove_diagonal=True,
              gamma=80, margin=0.4):
    """Keras's ``circle``: each row's loss over its pairs with every row of
    the batch (cosine distances of the embeddings, positives those of the
    same integer label, the row itself left out with ``remove_diagonal``).
    Its rows with a zero loss are masked out of a Loss object's reduction
    (:meth:`KerasFallbackLoss._value`)."""
    y = y_true.to(torch.int32).reshape(-1, 1)
    ref = y_pred if ref_embeddings is None else ref_embeddings
    ref_y = y if ref_labels is None else ref_labels.to(torch.int32).reshape(-1, 1)
    dist = torch.clamp(1 - y_pred @ ref.transpose(0, 1), min=0.0)
    pos = y == ref_y.transpose(0, 1)
    neg = ~pos
    if remove_diagonal:
        pos = pos & ~torch.eye(y.shape[0], ref_y.shape[0], dtype=torch.bool, device=y.device)
    pos_w = torch.clamp((margin + dist) * pos.to(dist.dtype), min=0.0)
    neg_w = torch.clamp((1 + margin - dist) * neg.to(dist.dtype), min=0.0)
    pos_d = -1 * gamma * pos_w * (margin - dist)
    neg_d = gamma * neg_w * ((1 - margin) - dist)
    inf = torch.tensor(float("-inf"), dtype=dist.dtype, device=dist.device)
    p_loss = torch.logsumexp(torch.where(pos, pos_d, inf), dim=1)
    n_loss = torch.logsumexp(torch.where(neg, neg_d, inf), dim=1)
    return F.softplus(p_loss + n_loss)


class _KerasLoss(NamedTuple):
    """One Keras loss: its function, the options its Loss class passes to
    the function, and that class's name."""
    fn: Callable
    options: Tuple[str, ...]
    cls: str


# the losses the reference hands to Keras, by Keras's function name
KERAS_LOSSES: Dict[str, _KerasLoss] = {
    "kl_divergence": _KerasLoss(_k_kl_divergence, (), "KLDivergence"),
    "poisson": _KerasLoss(_k_poisson, (), "Poisson"),
    "log_cosh": _KerasLoss(_k_log_cosh, (), "LogCosh"),
    "squared_hinge": _KerasLoss(_k_squared_hinge, (), "SquaredHinge"),
    "categorical_hinge": _KerasLoss(_k_categorical_hinge, (), "CategoricalHinge"),
    "cosine_similarity": _KerasLoss(_k_cosine_similarity, ("axis",), "CosineSimilarity"),
    "mean_absolute_percentage_error": _KerasLoss(_k_mape, (), "MeanAbsolutePercentageError"),
    "mean_squared_logarithmic_error": _KerasLoss(_k_msle, (), "MeanSquaredLogarithmicError"),
    "binary_focal_crossentropy": _KerasLoss(
        _k_binary_focal_crossentropy, ("apply_class_balancing", "alpha", "gamma",
                                       "from_logits", "label_smoothing", "axis"),
        "BinaryFocalCrossentropy"),
    "categorical_focal_crossentropy": _KerasLoss(
        _k_categorical_focal_crossentropy, ("alpha", "gamma", "from_logits",
                                            "label_smoothing", "axis"),
        "CategoricalFocalCrossentropy"),
    "categorical_generalized_cross_entropy": _KerasLoss(
        _k_categorical_generalized_cross_entropy, ("q",),
        "CategoricalGeneralizedCrossEntropy"),
    "dice": _KerasLoss(_k_dice, ("axis",), "Dice"),
    "tversky": _KerasLoss(_k_tversky, ("alpha", "beta", "axis"), "Tversky"),
    "ctc": _KerasLoss(_k_ctc, (), "CTC"),
    "circle": _KerasLoss(_k_circle, ("gamma", "margin", "remove_diagonal"), "Circle"),
}
# Keras's names for them: its aliases and the Loss classes
_LOSS_NAMES = {**{k: k for k in KERAS_LOSSES}, "kld": "kl_divergence",
               "mape": "mean_absolute_percentage_error",
               "msle": "mean_squared_logarithmic_error",
               **{v.cls: k for k, v in KERAS_LOSSES.items()}}

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.float16, "mixed_bfloat16": torch.bfloat16,
                   "mixed_float16": torch.float16}


def _config_dtype(spec) -> torch.dtype:
    """A Loss config's ``dtype`` (a name or a serialized policy), float32
    when absent, as Keras's ``backend.floatx()``."""
    if isinstance(spec, dict) and "config" in spec and isinstance(spec["config"], dict):
        dt = spec["config"].get("dtype")
    elif isinstance(spec, dict):
        dt = spec.get("dtype")
    else:
        dt = getattr(spec, "dtype", None)
    if isinstance(dt, dict):
        dt = (dt.get("config") or {}).get("name")
    dt = None if dt is None else str(dt)
    if dt is not None and dt not in _COMPUTE_DTYPES:
        raise NotImplementedError(f"loss dtype {dt!r} waits for {LOSSES_ITEM}")
    return _COMPUTE_DTYPES.get(dt, torch.float32)


def _loss_form(loss_spec) -> Tuple[str, bool, dict]:
    """``(Keras function name, object form?, config)`` of a spec the
    reference hands to Keras. A string or a serialized function is the
    function form; a serialized Loss or a loss object, the object form."""
    if isinstance(loss_spec, str):
        key, cfg, is_object = loss_spec, {}, False
    elif isinstance(loss_spec, dict) and loss_spec.get("class_name") == "function":
        key, cfg, is_object = str(loss_spec.get("config")), {}, False
    elif isinstance(loss_spec, dict):
        key = str(loss_spec.get("class_name", ""))
        cfg = dict(loss_spec.get("config") or {})
        is_object = True
    elif callable(loss_spec) and not hasattr(loss_spec, "get_config"):
        key, cfg, is_object = getattr(loss_spec, "__name__", ""), {}, False
    else:
        key = type(loss_spec).__name__
        try:
            cfg = dict(loss_spec.get_config() or {})
        except Exception:
            cfg = {}
        if key not in _LOSS_NAMES:
            key = str(cfg.get("name") or getattr(loss_spec, "name", key))
        is_object = True
    name = _LOSS_NAMES.get(key, _LOSS_NAMES.get(key.lower()))
    if name is None:
        raise NotImplementedError(
            f"loss {key!r} is not one the port implements (the reference's seven "
            f"and Keras's {sorted(KERAS_LOSSES)}); it waits for {LOSSES_ITEM}")
    if not is_object and name == "categorical_generalized_cross_entropy":
        # Keras 3.13 registers the class only: keras.losses.get refuses the name
        raise ValueError(f"Could not interpret loss identifier: {key}")
    return name, is_object, cfg


# the functions whose values couple a batch's rows (``dice`` and ``tversky``
# sum over every axis, ``circle`` pairs the rows): each replica's batch apart
_PER_REPLICA = ("dice", "tversky", "circle")
_REDUCTIONS = (None, "none", "sum", "sum_over_batch_size", "mean", "mean_with_sample_weight")


class KerasFallbackLoss:
    """A loss the reference hands to Keras, as its fall-back computes it
    (see the module docstring): ``self(y_true, y_pred)`` gives ``[B]``
    over one replica's rows; :meth:`grouped` gives ``[L, B]`` over a
    replica stack ``[L, B, ...]``, each replica's scalar its own."""

    def __init__(self, loss_spec):
        self.name, self.object_form, cfg = _loss_form(loss_spec)
        entry = KERAS_LOSSES[self.name]
        self.fn = entry.fn
        self.kwargs = {k: cfg[k] for k in entry.options if k in cfg}
        if self.name == "categorical_generalized_cross_entropy":
            self.kwargs.setdefault("q", 0.5)          # the class's default
        self.reduction = cfg.get("reduction", "sum_over_batch_size")
        if self.reduction not in _REDUCTIONS:
            raise ValueError(f"loss {self.name!r}: reduction {self.reduction!r}")
        self.dtype = _config_dtype(loss_spec) if self.object_form else None

    def _value(self, y_true, y_pred):
        """What ``keras.losses.get(spec)(y_true, y_pred)`` returns."""
        if not self.object_form:
            return self.fn(y_true, y_pred, **self.kwargs)
        t, p = _same_rank(y_true.to(self.dtype), y_pred.to(self.dtype))
        values = self.fn(t, p, **self.kwargs)
        if self.name == "circle":
            # circle masks its zero losses; Keras's Loss weights the others
            # total / valid under a mean (apply_mask), by the mask otherwise
            mask = (values > 0).to(values.dtype)
            if self.reduction in ("sum_over_batch_size", "mean"):
                valid = mask.sum()
                mask = mask * torch.where(valid == 0, torch.zeros_like(valid),
                                          values.numel() / valid)
            values = values * mask
            if self.reduction == "mean_with_sample_weight":
                return values.sum() / mask.sum()
        if self.reduction in (None, "none") or values.dim() == 0 or values.numel() == 0:
            return values
        total = values.sum()
        return total if self.reduction == "sum" else total / values.numel()

    def __call__(self, y_true, y_pred):
        val = self._value(y_true, y_pred)
        B = y_pred.shape[0]
        if val.dim() == 0:
            return val.expand(B)
        return val.reshape(B, -1).mean(dim=-1)

    def grouped(self, y_true, y_pred):
        L, B = y_pred.shape[:2]
        if not self.object_form and self.name not in _PER_REPLICA:
            # per-row values: one call over every replica's rows
            flat = self(y_true.reshape((L * B,) + tuple(y_true.shape[2:])),
                        y_pred.reshape((L * B,) + tuple(y_pred.shape[2:])))
            return flat.reshape(L, B)
        return torch.stack([self(y_true[l], y_pred[l]) for l in range(L)])


# -- metrics -----------------------------------------------------------------


def resolve_accuracy(loss_spec) -> Callable:
    """Per-sample accuracy matched to the loss family (Keras's 'accuracy'
    resolution): sparse, binary, and categorical (the default)."""
    name, _ = _loss_name_and_config(loss_spec)

    if name == "sparse_categorical_crossentropy":

        def acc(y_true, y_pred):
            labels = y_true.reshape(y_pred.shape[:-1]).to(torch.int64)
            return (torch.argmax(y_pred, dim=-1) == labels).to(torch.float32)

        return acc
    if name == "binary_crossentropy":

        def acc(y_true, y_pred):
            yt = y_true.reshape(y_pred.shape)
            pred = (y_pred > 0.5).to(y_pred.dtype)
            per = (pred == yt.to(y_pred.dtype)).to(torch.float32)
            return per.reshape(per.shape[0], -1).mean(dim=-1)

        return acc

    def acc(y_true, y_pred):  # categorical / default
        hit = (torch.argmax(y_pred, dim=-1) == torch.argmax(y_true, dim=-1))
        return hit.to(torch.float32).reshape(y_pred.shape[0], -1).mean(dim=-1)

    return acc


# -- Keras's metric functions (what compile(metrics=...) resolves) ------------


def _k_binary_accuracy(y_true, y_pred, threshold=0.5):
    t, p = _same_rank(y_true, y_pred)
    return (t == (p > threshold).to(t.dtype)).to(torch.float32)


def _k_categorical_accuracy(y_true, y_pred):
    return (torch.argmax(y_true, dim=-1) == torch.argmax(y_pred, dim=-1)).to(torch.float32)


def _k_sparse_categorical_accuracy(y_true, y_pred):
    t = y_true
    if t.dim() == y_pred.dim() and t.shape[-1] == 1:
        t = t[..., 0]
    hit = (t.to(y_pred.dtype) == torch.argmax(y_pred, dim=-1).to(y_pred.dtype))
    return hit.to(torch.float32)


def _in_top_k(targets, predictions, k):
    """Keras's ``in_top_k``: the target's rank, 1 plus the count of larger
    predictions (a NaN target counts as -inf), at most ``k``."""
    at = torch.gather(predictions, -1, targets[..., None])
    at = torch.where(torch.isnan(at), torch.full_like(at, float("-inf")), at)
    return (1 + (predictions > at).sum(dim=-1)) <= k


def _k_top_k_categorical_accuracy(y_true, y_pred, k=5):
    shape = y_true.shape[:-1]
    t = torch.argmax(y_true, dim=-1).reshape(-1)
    p = y_pred.reshape(-1, y_pred.shape[-1])
    return _in_top_k(t, p, int(k)).to(torch.float32).reshape(shape)


def _k_sparse_top_k_categorical_accuracy(y_true, y_pred, k=5, from_sorted_ids=False):
    shape = y_true.shape
    p = y_pred.reshape(-1, y_pred.shape[-1])
    if from_sorted_ids:
        t = y_true.to(y_pred.dtype).reshape(-1)
        hit = (t[:, None] == p[:, :int(k)]).any(dim=1)
    else:
        hit = _in_top_k(y_true.to(torch.int32).to(torch.int64).reshape(-1), p, int(k))
    return hit.to(torch.float32).reshape(shape)


def _k_accuracy(y_true, y_pred):
    t, p = _same_rank(y_true, y_pred)
    return (t == p.to(t.dtype)).to(torch.float32)


def _k_cosine_similarity_metric(y_true, y_pred, axis=-1):
    return -_k_cosine_similarity(y_true, y_pred, axis)


def _k_pearson_correlation(y_true, y_pred, axis=-1):
    t, p = _cast(y_true, y_pred, True)
    tn = t - t.mean(dim=axis, keepdim=True)
    pn = p - p.mean(dim=axis, keepdim=True)
    tn = tn / tn.std(dim=axis, keepdim=True, correction=0)
    pn = pn / pn.std(dim=axis, keepdim=True, correction=0)
    return (tn * pn).mean(dim=axis)


def _k_concordance_correlation(y_true, y_pred, axis=-1):
    t, p = _cast(y_true, y_pred, True)
    tm, pm = t.mean(dim=axis, keepdim=True), p.mean(dim=axis, keepdim=True)
    tv = (t - tm).to(torch.float32).var(dim=axis, keepdim=True, correction=0).to(t.dtype)
    pv = (p - pm).to(torch.float32).var(dim=axis, keepdim=True, correction=0).to(p.dtype)
    covar = (t - pm) * (p - pm)
    norm = tv + pv + torch.square(tm - pm)
    return (2 * covar / (norm + _EPS)).mean(dim=axis)


class _KerasMetric(NamedTuple):
    """One mean metric: its function, the options its class passes to it,
    and that class's name (None for a function without a class)."""
    fn: Callable
    options: Tuple[str, ...]
    cls: Optional[str]


# every function of keras.metrics (Keras 3.13), by name
KERAS_METRICS: Dict[str, _KerasMetric] = {
    "binary_accuracy": _KerasMetric(_k_binary_accuracy, ("threshold",), "BinaryAccuracy"),
    "categorical_accuracy": _KerasMetric(_k_categorical_accuracy, (), "CategoricalAccuracy"),
    "sparse_categorical_accuracy": _KerasMetric(_k_sparse_categorical_accuracy, (),
                                                "SparseCategoricalAccuracy"),
    "top_k_categorical_accuracy": _KerasMetric(_k_top_k_categorical_accuracy, ("k",),
                                               "TopKCategoricalAccuracy"),
    "sparse_top_k_categorical_accuracy": _KerasMetric(
        _k_sparse_top_k_categorical_accuracy, ("k", "from_sorted_ids"),
        "SparseTopKCategoricalAccuracy"),
    "binary_crossentropy": _KerasMetric(_k_binary_crossentropy,
                                        ("from_logits", "label_smoothing"),
                                        "BinaryCrossentropy"),
    "categorical_crossentropy": _KerasMetric(_k_categorical_crossentropy,
                                             ("from_logits", "label_smoothing", "axis"),
                                             "CategoricalCrossentropy"),
    "sparse_categorical_crossentropy": _KerasMetric(_k_sparse_categorical_crossentropy,
                                                    ("from_logits", "axis"),
                                                    "SparseCategoricalCrossentropy"),
    "binary_focal_crossentropy": _KerasMetric(_k_binary_focal_crossentropy, (), None),
    "categorical_focal_crossentropy": _KerasMetric(_k_categorical_focal_crossentropy, (),
                                                   None),
    "hinge": _KerasMetric(_k_hinge, (), "Hinge"),
    "squared_hinge": _KerasMetric(_k_squared_hinge, (), "SquaredHinge"),
    "categorical_hinge": _KerasMetric(_k_categorical_hinge, (), "CategoricalHinge"),
    "huber": _KerasMetric(_k_huber, (), None),
    "kl_divergence": _KerasMetric(_k_kl_divergence, (), "KLDivergence"),
    "log_cosh": _KerasMetric(_k_log_cosh, (), "LogCoshError"),
    "mean_absolute_error": _KerasMetric(_k_mae, (), "MeanAbsoluteError"),
    "mean_absolute_percentage_error": _KerasMetric(_k_mape, (),
                                                   "MeanAbsolutePercentageError"),
    "mean_squared_error": _KerasMetric(_k_mse, (), "MeanSquaredError"),
    "mean_squared_logarithmic_error": _KerasMetric(_k_msle, (),
                                                   "MeanSquaredLogarithmicError"),
    "poisson": _KerasMetric(_k_poisson, (), "Poisson"),
    "pearson_correlation": _KerasMetric(_k_pearson_correlation, ("axis",),
                                        "PearsonCorrelation"),
    "concordance_correlation": _KerasMetric(_k_concordance_correlation, ("axis",),
                                            "ConcordanceCorrelation"),
}
# the classes without a function of keras.metrics
_METRIC_CLASSES_ONLY = {
    "Accuracy": _KerasMetric(_k_accuracy, (), "Accuracy"),
    "CosineSimilarity": _KerasMetric(_k_cosine_similarity_metric, ("axis",),
                                     "CosineSimilarity"),
}
_METRIC_ALIASES = {"mae": "mean_absolute_error", "mse": "mean_squared_error",
                   "mape": "mean_absolute_percentage_error",
                   "msle": "mean_squared_logarithmic_error", "bce": "binary_crossentropy"}
_METRIC_BY_CLASS = {**{m.cls: m for m in KERAS_METRICS.values() if m.cls},
                    **_METRIC_CLASSES_ONLY}


def _snake_class(cls: str) -> str:
    """Keras's ``to_snake_case`` (``KLDivergence`` → ``kl_divergence``)."""
    name = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", re.sub(r"\W+", "", cls))
    return re.sub(r"([a-z])([A-Z])", r"\1_\2", name).lower()


_STATEFUL_BY_SNAKE = {_snake_class(c): c for c in STATEFUL_METRICS}


def _metric_entry(key: str, function: bool) -> Optional[_KerasMetric]:
    """A metric by Keras's names: a function by its name; a string as
    ``keras.metrics.get`` resolves it, by a class's name, its snake-case
    name or an alias (a function without a class is no such name)."""
    if function:
        return KERAS_METRICS.get(key)
    if key in _METRIC_BY_CLASS:
        return _METRIC_BY_CLASS[key]
    low = _METRIC_ALIASES.get(key.lower(), key)
    by_snake = {_snake_class(c): m for c, m in _METRIC_BY_CLASS.items()}
    return by_snake.get(low)


def metric_name(spec) -> str:
    """The name Keras logs a compiled metric under: a string as given, a
    serialized metric or a metric object by its config's ``name``."""
    if isinstance(spec, str):
        return spec
    if isinstance(spec, dict):
        cfg = spec.get("config")
        if isinstance(cfg, str):                # a serialized function
            return cfg
        return str((cfg or {}).get("name", spec.get("class_name")))
    return str(getattr(spec, "name", getattr(spec, "__name__", spec)))


def _accuracy_by_shape(y_true, y_pred):
    """Keras's ``"accuracy"``: binary when ``y_pred`` has one column, sparse
    when ``y_true`` has fewer axes or one column against several, else
    categorical."""
    if y_pred.shape[-1] == 1:
        return _k_binary_accuracy(y_true, y_pred)
    if y_true.dim() < y_pred.dim() or (y_true.shape[-1] == 1 and y_pred.shape[-1] > 1):
        return _k_sparse_categorical_accuracy(y_true, y_pred)
    return _k_categorical_accuracy(y_true, y_pred)


def resolve_metric(spec) -> Tuple[str, Callable]:
    """``(name, fn)`` of a compiled metric as Keras resolves it: ``fn(y_true,
    y_pred)`` gives the values Keras's ``MeanMetricWrapper`` averages (see
    :func:`metric_sums`), or, for a stateful class, ``fn`` is a
    :class:`~.stateful_metrics.StatefulMetric` (:func:`metric_state`,
    :func:`metric_result` read either kind). Raises
    :class:`NotImplementedError` for any other metric."""
    name = metric_name(spec)
    if isinstance(spec, str) and spec.lower() in ("accuracy", "acc"):
        return name, _accuracy_by_shape
    cfg: dict = {}
    function = False
    if isinstance(spec, str):
        key = spec
    elif isinstance(spec, dict):
        key = str(spec.get("class_name", ""))
        if key == "function":
            key, function = str(spec.get("config")), True
        else:
            cfg = dict(spec.get("config") or {})
    elif callable(spec) and not hasattr(spec, "get_config"):
        key, function = getattr(spec, "__name__", ""), True
    else:
        key = type(spec).__name__
        try:
            cfg = dict(spec.get_config() or {})
        except Exception:
            cfg = {}
    stateful = key if key in STATEFUL_METRICS else _STATEFUL_BY_SNAKE.get(key.lower())
    if stateful is not None and not function:
        # a class keeps the compiled name (a string's own, a config's name)
        if isinstance(spec, str):
            cfg = dict(cfg, name=name)
        return name, build_stateful(stateful, cfg)
    entry = _metric_entry(key, function)
    if entry is None and isinstance(spec, str) and key in KERAS_METRICS:
        # a function of keras.metrics without a class: Keras resolves it
        # from the function, not from its name
        raise ValueError(f"Could not interpret metric identifier: {key}")
    if entry is None:
        raise NotImplementedError(
            f"metric {key!r} is not one the port computes (the mean metrics of "
            f"keras.metrics and the stateful classes {sorted(STATEFUL_METRICS)}); it waits "
            f"for {METRICS_ITEM}")
    kwargs = {k: cfg[k] for k in entry.options if k in cfg}

    def fn(y_true, y_pred):
        return entry.fn(y_true, y_pred, **kwargs)

    return name, fn


def metric_sums(values, mask=None) -> Tuple[torch.Tensor, Any]:
    """``(sum, count)`` that Keras's ``Mean`` adds for one batch's metric
    values: float32, each sample's values averaged over their other axes;
    a single value counts as one sample. With ``mask`` (the output's mask,
    the values' leading axes) it is ``MeanMetricWrapper``'s sample weight:
    each sample adds the mean of its masked values and counts the mean of
    its mask."""
    values = values.to(torch.float32)
    if mask is not None:
        w = mask.to(torch.float32)
        while w.dim() < values.dim():
            w = w[..., None]
        w = torch.broadcast_to(w, values.shape) if w.dim() == values.dim() else w
        v = (values * w).reshape(values.shape[0], -1).mean(dim=-1)
        return v.sum(), w.reshape(values.shape[0], -1).mean(dim=-1).sum()
    if values.dim() == 0:
        return values, 1
    if values.dim() > 1:
        values = values.reshape(values.shape[0], -1).mean(dim=-1)
    return values.sum(), int(values.shape[0])


def metric_state(fn, y_true, y_pred, mask=None) -> torch.Tensor:
    """One batch's state of a resolved metric (:func:`resolve_metric`), a
    float32 vector on ``y_pred``'s device: a stateful class's own, a mean
    metric's ``[sum, count]``."""
    if isinstance(fn, StatefulMetric):
        return fn.update(y_true, y_pred)
    total, count = metric_sums(fn(y_true, y_pred), mask)
    count = torch.as_tensor(count, dtype=torch.float32, device=y_pred.device)
    return torch.stack([total.to(y_pred.device), count])


def metric_state_size(fn) -> Optional[int]:
    """The length of a resolved metric's state (None for a stateful class
    that has not seen a batch yet)."""
    return fn.size if isinstance(fn, StatefulMetric) else 2


def metric_result(fn, state: torch.Tensor) -> torch.Tensor:
    """A resolved metric's result from its summed state: Keras's
    ``result()``; a mean metric's ``sum / count`` (0 for no count)."""
    if isinstance(fn, StatefulMetric):
        return fn.result(state)
    return torch.where(state[1] == 0, torch.zeros_like(state[0]),
                       state[0] / torch.where(state[1] == 0, torch.ones_like(state[1]),
                                              state[1]))


def metric_results(fns, states: torch.Tensor) -> list:
    """Each metric's result from their states, concatenated in order."""
    out, at = [], 0
    for fn in fns:
        n = metric_state_size(fn)
        out.append(metric_result(fn, states[at:at + n]))
        at += n
    return out
