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
the fused loss of ``ops/fused_xent.py`` (K1 on a CUDA tensor). A loss this
module does not name raises :class:`NotImplementedError`: the reference
falls back to calling the Keras loss object, and there is no Keras here.
"""

from __future__ import annotations

import re
from typing import Callable, Tuple

import torch

from ..ops.fused_xent import categorical_crossentropy_from_logits

_EPS = 1e-7


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
    or duck-typed objects."""
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
    raise NotImplementedError(
        f"loss {name!r}: the reference calls the Keras loss object for losses it "
        f"does not implement, and the port runs without Keras; implemented: "
        f"mean_squared_error, mean_absolute_error, binary_crossentropy, "
        f"categorical_crossentropy, sparse_categorical_crossentropy, hinge, huber")


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
