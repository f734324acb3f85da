"""Keras 3.13's stateful metric classes, as the reference's Keras computes
them where it hands the work to Keras (``SparkModel.evaluate``'s fall-back,
the host path's ``model.fit`` histories).

A Keras metric of this kind keeps state across batches and turns it into a
result at the end: AUC four counts at each of its thresholds, Precision two,
R2Score five sums a column, the IoU family a confusion matrix. Here each
metric is a :class:`StatefulMetric`: :meth:`~StatefulMetric.update` gives
one batch's state as a float32 vector on the batch's device (the states
add up: the caller sums them over the batches of an epoch or an evaluate,
on the device, and reads the sum once), :meth:`~StatefulMetric.result`
turns a summed state into Keras's result (a scalar, or a vector where Keras
returns one: ``F1Score(average=None)``, a list of thresholds). Keras
resets the state at each epoch and each evaluate; so does the caller, by
starting a new sum.

The counts follow ``keras/src/metrics/metrics_utils.py``: thresholds that
Keras finds evenly spaced take its bucket route (``ceil(p * (n - 1)) - 1``,
a segment sum, a reversed cumulative sum), any others a comparison at each
threshold; with no sample weights every count is an integer and both
routes give Keras's exact counts. The Mean metrics of ``keras.metrics``
(:mod:`.losses`) are the other kind, a sum and a count.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

_EPS = 1e-7            # Keras's backend.epsilon()
_NEG_INF = -1e10       # metrics_utils.NEG_INF


def _div_no_nan(a, b):
    """``ops.divide_no_nan``: 0 where the divisor is 0."""
    return torch.where(b == 0, torch.zeros_like(a), a / torch.where(b == 0,
                                                                      torch.ones_like(b), b))


def _same_rank(a, b):
    """Keras's ``squeeze_or_expand_to_same_rank``."""
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


def _evenly(thresholds: Sequence[float]) -> bool:
    """``metrics_utils.is_evenly_distributed_thresholds``."""
    n = len(thresholds)
    if n < 3:
        return False
    even = np.arange(n, dtype=np.float32) / (n - 1)
    return bool(np.allclose(thresholds, even, atol=_EPS))


def _filter_top_k(x, k: int):
    """The top ``k`` values of the last axis kept, the others ``NEG_INF``."""
    idx = torch.topk(x, int(k), dim=-1).indices
    keep = torch.zeros_like(x).scatter_(-1, idx, 1.0)
    return x * keep + _NEG_INF * (1 - keep)


def confusion_counts(y_true, y_pred, thresholds: Sequence[float], evenly: bool,
                     top_k: Optional[int] = None, class_id: Optional[int] = None,
                     multi_label: bool = False, label_weights=None) -> Dict[str, torch.Tensor]:
    """``{"tp", "fp", "tn", "fn"}`` of one batch at each threshold, as
    ``metrics_utils.update_confusion_matrix_variables`` adds them (no sample
    weights): ``[n]``, or ``[n, labels]`` with ``multi_label``."""
    t = y_true.to(torch.float32)
    p = y_pred.to(torch.float32)
    p, t = _same_rank(p, t)
    if top_k is not None:
        p = _filter_top_k(p, top_k)
    if class_id is not None:
        if p.dim() == 1:
            raise ValueError("When class_id is provided, y_pred must be a 2D array with "
                             f"shape (num_samples, num_classes), found shape: {tuple(p.shape)}")
        t, p = t[..., class_id, None], p[..., class_id, None]
    n = len(thresholds)
    lw = None
    if label_weights is not None and not multi_label:
        lw = torch.as_tensor(np.asarray(label_weights, np.float32), device=p.device)
        lw = torch.broadcast_to(lw[None], p.shape)
    if evenly:
        with_eps = thresholds[0] < 0.0 or thresholds[-1] > 1.0
        w = torch.ones_like(p) if lw is None else lw
        p = torch.clamp(p, 0.0, 1.0)
        t = (t != 0).to(torch.float32)
        if not multi_label:
            t, p, w = t.reshape(-1), p.reshape(-1), w.reshape(-1)
        true_l, false_l = t * w, (1.0 - t) * w
        bucket = torch.ceil(p * (n - 1.0)) - 1
        if with_eps:
            bucket = torch.relu(bucket)
        bucket = bucket.to(torch.int64)
        # segment_sum drops the ids outside [0, n) (a prediction of 0)
        valid = (bucket >= 0) & (bucket < n)
        bucket = torch.where(valid, bucket, torch.zeros_like(bucket))

        def counts(labels):
            labels = torch.where(valid, labels, torch.zeros_like(labels))
            out = labels.new_zeros((n,) + tuple(labels.shape[1:]))
            out.scatter_add_(0, bucket, labels)
            return torch.flip(torch.cumsum(torch.flip(out, [0]), dim=0), [0])

        tp, fp = counts(true_l), counts(false_l)
        return {"tp": tp, "fp": fp, "tn": false_l.sum(dim=0) - fp,
                "fn": true_l.sum(dim=0) - tp}
    thr = torch.tensor(list(thresholds), dtype=torch.float32, device=p.device)
    label = t != 0
    if multi_label:
        pos = p[None] > thr[:, None, None]              # [n, N, labels]
        lab = label[None].expand(pos.shape)
    else:
        pos = p.reshape(1, -1) > thr[:, None]           # [n, N * labels]
        lab = label.reshape(1, -1).expand(pos.shape)
    wt = None if lw is None else lw.reshape(1, -1).expand(pos.shape)

    def count(a, b):
        v = (a & b).to(torch.float32)
        return (v if wt is None else v * wt).sum(dim=1)

    return {"tp": count(lab, pos), "fp": count(~lab, pos), "tn": count(~lab, ~pos),
            "fn": count(lab, ~pos)}


def _parse_thresholds(thresholds, default: float) -> List[float]:
    """``metrics_utils.parse_init_thresholds``: a value or a list in
    ``[0, 1]``, the default when None."""
    if thresholds is None:
        return [float(default)]
    values = [float(v) for v in (thresholds if isinstance(thresholds, (list, tuple))
                                 else [thresholds])]
    for v in values:
        if not 0.0 <= v <= 1.0:
            raise ValueError(f"Threshold values must be in [0, 1]. Received: {values}")
    return values


class StatefulMetric:
    """One Keras stateful metric: :meth:`update` gives a batch's state (a
    float32 vector of ``size``; a metric whose state depends on the data's
    width learns it at its first update), :meth:`result` Keras's result
    from a summed state."""
    size: Optional[int] = None

    def __init__(self, name: str):
        self.name = name

    def _state(self, y_true, y_pred) -> torch.Tensor:
        raise NotImplementedError

    def update(self, y_true, y_pred) -> torch.Tensor:
        state = self._state(y_true, y_pred).to(torch.float32).reshape(-1)
        if self.size is None:
            self.size = int(state.numel())
        elif state.numel() != self.size:
            raise ValueError(f"metric {self.name!r}: a batch's state has {state.numel()} "
                             f"values, the first had {self.size}")
        return state

    def result(self, state: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class _Counts(StatefulMetric):
    """TruePositives, FalsePositives, TrueNegatives and FalseNegatives: one
    count at each threshold (0.5 by default)."""

    def __init__(self, name, which: str, thresholds=None):
        super().__init__(name)
        self.which = which
        self.thresholds = _parse_thresholds(thresholds, 0.5)
        self.evenly = _evenly(self.thresholds)

    def _state(self, y_true, y_pred):
        return confusion_counts(y_true, y_pred, self.thresholds, self.evenly)[self.which]

    def result(self, state):
        return state[0] if len(self.thresholds) == 1 else state


class _PrecisionRecall(StatefulMetric):
    """Precision (``tp / (tp + fp)``) and Recall (``tp / (tp + fn)``) at each
    threshold (0.5, or with ``top_k`` ``NEG_INF`` over the top k), over one
    class with ``class_id``."""

    def __init__(self, name, other: str, thresholds=None, top_k=None, class_id=None):
        super().__init__(name)
        self.other, self.top_k, self.class_id = other, top_k, class_id
        self.thresholds = _parse_thresholds(thresholds, 0.5 if top_k is None else _NEG_INF)
        self.evenly = _evenly(self.thresholds)

    def _state(self, y_true, y_pred):
        c = confusion_counts(y_true, y_pred, self.thresholds, self.evenly, self.top_k,
                             self.class_id)
        return torch.cat([c["tp"], c[self.other]])

    def result(self, state):
        tp, other = state.reshape(2, -1)
        out = _div_no_nan(tp, tp + other)
        return out[0] if len(self.thresholds) == 1 else out


class _AtConstraint(StatefulMetric):
    """SensitivityAtSpecificity, SpecificityAtSensitivity, PrecisionAtRecall
    and RecallAtPrecision: four counts at ``num_thresholds`` thresholds from
    0 to 1, the best ``dependent`` where ``constrained >= value``."""

    def __init__(self, name, kind: str, value: float, num_thresholds=200, class_id=None):
        super().__init__(name)
        if num_thresholds <= 0:
            raise ValueError(f"Argument `num_thresholds` must be an integer > 0. "
                             f"Received: num_thresholds={num_thresholds}")
        if not 0.0 <= float(value) <= 1.0:
            raise ValueError(f"{kind}: the constraint must be in the range [0, 1], "
                             f"got {value}")
        self.kind, self.value, self.class_id = kind, float(value), class_id
        n = int(num_thresholds)
        if n == 1:
            self.thresholds, self.evenly = [0.5], False
        else:
            self.thresholds = [0.0] + [(i + 1) * 1.0 / (n - 1) for i in range(n - 2)] + [1.0]
            self.evenly = True

    def _state(self, y_true, y_pred):
        c = confusion_counts(y_true, y_pred, self.thresholds, self.evenly,
                             class_id=self.class_id)
        return torch.cat([c["tp"], c["fp"], c["tn"], c["fn"]])

    def result(self, state):
        tp, fp, tn, fn = state.reshape(4, -1)
        sens = _div_no_nan(tp, tp + fn)             # recall
        spec = _div_no_nan(tn, tn + fp)
        prec = _div_no_nan(tp, tp + fp)
        constrained, dependent = {
            "SensitivityAtSpecificity": (spec, sens), "SpecificityAtSensitivity": (sens, spec),
            "PrecisionAtRecall": (sens, prec), "RecallAtPrecision": (prec, sens)}[self.kind]
        feasible = (constrained >= self.value).to(dependent.dtype)
        return torch.clamp(torch.max(dependent * feasible), min=0.0)


class _AUC(StatefulMetric):
    """AUC: four counts at each of ``num_thresholds`` thresholds (``-eps``,
    the evenly spaced ones, ``1 + eps``; or ``thresholds`` between them),
    per label with ``multi_label``; ROC, PR or PRGAIN by interpolation,
    minoring or majoring, PR's interpolation by Keras's closed form
    (``interpolate_pr_auc``)."""

    def __init__(self, name, num_thresholds=200, curve="ROC",
                 summation_method="interpolation", thresholds=None, multi_label=False,
                 num_labels=None, label_weights=None, from_logits=False):
        super().__init__(name)
        if thresholds is not None:
            inner = sorted(float(v) for v in thresholds)
            self.num_thresholds = len(inner) + 2
            self.evenly = _evenly(np.array([0.0] + inner + [1.0]))
        else:
            if num_thresholds <= 1:
                raise ValueError(f"Argument `num_thresholds` must be an integer > 1. "
                                 f"Received: num_thresholds={num_thresholds}")
            self.num_thresholds = int(num_thresholds)
            inner = [(i + 1) * 1.0 / (self.num_thresholds - 1)
                     for i in range(self.num_thresholds - 2)]
            self.evenly = True
        self.thresholds = [0.0 - _EPS] + inner + [1.0 + _EPS]
        self.curve = str(curve).upper().replace("_", "")
        if self.curve not in ("ROC", "PR", "PRGAIN"):
            raise ValueError(f"Invalid AUC curve value {curve!r}")
        self.summation = str(summation_method).lower()
        if self.summation not in ("interpolation", "minoring", "majoring"):
            raise ValueError(f"Invalid AUC summation_method value {summation_method!r}")
        self.multi_label, self.from_logits = bool(multi_label), bool(from_logits)
        if num_labels and not self.multi_label:
            raise ValueError("`num_labels` is needed only when `multi_label` is True.")
        if isinstance(label_weights, dict):          # a serialized array
            label_weights = (label_weights.get("config") or {}).get("value")
        self.label_weights = None if label_weights is None else np.asarray(label_weights,
                                                                          np.float32)

    def _state(self, y_true, y_pred):
        p = y_pred.to(torch.float32)
        if self.multi_label and p.dim() != 2:
            raise ValueError(f"`y_pred` must have rank 2 when `multi_label=True`. Found "
                             f"rank {p.dim()}.")
        if self.from_logits:
            p = torch.sigmoid(p)
        c = confusion_counts(y_true, p, self.thresholds, self.evenly,
                             multi_label=self.multi_label,
                             label_weights=None if self.multi_label else self.label_weights)
        return torch.stack([c["tp"], c["fp"], c["tn"], c["fn"]])

    def _by_label(self, values):
        """Sum over the thresholds' terms; a multi-label mean (weighted)."""
        if not self.multi_label:
            return values.sum()
        by_label = values.sum(dim=0)
        if self.label_weights is None:
            return by_label.mean()
        lw = torch.as_tensor(self.label_weights, device=values.device)
        return _div_no_nan((by_label * lw).sum(), lw.sum())

    def result(self, state):
        n = self.num_thresholds
        tp, fp, tn, fn = state.reshape((4, n, -1) if self.multi_label else (4, n))
        if self.curve == "PR" and self.summation == "interpolation":
            dtp = tp[:n - 1] - tp[1:]
            p = tp + fp
            dp = p[:n - 1] - p[1:]
            slope = _div_no_nan(dtp, torch.clamp(dp, min=0))
            intercept = tp[1:] - slope * p[1:]
            ratio = torch.where((p[:n - 1] > 0) & (p[1:] > 0),
                                _div_no_nan(p[:n - 1], torch.clamp(p[1:], min=0)),
                                torch.ones_like(p[1:]))
            inc = _div_no_nan(slope * (dtp + intercept * torch.log(ratio)),
                              torch.clamp(tp[1:] + fn[1:], min=0))
            return self._by_label(inc)
        recall = _div_no_nan(tp, tp + fn)
        if self.curve == "ROC":
            x, y = _div_no_nan(fp, fp + tn), recall
        elif self.curve == "PR":
            x, y = recall, _div_no_nan(tp, tp + fp)
        else:
            scale = _div_no_nan(tp + fn, tn + fp)
            rg = 1.0 - scale * _div_no_nan(fn, tp)
            pg = 1.0 - scale * _div_no_nan(fp, tp)
            rg = torch.where(tp == 0, torch.zeros_like(rg), rg)
            pg = torch.where(tp == 0, torch.ones_like(pg), pg)
            x, y = torch.clamp(rg, min=0.0), pg
        if self.summation == "interpolation":
            heights = (y[:n - 1] + y[1:]) / 2.0
        elif self.summation == "minoring":
            heights = torch.minimum(y[:n - 1], y[1:])
        else:
            heights = torch.maximum(y[:n - 1], y[1:])
        return self._by_label((x[:n - 1] - x[1:]) * heights)


class _FBeta(StatefulMetric):
    """FBetaScore and F1Score: ``tp``, ``fp``, ``fn`` and the labels' sum
    a class (one each with ``average="micro"``), the prediction the row's
    maximum (above 1e-9) or above ``threshold``; averaged per ``average``."""

    def __init__(self, name, average=None, beta=1.0, threshold=None):
        super().__init__(name)
        if average not in (None, "micro", "macro", "weighted"):
            raise ValueError(f"Invalid `average` argument value: {average!r}")
        if float(beta) <= 0.0:
            raise ValueError(f"Invalid `beta` argument value: {beta}")
        if threshold is not None and not 0.0 < float(threshold) <= 1.0:
            raise ValueError(f"Invalid `threshold` argument value: {threshold}")
        self.average, self.beta, self.threshold = average, float(beta), threshold

    def _state(self, y_true, y_pred):
        t, p = y_true.to(torch.float32), y_pred.to(torch.float32)
        if p.dim() != 2 or t.dim() != 2:
            raise ValueError(f"FBetaScore expects 2D inputs with shape (batch_size, "
                             f"output_dim). Received input shapes: y_pred.shape="
                             f"{tuple(p.shape)} and y_true.shape={tuple(t.shape)}.")
        if self.threshold is None:
            p = (p >= p.amax(dim=-1, keepdim=True)) & (p.abs() > 1e-9)
        else:
            p = p > float(self.threshold)
        p = p.to(torch.float32)
        dims = None if self.average == "micro" else 0

        def total(v):
            return v.sum() if dims is None else v.sum(dim=0)

        return torch.stack([total(p * t), total(p * (1 - t)), total((1 - p) * t), total(t)])

    def result(self, state):
        tp, fp, fn, weights = state.reshape(4, -1) if self.average != "micro" else state
        precision = tp / (tp + fp + _EPS)
        recall = tp / (tp + fn + _EPS)
        b2 = self.beta ** 2
        f = precision * recall / (b2 * precision + recall + _EPS) * (1 + b2)
        if self.average == "weighted":
            return (f * (weights / (weights.sum() + _EPS))).sum()
        if self.average is not None:
            return f.mean()
        return f


class _R2(StatefulMetric):
    """R2Score: the labels' sum and squared sum, the squared errors' sum and
    the count a column, and the element count; ``class_aggregation``,
    ``num_regressors``'s adjustment."""

    def __init__(self, name, class_aggregation="uniform_average", num_regressors=0):
        super().__init__(name)
        if class_aggregation not in (None, "uniform_average", "variance_weighted_average"):
            raise ValueError(f"Invalid value for argument `class_aggregation`: "
                             f"{class_aggregation!r}")
        if num_regressors < 0:
            raise ValueError(f"Invalid value for argument `num_regressors`: "
                             f"{num_regressors}")
        self.aggregation, self.num_regressors = class_aggregation, int(num_regressors)

    def _state(self, y_true, y_pred):
        t, p = _same_rank(y_true.to(torch.float32), y_pred.to(torch.float32))
        if p.dim() != 2 or t.dim() != 2:
            raise ValueError(f"R2Score expects 2D inputs with shape (batch_size, "
                             f"output_dim). Received input shapes: y_pred.shape="
                             f"{tuple(p.shape)} and y_true.shape={tuple(t.shape)}.")
        count = torch.full((t.shape[1],), float(t.shape[0]), device=t.device)
        size = torch.full((1,), float(t.numel()), device=t.device)
        return torch.cat([t.sum(dim=0), (t * t).sum(dim=0), torch.square(t - p).sum(dim=0),
                          count, size])

    def result(self, state):
        s, sq, mse, count = state[:-1].reshape(4, -1)
        n_samples = state[-1]
        mean = s / count
        total = sq - s * mean
        raw = 1 - mse / total
        raw = torch.where(torch.isinf(raw), torch.zeros_like(raw), raw)
        if self.aggregation == "uniform_average":
            r2 = raw.mean()
        elif self.aggregation == "variance_weighted_average":
            r2 = (total * raw).sum() / total.sum()
        else:
            r2 = raw
        if self.num_regressors:
            k = float(self.num_regressors)
            adjusted = 1.0 - (1.0 - r2) * (n_samples - 1.0) / (n_samples - k - 1.0)
            r2 = torch.where(k < n_samples - 1, adjusted, r2)
        return r2


class _RMSE(StatefulMetric):
    """RootMeanSquaredError: Keras's Mean of the squared errors (each row's
    mean over its other axes), its square root."""

    def _state(self, y_true, y_pred):
        t, p = _same_rank(y_true.to(torch.float32), y_pred.to(torch.float32))
        err = torch.square(p - t)
        if err.dim() > 1:
            err = err.reshape(err.shape[0], -1).mean(dim=-1)
        n = float(err.shape[0]) if err.dim() else 1.0
        return torch.stack([err.sum(), torch.tensor(n, device=err.device)])

    def result(self, state):
        return torch.sqrt(_div_no_nan(state[0], state[1]))


class _IoU(StatefulMetric):
    """The IoU family: a ``num_classes`` square confusion matrix of the
    labels and predictions as integers (truncated, as Keras's ``int``
    dtype converts them; argmax over ``axis`` where not sparse; BinaryIoU's
    predictions ``>= threshold``), ``ignore_class`` left out; the mean IoU
    over ``target_class_ids`` whose denominator is not 0."""

    def __init__(self, name, num_classes, target_class_ids, ignore_class=None,
                 sparse_y_true=True, sparse_y_pred=True, axis=-1, threshold=None):
        super().__init__(name)
        self.num_classes = int(num_classes)
        self.targets = [int(c) for c in target_class_ids]
        if max(self.targets) >= self.num_classes:
            raise ValueError(f"Target class id {max(self.targets)} is out of range, which "
                             f"is [0, {self.num_classes}).")
        self.ignore_class, self.axis, self.threshold = ignore_class, int(axis), threshold
        self.sparse_true, self.sparse_pred = bool(sparse_y_true), bool(sparse_y_pred)

    def _state(self, y_true, y_pred):
        t, p = y_true, y_pred
        if not self.sparse_true:
            t = torch.argmax(t, dim=self.axis)
        if self.threshold is not None:
            p = (p.to(torch.float32) >= float(self.threshold)).to(torch.int64)
        elif not self.sparse_pred:
            p = torch.argmax(p, dim=self.axis)
        t = t.to(torch.int64).reshape(-1) if t.is_floating_point() else t.reshape(-1).long()
        p = (p.to(torch.int64) if p.is_floating_point() else p.long()).reshape(-1)
        w = torch.ones(t.shape, dtype=torch.int64, device=t.device)
        if self.ignore_class is not None:
            keep = (t != int(self.ignore_class)).to(torch.int64)
            t, p, w = t * keep, p * keep, w * keep
        nc = self.num_classes
        cm = torch.zeros(nc * nc, dtype=torch.int64, device=t.device)
        cm.scatter_add_(0, t * nc + p, w)
        return cm.to(torch.float32)

    def result(self, state):
        cm = state.reshape(self.num_classes, self.num_classes)
        tp = torch.diagonal(cm)
        denom = cm.sum(dim=0) + cm.sum(dim=1) - tp
        idx = torch.tensor(self.targets, device=cm.device)
        tp, denom = tp[idx], denom[idx]
        valid = (denom > 1e-9).to(torch.float32).sum()
        return (tp / (denom + _EPS)).sum() / (valid + _EPS)


def _counts(which):
    return lambda name, thresholds=None, **_: _Counts(name, which, thresholds)


def _constraint(kind, key):
    return lambda name, num_thresholds=200, class_id=None, **cfg: _AtConstraint(
        name, kind, cfg[key], num_thresholds, class_id)


# Keras 3.13's classes by name: a builder from the name Keras logs and the
# class's config
STATEFUL_METRICS: Dict[str, Callable[..., StatefulMetric]] = {
    "TruePositives": _counts("tp"),
    "FalsePositives": _counts("fp"),
    "TrueNegatives": _counts("tn"),
    "FalseNegatives": _counts("fn"),
    "Precision": lambda name, thresholds=None, top_k=None, class_id=None, **_:
        _PrecisionRecall(name, "fp", thresholds, top_k, class_id),
    "Recall": lambda name, thresholds=None, top_k=None, class_id=None, **_:
        _PrecisionRecall(name, "fn", thresholds, top_k, class_id),
    "SensitivityAtSpecificity": _constraint("SensitivityAtSpecificity", "specificity"),
    "SpecificityAtSensitivity": _constraint("SpecificityAtSensitivity", "sensitivity"),
    "PrecisionAtRecall": _constraint("PrecisionAtRecall", "recall"),
    "RecallAtPrecision": _constraint("RecallAtPrecision", "precision"),
    "AUC": lambda name, num_thresholds=200, curve="ROC", summation_method="interpolation",
        thresholds=None, multi_label=False, num_labels=None, label_weights=None,
        from_logits=False, **_: _AUC(name, num_thresholds, curve, summation_method,
                                     thresholds, multi_label, num_labels, label_weights,
                                     from_logits),
    "FBetaScore": lambda name, average=None, beta=1.0, threshold=None, **_:
        _FBeta(name, average, beta, threshold),
    "F1Score": lambda name, average=None, threshold=None, **_:
        _FBeta(name, average, 1.0, threshold),
    "R2Score": lambda name, class_aggregation="uniform_average", num_regressors=0, **_:
        _R2(name, class_aggregation, num_regressors),
    "RootMeanSquaredError": lambda name, **_: _RMSE(name),
    "IoU": lambda name, num_classes, target_class_ids, ignore_class=None,
        sparse_y_true=True, sparse_y_pred=True, axis=-1, **_: _IoU(
            name, num_classes, target_class_ids, ignore_class, sparse_y_true,
            sparse_y_pred, axis),
    "BinaryIoU": lambda name, target_class_ids=(0, 1), threshold=0.5, **_: _IoU(
        name, 2, target_class_ids, threshold=threshold),
    "MeanIoU": lambda name, num_classes, ignore_class=None, sparse_y_true=True,
        sparse_y_pred=True, axis=-1, **_: _IoU(name, num_classes, range(int(num_classes)),
                                               ignore_class, sparse_y_true, sparse_y_pred,
                                               axis),
    "OneHotIoU": lambda name, num_classes, target_class_ids, ignore_class=None,
        sparse_y_pred=False, axis=-1, **_: _IoU(name, num_classes, target_class_ids,
                                                ignore_class, False, sparse_y_pred, axis),
    "OneHotMeanIoU": lambda name, num_classes, ignore_class=None, sparse_y_pred=False,
        axis=-1, **_: _IoU(name, num_classes, range(int(num_classes)), ignore_class, False,
                           sparse_y_pred, axis),
}

def build_stateful(cls: str, cfg: dict) -> StatefulMetric:
    """The metric of class ``cls`` from its config (``get_config()``'s
    keys), logged under the config's ``name``."""
    cfg = {k: v for k, v in cfg.items() if k != "dtype"}
    return STATEFUL_METRICS[cls](cfg.pop("name"), **cfg)


def result_value(value: torch.Tensor):
    """A result as Keras logs it: a float, or a float32 array for a vector."""
    value = value.detach().cpu()
    return float(value) if value.dim() == 0 else value.numpy().astype(np.float32)


__all__ = ["StatefulMetric", "STATEFUL_METRICS", "build_stateful", "confusion_counts",
           "result_value"]
