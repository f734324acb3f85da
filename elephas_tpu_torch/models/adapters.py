"""A Keras model's JSON ↔ functional PyTorch (port of
``elephas_tpu/models/adapters.py`` ``KerasModelAdapter``, without Keras).

The reference adapter wraps a live Keras-3 model and calls its
``stateless_call``. The port has no Keras (the GPU machine has none), so
its adapter reads the reference's wire format for a model instead: the
Keras-3 model JSON (``model.to_json()``, what ``model_to_dict`` and
``from_json`` carry) plus the flat ``get_weights()`` list, and interprets
it. Keras 3 writes the ``compile_config`` (optimizer, loss with
``from_logits``, metrics) into that JSON, so the adapter takes loss,
optimizer and metrics from it; ``loss=`` / ``optimizer=`` / ``metrics=``
override them as in the reference. An object with ``to_json()`` (and
``get_weights()``) is read duck-typed, so a caller may hand over a Keras
model without the port importing Keras.

What it interprets: a ``Sequential`` of ``InputLayer``, ``Dense`` (the
activations Keras names), ``Dropout``, ``Activation`` and ``Flatten``,
with Keras's weight order and layouts (kernel ``[in, out]``, then bias).
Anything else raises :class:`NotImplementedError` naming the layer and the
ROADMAP item it waits for. As in the reference's ``stateless_call`` path,
regularizers and constraints play no part in training. Without weights it
initialises from the config's initializers (GlorotUniform, Zeros, ...)
with an explicit ``torch.Generator``, as ``model_from_json`` would.

The step builders work over a stacked replica dimension: parameters
``[L, ...]`` (``L`` worker replicas), inputs ``[L, B, ...]``; each Dense
layer is a ``torch.bmm`` and the loss runs once over the flattened ``[L *
B, C]`` rows, so K1 is one launch a step for all replicas. Padded samples
carry zero weight, and a replica whose batch is all padding keeps its
parameters and optimizer state (step count included) unchanged.
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from .losses import resolve_accuracy, resolve_per_sample_loss
from .optimizers import _lead, to_torch_optimizer

Params = Dict[str, torch.Tensor]

# the ROADMAP item each refused part of a Keras model waits for
LAYERS_ITEM = "ROADMAP queue 1 item 13 (Keras layers beyond the MLP)"

_ACTIVATIONS: Dict[str, Callable] = {
    "linear": lambda h: h,
    "relu": torch.relu,
    "relu6": F.relu6,
    "leaky_relu": lambda h: F.leaky_relu(h, 0.2),
    "elu": F.elu,
    "selu": F.selu,
    "gelu": F.gelu,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": F.hardsigmoid,
    "hard_silu": F.hardswish,
    "hard_swish": F.hardswish,
    "silu": F.silu,
    "swish": F.silu,
    "mish": F.mish,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "tanh": torch.tanh,
    "exponential": torch.exp,
    "softmax": lambda h: torch.softmax(h, dim=-1),
    "log_softmax": lambda h: torch.log_softmax(h, dim=-1),
}


def _activation(spec) -> Callable:
    if spec is None:
        return _ACTIVATIONS["linear"]
    if isinstance(spec, dict):          # a serialized activation function
        spec = spec.get("config", spec.get("class_name"))
    name = str(spec).lower()
    if name not in _ACTIVATIONS:
        raise NotImplementedError(f"activation {spec!r} waits for {LAYERS_ITEM}")
    return _ACTIVATIONS[name]


# -- initializers (what model_from_json draws for a model without weights) --

_VARIANCE_SCALING = {
    "GlorotUniform": (1.0, "fan_avg", "uniform"),
    "GlorotNormal": (1.0, "fan_avg", "truncated_normal"),
    "HeUniform": (2.0, "fan_in", "uniform"),
    "HeNormal": (2.0, "fan_in", "truncated_normal"),
    "LecunUniform": (1.0, "fan_in", "uniform"),
    "LecunNormal": (1.0, "fan_in", "truncated_normal"),
}


def _initial_value(spec, shape: Tuple[int, ...], gen: torch.Generator) -> torch.Tensor:
    """A float32 CPU tensor drawn as the Keras initializer ``spec`` would
    (same distribution; other bits than Keras's generator)."""
    cls = spec.get("class_name") if isinstance(spec, dict) else str(spec)
    cfg = dict(spec.get("config") or {}) if isinstance(spec, dict) else {}
    cls = {"zeros": "Zeros", "ones": "Ones", "glorot_uniform": "GlorotUniform",
           "glorot_normal": "GlorotNormal", "he_uniform": "HeUniform",
           "he_normal": "HeNormal", "lecun_uniform": "LecunUniform",
           "lecun_normal": "LecunNormal", "random_normal": "RandomNormal",
           "random_uniform": "RandomUniform",
           "truncated_normal": "TruncatedNormal"}.get(cls, cls)
    if cfg.get("seed") is not None:
        gen = torch.Generator().manual_seed(int(cfg["seed"]))
    out = torch.empty(shape, dtype=torch.float32)
    if cls == "Zeros":
        return out.zero_()
    if cls == "Ones":
        return out.fill_(1.0)
    if cls == "Constant":
        return out.fill_(float(cfg.get("value", 0.0)))
    if cls == "RandomNormal":
        return out.normal_(float(cfg.get("mean", 0.0)), float(cfg.get("stddev", 0.05)),
                           generator=gen)
    if cls == "RandomUniform":
        return out.uniform_(float(cfg.get("minval", -0.05)), float(cfg.get("maxval", 0.05)),
                            generator=gen)
    if cls == "TruncatedNormal":
        mean, std = float(cfg.get("mean", 0.0)), float(cfg.get("stddev", 0.05))
        return torch.nn.init.trunc_normal_(out, mean, std, mean - 2 * std, mean + 2 * std,
                                           generator=gen)
    if cls in _VARIANCE_SCALING or cls == "VarianceScaling":
        scale, mode, dist = _VARIANCE_SCALING.get(
            cls, (float(cfg.get("scale", 1.0)), cfg.get("mode", "fan_in"),
                  cfg.get("distribution", "truncated_normal")))
        fan_in = shape[-2] if len(shape) > 1 else shape[0]
        fan_out = shape[-1]
        fan = {"fan_in": fan_in, "fan_out": fan_out,
               "fan_avg": (fan_in + fan_out) / 2.0}[mode]
        scale /= max(1.0, fan)
        if dist == "uniform":
            limit = math.sqrt(3.0 * scale)
            return out.uniform_(-limit, limit, generator=gen)
        if dist == "truncated_normal":
            # the std of a unit normal truncated at +-2, as Keras corrects it
            std = math.sqrt(scale) / 0.87962566103423978
            return torch.nn.init.trunc_normal_(out, 0.0, std, -2 * std, 2 * std,
                                               generator=gen)
        return out.normal_(0.0, math.sqrt(scale), generator=gen)
    raise NotImplementedError(f"initializer {cls!r} waits for {LAYERS_ITEM}")


# -- the interpreted layers --------------------------------------------------


class _Dense:
    def __init__(self, cfg: dict, in_dim: int):
        self.name = cfg["name"]
        self.units = int(cfg["units"])
        self.use_bias = bool(cfg.get("use_bias", True))
        self.act = _activation(cfg.get("activation"))
        self.kernel_init = cfg.get("kernel_initializer", "GlorotUniform")
        self.bias_init = cfg.get("bias_initializer", "Zeros")
        self.in_dim = in_dim

    def weight_shapes(self):
        shapes = [(f"{self.name}/kernel", (self.in_dim, self.units), self.kernel_init)]
        if self.use_bias:
            shapes.append((f"{self.name}/bias", (self.units,), self.bias_init))
        return shapes

    def __call__(self, p: Params, h, training, gen):
        L = h.shape[0]
        out = torch.bmm(h.reshape(L, -1, self.in_dim), p[f"{self.name}/kernel"])
        if self.use_bias:
            out = out + p[f"{self.name}/bias"][:, None, :]
        return self.act(out.reshape(h.shape[:-1] + (self.units,)))


class _Dropout:
    def __init__(self, cfg: dict):
        self.rate = float(cfg.get("rate", 0.0))
        if cfg.get("noise_shape") is not None:
            raise NotImplementedError(f"Dropout noise_shape waits for {LAYERS_ITEM}")

    def weight_shapes(self):
        return []

    def __call__(self, p, h, training, gen):
        if not training or self.rate <= 0.0:
            return h
        # inverted dropout, as keras.random.dropout: keep 1 - rate, scale
        # the kept values by 1 / (1 - rate); one draw over the whole
        # replica stack, so every replica gets its own mask
        keep = 1.0 - self.rate
        mask = torch.rand(h.shape, generator=gen, device=h.device) < keep
        return torch.where(mask, h / keep, torch.zeros_like(h))


class _Activation:
    def __init__(self, cfg: dict):
        self.act = _activation(cfg.get("activation"))

    def weight_shapes(self):
        return []

    def __call__(self, p, h, training, gen):
        return self.act(h)


class _Flatten:
    def weight_shapes(self):
        return []

    def __call__(self, p, h, training, gen):
        return h.reshape(h.shape[0], h.shape[1], -1)


def _parse_sequential(arch: dict, weight_shapes: Optional[List[Tuple[int, ...]]]):
    """The layer ops of a Keras-3 Sequential config. Input widths come from
    the config (InputLayer / build shapes) or, failing that, from the
    kernels' shapes in ``weight_shapes``."""
    if arch.get("class_name") != "Sequential":
        raise NotImplementedError(
            f"model class {arch.get('class_name')!r}: the port interprets Sequential "
            f"models; Functional models wait for {LAYERS_ITEM}")
    cfg = arch.get("config", {})
    policy = cfg.get("dtype")
    if isinstance(policy, dict):
        policy = (policy.get("config") or {}).get("name")
    if policy not in (None, "float32"):
        raise NotImplementedError(f"dtype policy {policy!r} waits for {LAYERS_ITEM}")
    shape = cfg.get("build_input_shape") or (arch.get("build_config") or {}).get("input_shape")
    feat = list(shape[1:]) if shape else None
    # the Dense kernels' input widths, in order (biases are the 1-D arrays)
    kernel_in = iter([s[0] for s in weight_shapes or [] if len(s) == 2])
    ops = []
    for layer in cfg.get("layers", []):
        cls, lcfg = layer.get("class_name"), layer.get("config", {})
        if cls == "InputLayer":
            bs = lcfg.get("batch_shape") or lcfg.get("batch_input_shape")
            if bs:
                feat = list(bs[1:])
            continue
        if cls == "Dense":
            in_dim = next(kernel_in, None)
            if feat is None:
                build = (layer.get("build_config") or {}).get("input_shape")
                if build:
                    feat = list(build[1:])
                elif in_dim is not None:
                    feat = [in_dim]
                else:
                    raise ValueError(f"Dense layer {lcfg.get('name')!r}: the config has "
                                     f"no input shape and no weights were given")
            op = _Dense(lcfg, int(feat[-1]))
            feat = feat[:-1] + [op.units]
        elif cls == "Dropout":
            op = _Dropout(lcfg)
        elif cls == "Activation":
            op = _Activation(lcfg)
        elif cls == "Flatten":
            op = _Flatten()
            if feat is not None:
                feat = [int(np.prod(feat))]
        else:
            raise NotImplementedError(f"layer {cls!r} waits for {LAYERS_ITEM}")
        ops.append(op)
    return ops


def _tree_map(fn, *trees):
    """``fn`` over matching leaves of tensors, dicts and NamedTuples."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple):
        return type(t0)(*(_tree_map(fn, *parts) for parts in zip(*trees)))
    return t0


def _tree_where(valid, new, old):
    """Per replica: ``new`` where ``valid`` (``[L]``), else ``old``."""
    return _tree_map(lambda a, b: torch.where(_lead(valid, a), a, b), new, old)


def _is_accuracy_name(name) -> bool:
    return "accuracy" in str(name) or str(name) == "acc"


def _read_model(model) -> Tuple[dict, Optional[List[np.ndarray]]]:
    """``(architecture dict, weights or None)`` from a JSON string, a config
    dict, ``model_to_dict``'s ``{"model", "weights"}`` or an object with
    ``to_json()`` (and ``get_weights()``)."""
    if isinstance(model, str):
        return json.loads(model), None
    if isinstance(model, dict):
        if "model" in model and "weights" in model:
            arch, _ = _read_model(model["model"])
            return arch, list(model["weights"])
        return model, None
    if hasattr(model, "to_json"):
        weights = model.get_weights() if hasattr(model, "get_weights") else None
        return json.loads(model.to_json()), weights
    raise TypeError(f"cannot read a model from {type(model).__name__}: pass its "
                    f"Keras JSON, a config dict, or an object with to_json()")


def refuse_remat(remat: bool) -> None:
    """``remat=True`` (the reference's ``jax.checkpoint`` around the step)
    is not ported yet: raise, naming its ROADMAP item."""
    if remat:
        raise NotImplementedError(
            "remat=True (activation recomputation for deep Keras models) waits "
            "for ROADMAP queue 1 item 13 (Keras models beyond the MLP)")


class KerasModelAdapter:
    """Functional view over a Keras-3 Sequential model's JSON and weights."""

    def __init__(self, model, loss: Any = None, optimizer: Any = None,
                 metrics: Optional[Sequence[str]] = None,
                 custom_objects: Optional[dict] = None,
                 weights: Optional[Sequence[np.ndarray]] = None,
                 seed: int = 0, device="cuda"):
        arch, read_weights = _read_model(model)
        if weights is None:
            weights = read_weights
        self.config = arch
        self.custom_objects = custom_objects
        self.device = resolve_device(device)
        self.compile_config = dict(arch.get("compile_config") or {})
        # Loss may be absent (inference-only use: predict needs none); the
        # step builders raise when they need it.
        self.loss_spec = loss if loss is not None else self.compile_config.get("loss")
        self.optimizer_spec = (optimizer if optimizer is not None
                               else self.compile_config.get("optimizer")) or "sgd"
        self.metrics = list(metrics) if metrics is not None else self._infer_metrics()
        shapes = None if weights is None else [np.shape(w) for w in weights]
        self.layers = _parse_sequential(arch, shapes)
        self._specs = [s for op in self.layers for s in op.weight_shapes()]
        if weights is not None:
            self.set_weights(weights)
        else:
            gen = torch.Generator().manual_seed(int(seed))
            self._params = {name: _initial_value(init, shape, gen).to(self.device)
                            for name, shape, init in self._specs}

    # -- introspection ---------------------------------------------------
    def compile_metric_names(self) -> Tuple[List[str], List[str]]:
        """``(metric_names, weighted_metric_names)`` of the compile config."""
        def names(spec):
            if spec is None:
                return []
            if isinstance(spec, dict) and "class_name" not in spec:
                return [n for s in spec.values() for n in names(s)]
            if isinstance(spec, (list, tuple)):
                return [n for s in spec for n in names(s)]
            if isinstance(spec, dict):
                return [str((spec.get("config") or {}).get("name", spec["class_name"]))]
            return [spec if isinstance(spec, str) else str(getattr(spec, "name", spec))]

        return (names(self.compile_config.get("metrics")),
                names(self.compile_config.get("weighted_metrics")))

    def _infer_metrics(self) -> List[str]:
        names, weighted = self.compile_metric_names()
        return ["accuracy"] if any(_is_accuracy_name(n) for n in names + weighted) else []

    @property
    def wants_accuracy(self) -> bool:
        return "accuracy" in self.metrics

    # -- serialization (reference: utils/serialization.py) ---------------
    @classmethod
    def from_json(cls, json_config: str, weights: Optional[List[np.ndarray]] = None,
                  loss: Any = None, optimizer: Any = None,
                  metrics: Optional[Sequence[str]] = None,
                  custom_objects: Optional[dict] = None, device="cuda"
                  ) -> "KerasModelAdapter":
        return cls(json_config, loss=loss, optimizer=optimizer, metrics=metrics,
                   custom_objects=custom_objects, weights=weights, device=device)

    def to_json(self) -> str:
        return json.dumps(self.config)

    # -- state -----------------------------------------------------------
    def get_weights(self) -> List[np.ndarray]:
        return [self._params[name].detach().cpu().numpy() for name, _, _ in self._specs]

    def set_weights(self, weights: Sequence) -> None:
        weights = list(weights)
        if len(weights) != len(self._specs):
            raise ValueError(f"expected {len(self._specs)} weight arrays, got "
                             f"{len(weights)}")
        params = {}
        for (name, shape, _), w in zip(self._specs, weights):
            t = torch.as_tensor(np.asarray(w, dtype=np.float32)).to(self.device)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
            params[name] = t
        self._params = params

    def state_values(self) -> Params:
        """The current trainable parameters, by name, on the device."""
        return dict(self._params)

    def install_state(self, tv: Params) -> None:
        """Take ``tv`` (device tensors, as the engine returns them) as the
        current parameters."""
        self._params = {name: tv[name] for name, _, _ in self._specs}

    def state_to_weights(self, tv: Params) -> List[torch.Tensor]:
        """The parameter dict → a flat list in ``get_weights()`` order."""
        return [tv[name] for name, _, _ in self._specs]

    # -- the model -------------------------------------------------------
    def apply(self, params: Params, x, training: bool = False,
              generator: Optional[torch.Generator] = None):
        """The model over a replica stack: ``params`` ``[L, ...]``, ``x``
        ``[L, B, ...]`` → ``[L, B, ...]``."""
        h = x
        for op in self.layers:
            h = op(params, h, training, generator)
        return h

    def predict(self, x, batch_size: int = 32, verbose: int = 0) -> np.ndarray:
        """Keras ``model.predict``: the current weights over ``x`` in batches
        of ``batch_size`` rows on the adapter's device."""
        predict_fn = self.build_predict_fn()
        stacked = {k: v[None] for k, v in self._params.items()}
        x = np.asarray(x, dtype=np.float32)
        outs = []
        for i in range(0, x.shape[0], int(batch_size)):
            xb = torch.as_tensor(x[i:i + int(batch_size)]).to(self.device)
            outs.append(predict_fn(stacked, xb[None])[0].cpu().numpy())
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)

    # -- step builders ---------------------------------------------------
    def _require_loss(self):
        if self.loss_spec is None:
            raise ValueError(
                "No loss available: compile the model or pass loss= explicitly."
            )
        return self.loss_spec

    def make_optimizer(self):
        return to_torch_optimizer(self.optimizer_spec)

    def _loss_parts(self):
        per_sample_loss = resolve_per_sample_loss(self._require_loss())
        acc_fn = resolve_accuracy(self.loss_spec) if self.wants_accuracy else None

        def per_and_acc(y, y_pred, sw, with_acc=True):
            """Per-sample losses ``[L, B]`` over the flattened rows (one call
            for every replica) and the weighted accuracy sums ``[L]``."""
            L, B = sw.shape
            yf = y.reshape((L * B,) + tuple(y.shape[2:]))
            pf = y_pred.reshape((L * B,) + tuple(y_pred.shape[2:]))
            per = per_sample_loss(yf, pf).reshape(L, B)
            if acc_fn is None or not with_acc:
                return per, torch.zeros(L, dtype=torch.float32, device=sw.device)
            with torch.no_grad():
                acc = (acc_fn(yf, pf.detach()).reshape(L, B) * sw).sum(dim=1)
            return per, acc

        return per_and_acc

    def build_train_step(self, optimizer, remat: bool = False) -> Callable:
        """``(tv, opt_state, x, y, sw, gen) → (tv, opt_state, stats)`` over
        ``L`` replicas: ``tv`` ``[L, ...]``, ``x`` ``[L, B, ...]``, ``sw``
        ``[L, B]``. ``stats`` is ``(loss_weighted_sum, acc_weighted_sum,
        weight_sum)``, each ``[L]``. A replica whose batch is all padding
        keeps its parameters and optimizer state. ``remat`` is the
        reference's ``jax.checkpoint`` switch, accepted in its place; as in
        ``CompiledTrainer``, ``True`` is not ported yet and raises."""
        refuse_remat(remat)
        per_and_acc = self._loss_parts()

        def train_step(tv, opt_state, x, y, sw, gen):
            leaves = {k: t.detach().requires_grad_() for k, t in tv.items()}
            with torch.enable_grad():
                y_pred = self.apply(leaves, x, True, gen)
                per, acc = per_and_acc(y, y_pred, sw)
                wsum = sw.sum(dim=1)
                loss = (per * sw).sum(dim=1) / torch.clamp(wsum, min=1e-9)
                # the replicas share nothing, so the gradient of the sum is
                # each replica's own gradient
                grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
            with torch.no_grad():
                grads = dict(zip(leaves, grads))
                updates, opt2 = optimizer.update(grads, opt_state, tv)
                tv2 = {k: tv[k] + updates[k] for k in tv}
                valid = wsum > 0
                tv2 = _tree_where(valid, tv2, tv)
                opt2 = _tree_where(valid, opt2, opt_state)
                stats = (torch.where(valid, loss * wsum, 0.0), acc, wsum)
            return tv2, opt2, stats

        return train_step

    def build_grad_step(self, remat: bool = False) -> Callable:
        """``(tv, x, y, sw, gen) → (grads, stats)``: gradients of the
        sample-weighted loss SUM over every replica's batch on the SHARED
        parameters ``tv`` (no replica axis), without an update. The
        caller divides by the global weight sum and steps once. ``remat``
        as in :meth:`build_train_step`."""
        refuse_remat(remat)
        per_and_acc = self._loss_parts()

        def grad_step(tv, x, y, sw, gen):
            L, B = sw.shape
            leaves = {k: t.detach().requires_grad_() for k, t in tv.items()}
            with torch.enable_grad():
                # one replica of L * B rows: the same rows, the same masks
                flat = x.reshape((1, L * B) + tuple(x.shape[2:]))
                y_pred = self.apply({k: v[None] for k, v in leaves.items()}, flat,
                                    True, gen)
                y_pred = y_pred.reshape((L, B) + tuple(y_pred.shape[2:]))
                per, acc = per_and_acc(y, y_pred, sw)
                loss_wsum = (per * sw).sum(dim=1)
                grads = torch.autograd.grad(loss_wsum.sum(), list(leaves.values()))
            return dict(zip(leaves, grads)), (loss_wsum.detach(), acc, sw.sum(dim=1))

        return grad_step

    def build_eval_step(self) -> Callable:
        """``(tv, x, y, sw) → (loss_wsum, acc_wsum, wsum)``, each ``[L]``."""
        per_and_acc = self._loss_parts()

        @torch.no_grad()
        def eval_step(tv, x, y, sw):
            y_pred = self.apply(tv, x, False)
            per, acc = per_and_acc(y, y_pred, sw)
            return (per * sw).sum(dim=1), acc, sw.sum(dim=1)

        return eval_step

    def build_predict_fn(self) -> Callable:
        @torch.no_grad()
        def predict_fn(tv, x):
            return self.apply(tv, x, False)

        return predict_fn
