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
activations Keras names), ``Dropout``, ``Activation``, ``Flatten``,
``Reshape``, ``Conv1D`` and ``Conv2D`` (channels_last; ``valid``,
``same`` and, for Conv1D, ``causal`` padding; strides and dilation),
``MaxPooling2D``, ``BatchNormalization`` (over the last axis),
``Embedding`` and ``LSTM``, with Keras's weight order and layouts
(kernel ``[in, out]`` / ``[*kernel_size, in, out]``, then bias; gamma,
beta, moving mean, moving variance; LSTM gates i, f, c, o). Anything else
raises :class:`NotImplementedError` naming the layer or option and the
ROADMAP item it waits for. As in the reference's ``stateless_call`` path,
regularizers and constraints play no part in training. Without weights it
initialises from the config's initializers (the VarianceScaling family,
Orthogonal, the constants, LSTM's ``unit_forget_bias``) with an explicit
``torch.Generator``, as ``model_from_json`` would (same distributions,
other bits).

State is the reference's pair ``(tv, ntv)``: the trainable parameters and
the non-trainable ones (BatchNormalization's moving statistics), each a
dict by name (``"<layer>/kernel"``, ``"<layer>/moving_mean"``). ``ntv`` is
empty for a model without BatchNormalization. The reference's ``ntv`` also
holds Keras's seed-generator state, which has no slot in
``get_weights()``; the port draws dropout from a ``torch.Generator``
instead, so it has no counterpart.

The step builders work over a stacked replica dimension: parameters
``[L, ...]`` (``L`` worker replicas), inputs ``[L, B, ...]``; each Dense
layer is a ``torch.bmm``, each convolution one grouped convolution
(``groups = L``), and the loss runs once over the flattened ``[L * B, C]``
rows, so K1 is one launch a step for all replicas. BatchNormalization
takes each replica's moments over its own ``B`` rows (padding included,
as the reference's ``stateless_call`` knows nothing of sample weights).
Padded samples carry zero weight, and a replica whose batch is all padding
keeps its parameters, statistics and optimizer state (step count
included) unchanged.
"""

from __future__ import annotations

import json
import math
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

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


def _refuse(what: str):
    return NotImplementedError(f"{what} waits for {LAYERS_ITEM}")


# -- initializers (what model_from_json draws for a model without weights) --

_VARIANCE_SCALING = {
    "GlorotUniform": (1.0, "fan_avg", "uniform"),
    "GlorotNormal": (1.0, "fan_avg", "truncated_normal"),
    "HeUniform": (2.0, "fan_in", "uniform"),
    "HeNormal": (2.0, "fan_in", "truncated_normal"),
    "LecunUniform": (1.0, "fan_in", "uniform"),
    "LecunNormal": (1.0, "fan_in", "truncated_normal"),
}

_INIT_ALIASES = {
    "zeros": "Zeros", "ones": "Ones", "glorot_uniform": "GlorotUniform",
    "glorot_normal": "GlorotNormal", "he_uniform": "HeUniform",
    "he_normal": "HeNormal", "lecun_uniform": "LecunUniform",
    "lecun_normal": "LecunNormal", "random_normal": "RandomNormal",
    "random_uniform": "RandomUniform", "truncated_normal": "TruncatedNormal",
    "uniform": "RandomUniform", "normal": "RandomNormal", "orthogonal": "Orthogonal",
}


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """``(fan_in, fan_out)`` as Keras computes them: a kernel of more than two
    axes counts its receptive field (every axis but the last two) in both."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    field = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    return shape[-2] * field, shape[-1] * field


def _initial_value(spec, shape: Tuple[int, ...], gen: torch.Generator) -> torch.Tensor:
    """A float32 CPU tensor drawn as the Keras initializer ``spec`` would
    (same distribution; other bits than Keras's generator). A callable
    ``spec(shape, gen)`` draws for itself (LSTM's ``unit_forget_bias``)."""
    if callable(spec):
        return spec(shape, gen)
    cls = spec.get("class_name") if isinstance(spec, dict) else str(spec)
    cfg = dict(spec.get("config") or {}) if isinstance(spec, dict) else {}
    cls = _INIT_ALIASES.get(cls, cls)
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
    if cls == "Orthogonal":
        # Keras: the Q of a QR of a normal [max(r, c), min(r, c)] matrix,
        # its columns signed by R's diagonal, transposed when r < c
        rows, cols = int(np.prod(shape[:-1])), shape[-1]
        a = torch.empty((max(rows, cols), min(rows, cols))).normal_(generator=gen)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (float(cfg.get("gain", 1.0)) * q).reshape(shape).contiguous()
    if cls in _VARIANCE_SCALING or cls == "VarianceScaling":
        scale, mode, dist = _VARIANCE_SCALING.get(
            cls, (float(cfg.get("scale", 1.0)), cfg.get("mode", "fan_in"),
                  cfg.get("distribution", "truncated_normal")))
        fan_in, fan_out = _fans(tuple(shape))
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
    raise _refuse(f"initializer {cls!r}")


# -- the interpreted layers --------------------------------------------------
#
# Each op is built from its layer config and the input's feature shape
# (``feat``, the shape without the batch axis; None where unknown) and sets
# ``out_feat``. ``op(p, h, training, gen, ntv_out)`` maps ``h`` ``[L, B,
# *feat]`` to ``[L, B, *out_feat]`` with the parameters ``p`` (trainable and
# non-trainable, ``[L, ...]``, by name); a layer with state writes its new
# statistics into ``ntv_out`` when that is a dict.


class _Spec(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    init: Any
    trainable: bool = True


def _ints(v, n: int) -> Tuple[int, ...]:
    """A Keras int-or-sequence argument as ``n`` ints."""
    if isinstance(v, (list, tuple)):
        if len(v) != n:
            raise ValueError(f"expected {n} values, got {v}")
        return tuple(int(a) for a in v)
    return (int(v),) * n


def _same_pads(size: int, k: int, stride: int, dilation: int) -> Tuple[int, int]:
    """``(before, after)`` of one axis under ``padding="same"``, as XLA pads
    it: the odd row or column goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _out_size(size: int, k: int, stride: int, dilation: int, pads) -> int:
    return (size + pads[0] + pads[1] - (k - 1) * dilation - 1) // stride + 1


def _need_feat(cls: str, cfg: dict, feat, rank: Optional[int] = None):
    if feat is None:
        raise ValueError(f"{cls} layer {cfg.get('name')!r}: the config has no input shape")
    if rank is not None and len(feat) != rank:
        raise ValueError(f"{cls} layer {cfg.get('name')!r}: input shape {feat} has "
                         f"{len(feat)} axes, want {rank}")
    return list(feat)


def _channels_last(cls: str, cfg: dict) -> None:
    if cfg.get("data_format") not in (None, "channels_last"):
        raise _refuse(f"{cls} data_format={cfg['data_format']!r}")


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
        shapes = [_Spec(f"{self.name}/kernel", (self.in_dim, self.units), self.kernel_init)]
        if self.use_bias:
            shapes.append(_Spec(f"{self.name}/bias", (self.units,), self.bias_init))
        return shapes

    def __call__(self, p: Params, h, training, gen, ntv_out):
        L = h.shape[0]
        out = torch.bmm(h.reshape(L, -1, self.in_dim), p[f"{self.name}/kernel"])
        if self.use_bias:
            out = out + p[f"{self.name}/bias"][:, None, :]
        return self.act(out.reshape(h.shape[:-1] + (self.units,)))


class _Dropout:
    def __init__(self, cfg: dict):
        self.rate = float(cfg.get("rate", 0.0))
        if cfg.get("noise_shape") is not None:
            raise _refuse("Dropout noise_shape")

    def weight_shapes(self):
        return []

    def __call__(self, p, h, training, gen, ntv_out):
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

    def __call__(self, p, h, training, gen, ntv_out):
        return self.act(h)


class _Flatten:
    def weight_shapes(self):
        return []

    def __call__(self, p, h, training, gen, ntv_out):
        return h.reshape(h.shape[0], h.shape[1], -1)


class _Reshape:
    def __init__(self, cfg: dict, feat):
        target = [int(v) for v in cfg["target_shape"]]
        if target.count(-1) > 1:
            raise ValueError(f"Reshape {cfg.get('name')!r}: target_shape {target} has "
                             f"more than one -1")
        if feat is not None and -1 in target:
            known = int(np.prod([v for v in target if v != -1]))
            target[target.index(-1)] = int(np.prod(feat)) // max(known, 1)
        self.target = tuple(target)
        self.out_feat = list(target) if -1 not in target else None

    def weight_shapes(self):
        return []

    def __call__(self, p, h, training, gen, ntv_out):
        return h.reshape(tuple(h.shape[:2]) + self.target)


class _Conv:
    """Conv1D (``rank`` 1) and Conv2D (``rank`` 2), channels_last, kernel
    ``[*kernel_size, in, filters]``. The replicas run as one grouped
    convolution: replica ``l``'s channels are group ``l``."""

    def __init__(self, cfg: dict, feat, rank: int):
        cls = f"Conv{rank}D"
        _channels_last(cls, cfg)
        if int(cfg.get("groups", 1)) != 1:
            raise _refuse(f"{cls} groups={cfg['groups']}")
        self.name, self.rank = cfg["name"], rank
        self.filters = int(cfg["filters"])
        self.kernel_size = _ints(cfg["kernel_size"], rank)
        self.strides = _ints(cfg.get("strides", 1), rank)
        self.dilation = _ints(cfg.get("dilation_rate", 1), rank)
        padding = str(cfg.get("padding", "valid")).lower()
        if padding not in ("valid", "same", "causal") or (padding == "causal" and rank != 1):
            raise ValueError(f"{cls} {self.name!r}: padding {padding!r}")
        self.use_bias = bool(cfg.get("use_bias", True))
        self.act = _activation(cfg.get("activation"))
        self.kernel_init = cfg.get("kernel_initializer", "GlorotUniform")
        self.bias_init = cfg.get("bias_initializer", "Zeros")
        feat = _need_feat(cls, cfg, feat, rank + 1)
        self.cin = int(feat[-1])
        self.pads = []
        for size, k, s, d in zip(feat[:-1], self.kernel_size, self.strides, self.dilation):
            if padding == "same":
                self.pads.append(_same_pads(size, k, s, d))
            elif padding == "causal":          # Keras pads the start, then "valid"
                self.pads.append(((k - 1) * d, 0))
            else:
                self.pads.append((0, 0))
        self.out_feat = [_out_size(size, k, s, d, pd) for size, k, s, d, pd in
                         zip(feat[:-1], self.kernel_size, self.strides, self.dilation,
                             self.pads)] + [self.filters]

    def weight_shapes(self):
        shapes = [_Spec(f"{self.name}/kernel", self.kernel_size + (self.cin, self.filters),
                        self.kernel_init)]
        if self.use_bias:
            shapes.append(_Spec(f"{self.name}/bias", (self.filters,), self.bias_init))
        return shapes

    def __call__(self, p, h, training, gen, ntv_out):
        L, B, r = h.shape[0], h.shape[1], self.rank
        # [L, B, *S, C] -> [B, L * C, *S]
        x = h.permute((1, 0, r + 2) + tuple(range(2, r + 2)))
        x = x.reshape((B, L * self.cin) + tuple(h.shape[2:2 + r]))
        pad = [v for pair in reversed(self.pads) for v in pair]   # F.pad: last axis first
        if any(pad):
            x = F.pad(x, pad)
        # [L, *k, C, F] -> [L * F, C, *k]
        w = p[f"{self.name}/kernel"].permute((0, r + 2, r + 1) + tuple(range(1, r + 1)))
        w = w.reshape((L * self.filters, self.cin) + self.kernel_size)
        b = p[f"{self.name}/bias"].reshape(L * self.filters) if self.use_bias else None
        conv = F.conv2d if r == 2 else F.conv1d
        y = conv(x, w, b, self.strides, 0, self.dilation, L)
        # [B, L * F, *S'] -> [L, B, *S', F]
        y = y.reshape((B, L, self.filters) + tuple(y.shape[2:]))
        return self.act(y.permute((1, 0) + tuple(range(3, r + 3)) + (2,)))


class _MaxPool2D:
    def __init__(self, cfg: dict, feat):
        _channels_last("MaxPooling2D", cfg)
        self.pool = _ints(cfg.get("pool_size", 2), 2)
        self.strides = _ints(cfg.get("strides") or self.pool, 2)
        padding = str(cfg.get("padding", "valid")).lower()
        if padding not in ("valid", "same"):
            raise ValueError(f"MaxPooling2D {cfg.get('name')!r}: padding {padding!r}")
        feat = _need_feat("MaxPooling2D", cfg, feat, 3)
        self.pads = [_same_pads(size, k, s, 1) if padding == "same" else (0, 0)
                     for size, k, s in zip(feat[:2], self.pool, self.strides)]
        self.out_feat = [_out_size(size, k, s, 1, pd) for size, k, s, pd in
                         zip(feat[:2], self.pool, self.strides, self.pads)] + [feat[2]]

    def weight_shapes(self):
        return []

    def __call__(self, p, h, training, gen, ntv_out):
        L, B = h.shape[:2]
        x = h.reshape((L * B,) + tuple(h.shape[2:])).permute(0, 3, 1, 2)
        pad = [v for pair in reversed(self.pads) for v in pair]
        if any(pad):       # XLA's "SAME" window pads with -inf
            x = F.pad(x, pad, value=float("-inf"))
        y = F.max_pool2d(x, self.pool, self.strides)
        return y.permute(0, 2, 3, 1).reshape((L, B) + tuple(self.out_feat))


class _BatchNorm:
    """BatchNormalization over the last axis. In training it normalises by
    the batch's moments (the biased variance, as Keras) and moves the
    statistics ``m * momentum + batch * (1 - momentum)``; in inference it
    normalises by the moving statistics."""

    def __init__(self, cfg: dict, feat):
        self.name = cfg["name"]
        feat = _need_feat("BatchNormalization", cfg, feat)
        axis = cfg.get("axis", -1)
        if isinstance(axis, (list, tuple)):
            axis = axis[0] if len(axis) == 1 else None
        if axis not in (-1, len(feat)):
            raise _refuse(f"BatchNormalization axis={cfg.get('axis')!r} (the port "
                          f"normalises over the last axis)")
        if cfg.get("synchronized"):
            raise _refuse("BatchNormalization synchronized=True")
        if not cfg.get("trainable", True):
            raise _refuse("a frozen BatchNormalization (trainable=False)")
        self.momentum = float(cfg.get("momentum", 0.99))
        self.epsilon = float(cfg.get("epsilon", 1e-3))
        self.center = bool(cfg.get("center", True))
        self.scale = bool(cfg.get("scale", True))
        self.channels = int(feat[-1])
        self.inits = {k: cfg.get(f"{k}_initializer", d) for k, d in (
            ("gamma", "Ones"), ("beta", "Zeros"), ("moving_mean", "Zeros"),
            ("moving_variance", "Ones"))}

    def weight_shapes(self):
        c = (self.channels,)
        shapes = []
        if self.scale:
            shapes.append(_Spec(f"{self.name}/gamma", c, self.inits["gamma"]))
        if self.center:
            shapes.append(_Spec(f"{self.name}/beta", c, self.inits["beta"]))
        return shapes + [_Spec(f"{self.name}/{k}", c, self.inits[k], False)
                         for k in ("moving_mean", "moving_variance")]

    def __call__(self, p, h, training, gen, ntv_out):
        n = self.name
        mm, mv = p[f"{n}/moving_mean"], p[f"{n}/moving_variance"]
        if training:
            var, mean = torch.var_mean(h, dim=tuple(range(1, h.dim() - 1)), correction=0)
            if ntv_out is not None:
                ntv_out[f"{n}/moving_mean"] = (mm * self.momentum
                                               + mean.detach() * (1.0 - self.momentum))
                ntv_out[f"{n}/moving_variance"] = (mv * self.momentum
                                                   + var.detach() * (1.0 - self.momentum))
        else:
            mean, var = mm, mv
        # Keras's order: x * inv + (beta - mean * inv), inv = rsqrt(var + eps) * gamma
        inv = torch.rsqrt(var + self.epsilon)
        if self.scale:
            inv = inv * p[f"{n}/gamma"]
        res = -mean * inv
        if self.center:
            res = res + p[f"{n}/beta"]
        shape = (h.shape[0],) + (1,) * (h.dim() - 2) + (self.channels,)
        return h * inv.reshape(shape) + res.reshape(shape)


class _Embedding:
    """``[input_dim, output_dim]`` rows gathered by id. Float ids (the engine
    stages ``x`` as float32) are truncated to integers, as Keras casts
    them; an id outside ``[0, input_dim)`` raises :class:`ValueError`,
    where the reference's gather reads no row (a departure: on the card such
    an index would fault the device)."""

    def __init__(self, cfg: dict, feat):
        if cfg.get("mask_zero"):
            raise _refuse("Embedding mask_zero=True")
        self.name = cfg["name"]
        self.input_dim, self.output_dim = int(cfg["input_dim"]), int(cfg["output_dim"])
        self.init = cfg.get("embeddings_initializer", "RandomUniform")
        self.out_feat = None if feat is None else list(feat) + [self.output_dim]

    def weight_shapes(self):
        return [_Spec(f"{self.name}/embeddings", (self.input_dim, self.output_dim),
                      self.init)]

    def __call__(self, p, h, training, gen, ntv_out):
        ids = h.long()
        bad = (ids < 0) | (ids >= self.input_dim)
        if bool(bad.any()):
            raise ValueError(
                f"Embedding {self.name!r}: ids must lie in [0, {self.input_dim}); got "
                f"{int(ids[bad][0])}")
        L, V = h.shape[0], self.input_dim
        # replica l's rows follow replica l - 1's in one [L * V, D] table
        offsets = torch.arange(L, device=h.device).reshape((L,) + (1,) * (h.dim() - 1))
        return F.embedding(ids + offsets * V, p[f"{self.name}/embeddings"].reshape(
            L * V, self.output_dim))


class _LSTM:
    """Keras 3's LSTM: ``z = x @ kernel + h @ recurrent_kernel + bias``, gates
    i, f, c, o in that order, ``c = f * c + i * act(z_c)``, ``h = o *
    act(c)``, ``recurrent_activation`` on i, f and o; zero initial state;
    the last ``h`` or, with ``return_sequences``, every step's."""

    def __init__(self, cfg: dict, feat):
        for key in ("dropout", "recurrent_dropout"):
            if float(cfg.get(key) or 0.0) > 0.0:
                raise _refuse(f"LSTM {key}={cfg[key]}")
        for key in ("return_state", "go_backwards", "stateful"):
            if cfg.get(key):
                raise _refuse(f"LSTM {key}=True")
        self.name = cfg["name"]
        self.units = int(cfg["units"])
        self.act = _activation(cfg.get("activation", "tanh"))
        self.rec_act = _activation(cfg.get("recurrent_activation", "sigmoid"))
        self.use_bias = bool(cfg.get("use_bias", True))
        self.return_sequences = bool(cfg.get("return_sequences", False))
        feat = _need_feat("LSTM", cfg, feat, 2)
        self.in_dim = int(feat[-1])
        self.out_feat = ([feat[0], self.units] if self.return_sequences
                         else [self.units])
        self.kernel_init = cfg.get("kernel_initializer", "GlorotUniform")
        self.rec_init = cfg.get("recurrent_initializer", "Orthogonal")
        bias_init = cfg.get("bias_initializer", "Zeros")
        if cfg.get("unit_forget_bias", True):
            def forget_ones(shape, gen, u=self.units):
                # Keras: bias_init for i, ones for f, bias_init for c and o
                return torch.cat([_initial_value(bias_init, (u,), gen), torch.ones(u),
                                  _initial_value(bias_init, (2 * u,), gen)])
            self.bias_init = forget_ones
        else:
            self.bias_init = bias_init

    def weight_shapes(self):
        u4 = 4 * self.units
        shapes = [_Spec(f"{self.name}/kernel", (self.in_dim, u4), self.kernel_init),
                  _Spec(f"{self.name}/recurrent_kernel", (self.units, u4), self.rec_init)]
        if self.use_bias:
            shapes.append(_Spec(f"{self.name}/bias", (u4,), self.bias_init))
        return shapes

    def __call__(self, p, h, training, gen, ntv_out):
        L, B, T = h.shape[:3]
        u = self.units
        xz = torch.bmm(h.reshape(L, B * T, self.in_dim), p[f"{self.name}/kernel"])
        if self.use_bias:
            xz = xz + p[f"{self.name}/bias"][:, None, :]
        xz = xz.reshape(L, B, T, 4 * u)
        rk = p[f"{self.name}/recurrent_kernel"]
        hs = h.new_zeros((L, B, u))
        cs = h.new_zeros((L, B, u))
        outs = []
        for t in range(T):
            z = torch.baddbmm(xz[:, :, t], hs, rk)
            gates = self.rec_act(z)            # i, f and o (c's quarter unused)
            cs = gates[..., u:2 * u] * cs + gates[..., :u] * self.act(z[..., 2 * u:3 * u])
            hs = gates[..., 3 * u:] * self.act(cs)
            if self.return_sequences:
                outs.append(hs)
        return torch.stack(outs, dim=2) if self.return_sequences else hs


def _parse_sequential(arch: dict, weight_shapes: Optional[List[Tuple[int, ...]]]):
    """The layer ops of a Keras-3 Sequential config. Input shapes come from
    the config (InputLayer, build shapes, each layer's ``build_config``) or,
    for a Dense layer failing those, from the kernels' shapes in
    ``weight_shapes``."""
    if arch.get("class_name") != "Sequential":
        raise NotImplementedError(
            f"model class {arch.get('class_name')!r}: the port interprets Sequential "
            f"models; Functional models wait for {LAYERS_ITEM}")
    cfg = arch.get("config", {})
    policy = cfg.get("dtype")
    if isinstance(policy, dict):
        policy = (policy.get("config") or {}).get("name")
    if policy not in (None, "float32"):
        raise _refuse(f"dtype policy {policy!r}")
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
        build = (layer.get("build_config") or {}).get("input_shape")
        if build:
            feat = list(build[1:])
        if cls == "Dense":
            in_dim = next(kernel_in, None)
            if feat is None:
                if in_dim is None:
                    raise ValueError(f"Dense layer {lcfg.get('name')!r}: the config has "
                                     f"no input shape and no weights were given")
                feat = [in_dim]
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
        elif cls in ("Reshape", "Conv1D", "Conv2D", "MaxPooling2D", "Embedding", "LSTM"):
            op = {"Reshape": _Reshape, "MaxPooling2D": _MaxPool2D,
                  "Embedding": _Embedding, "LSTM": _LSTM,
                  "Conv1D": lambda c, f: _Conv(c, f, 1),
                  "Conv2D": lambda c, f: _Conv(c, f, 2)}[cls](lcfg, feat)
            feat = op.out_feat
        elif cls == "BatchNormalization":
            op = _BatchNorm(lcfg, feat)
        else:
            raise _refuse(f"layer {cls!r}")
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
        if weights is None:
            gen = torch.Generator().manual_seed(int(seed))
            weights = [_initial_value(s.init, s.shape, gen) for s in self._specs]
        self.set_weights(weights)

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

    # -- state conversion --------------------------------------------------
    def get_weights(self) -> List[np.ndarray]:
        return [w.detach().cpu().numpy() for w in self.state_to_weights(self._tv, self._ntv)]

    def set_weights(self, weights: Sequence) -> None:
        self._tv, self._ntv = self.weights_to_state(weights)

    def state_values(self) -> Tuple[Params, Params]:
        """The current ``(trainable, non_trainable)`` values, each a dict by
        name, on the device."""
        return dict(self._tv), dict(self._ntv)

    def weights_to_state(self, flat: Sequence) -> Tuple[Params, Params]:
        """A flat ``get_weights()`` list → ``(tv, ntv)``, float32 on the
        adapter's device, each array's shape checked."""
        flat = list(flat)
        if len(flat) != len(self._specs):
            raise ValueError(f"expected {len(self._specs)} weight arrays, got {len(flat)}")
        tv, ntv = {}, {}
        for spec, w in zip(self._specs, flat):
            t = (w if isinstance(w, torch.Tensor) else
                 torch.as_tensor(np.asarray(w, dtype=np.float32)))
            t = t.to(device=self.device, dtype=torch.float32)
            if tuple(t.shape) != tuple(spec.shape):
                raise ValueError(f"{spec.name}: shape {tuple(t.shape)}, want "
                                 f"{tuple(spec.shape)}")
            (tv if spec.trainable else ntv)[spec.name] = t
        return tv, ntv

    def state_to_weights(self, tv: Params, ntv: Params) -> List[torch.Tensor]:
        """``(tv, ntv)`` → a flat list in ``get_weights()`` order."""
        return [(tv if s.trainable else ntv)[s.name] for s in self._specs]

    def install_state(self, tv: Params, ntv: Params) -> None:
        """Take ``(tv, ntv)`` (device tensors, as the engine returns them) as
        the current values."""
        self._tv = {s.name: tv[s.name] for s in self._specs if s.trainable}
        self._ntv = {s.name: ntv[s.name] for s in self._specs if not s.trainable}

    # -- the model -------------------------------------------------------
    def _forward(self, params: Params, x, training: bool, generator, ntv_out):
        h = x
        for op in self.layers:
            h = op(params, h, training, generator, ntv_out)
        return h

    def apply(self, params: Params, x, training: bool = False,
              generator: Optional[torch.Generator] = None):
        """The model over a replica stack: ``params`` ``[L, ...]`` (the
        trainable and non-trainable values, by name), ``x`` ``[L, B, ...]`` →
        ``[L, B, ...]``."""
        return self._forward(params, x, training, generator, None)

    def stateless_call(self, tv: Params, ntv: Params, x, training: bool = False,
                       generator: Optional[torch.Generator] = None):
        """Keras's ``stateless_call`` over a replica stack: ``(y, ntv2)``,
        ``ntv2`` the statistics that training moved (``ntv`` otherwise)."""
        ntv2 = dict(ntv)
        y = self._forward({**tv, **ntv}, x, training, generator, ntv2 if training else None)
        return y, ntv2

    def predict(self, x, batch_size: int = 32, verbose: int = 0) -> np.ndarray:
        """Keras ``model.predict``: the current weights over ``x`` in batches
        of ``batch_size`` rows on the adapter's device."""
        predict_fn = self.build_predict_fn()
        tv, ntv = ({k: v[None] for k, v in d.items()} for d in self.state_values())
        x = np.asarray(x, dtype=np.float32)
        outs = []
        for i in range(0, x.shape[0], int(batch_size)):
            xb = torch.as_tensor(x[i:i + int(batch_size)]).to(self.device)
            outs.append(predict_fn(tv, ntv, xb[None])[0].cpu().numpy())
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
        """``(tv, ntv, opt_state, x, y, sw, gen) → (tv, ntv, opt_state,
        stats)`` over ``L`` replicas: ``tv`` and ``ntv`` ``[L, ...]``, ``x``
        ``[L, B, ...]``, ``sw`` ``[L, B]``. ``stats`` is
        ``(loss_weighted_sum, acc_weighted_sum, weight_sum)``, each ``[L]``.
        A replica whose batch is all padding keeps its parameters,
        statistics and optimizer state. ``remat`` is the reference's
        ``jax.checkpoint`` switch, accepted in its place; as in
        ``CompiledTrainer``, ``True`` is not ported yet and raises."""
        refuse_remat(remat)
        per_and_acc = self._loss_parts()

        def train_step(tv, ntv, opt_state, x, y, sw, gen):
            leaves = {k: t.detach().requires_grad_() for k, t in tv.items()}
            with torch.enable_grad():
                y_pred, ntv2 = self.stateless_call(leaves, ntv, x, True, gen)
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
                ntv2 = _tree_where(valid, ntv2, ntv)
                opt2 = _tree_where(valid, opt2, opt_state)
                stats = (torch.where(valid, loss * wsum, 0.0), acc, wsum)
            return tv2, ntv2, opt2, stats

        return train_step

    def build_grad_step(self, remat: bool = False) -> Callable:
        """``(tv, ntv, x, y, sw, gen) → (grads, ntv2, stats)``: gradients of
        the sample-weighted loss SUM over every replica's batch on the
        SHARED parameters ``tv`` (no replica axis), without an update; the
        caller divides by the global weight sum and steps once. ``ntv`` is
        per replica (``[L, ...]``): each replica normalises over its own
        ``B`` rows and moves its own statistics, as the reference's
        ``vmap`` of the step over workers does; a replica whose batch is all
        padding keeps them. ``remat`` as in :meth:`build_train_step`."""
        refuse_remat(remat)
        per_and_acc = self._loss_parts()
        keep_replicas = any(not s.trainable for s in self._specs)

        def grad_step(tv, ntv, x, y, sw, gen):
            L, B = sw.shape
            leaves = {k: t.detach().requires_grad_() for k, t in tv.items()}
            with torch.enable_grad():
                if keep_replicas:
                    stacked = {k: v[None].expand((L,) + tuple(v.shape))
                               for k, v in leaves.items()}
                    y_pred, ntv2 = self.stateless_call(stacked, ntv, x, True, gen)
                else:
                    # no layer couples rows: one replica of L * B rows, the
                    # same rows and masks, one matmul a layer
                    flat = x.reshape((1, L * B) + tuple(x.shape[2:]))
                    y_pred, ntv2 = self.stateless_call(
                        {k: v[None] for k, v in leaves.items()}, {}, flat, True, gen)
                    y_pred = y_pred.reshape((L, B) + tuple(y_pred.shape[2:]))
                per, acc = per_and_acc(y, y_pred, sw)
                loss_wsum = (per * sw).sum(dim=1)
                grads = torch.autograd.grad(loss_wsum.sum(), list(leaves.values()))
            wsum = sw.sum(dim=1)
            ntv2 = _tree_where(wsum > 0, ntv2, ntv) if keep_replicas else ntv
            return dict(zip(leaves, grads)), ntv2, (loss_wsum.detach(), acc, wsum)

        return grad_step

    def build_eval_step(self) -> Callable:
        """``(tv, ntv, x, y, sw) → (loss_wsum, acc_wsum, wsum)``, each ``[L]``."""
        per_and_acc = self._loss_parts()

        @torch.no_grad()
        def eval_step(tv, ntv, x, y, sw):
            y_pred, _ = self.stateless_call(tv, ntv, x, False)
            per, acc = per_and_acc(y, y_pred, sw)
            return (per * sw).sum(dim=1), acc, sw.sum(dim=1)

        return eval_step

    def build_predict_fn(self) -> Callable:
        @torch.no_grad()
        def predict_fn(tv, ntv, x):
            return self.stateless_call(tv, ntv, x, False)[0]

        return predict_fn
