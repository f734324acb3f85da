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

What it interprets: a ``Sequential`` model, or a ``Functional`` one of one
input and one output (a graph walked node by node; a layer called at
several nodes runs each call with its one set of weights; a model nested
as a layer of either, to any depth, its calls walked in its caller's
graph; a layer's outputs past the first, a recurrent layer's
``initial_state``), of
``InputLayer``, ``Dense`` (the activations Keras names), ``Dropout``
(``noise_shape`` too), ``Activation``, ``Flatten``, ``Reshape``,
``Conv1D`` and ``Conv2D`` (``valid``, ``same`` and, for Conv1D,
``causal`` padding; strides, dilation, ``groups``), the max and average
poolings and the global ones (1-D and 2-D), ``ZeroPadding1D`` and
``ZeroPadding2D`` (convolutions, poolings and paddings in either
``data_format``), ``BatchNormalization`` (over any one axis; frozen, it
runs in inference mode), the merges ``Add``, ``Subtract``, ``Multiply``,
``Average``, ``Maximum``, ``Minimum`` and ``Concatenate``, ``Embedding``
(``mask_zero`` too) and the recurrent ``LSTM``, ``GRU`` (both
``reset_after``) and ``SimpleRNN`` (``go_backwards``, ``return_sequences``,
``return_state``, ``stateful``), masks handed on as Keras 3.13 hands them,
with Keras's weight order and layouts (kernel
``[in, out]`` / ``[*kernel_size, in / groups, out]``, then bias; gamma,
beta, moving mean, moving variance; LSTM gates i, f, c, o; GRU gates z, r,
h). A layer with ``trainable=False`` keeps its weights out of training, as
Keras does. Anything else raises :class:`NotImplementedError` naming the
layer or option and the ROADMAP item it waits for (a model of several
inputs or outputs: that the reference's entry points do not take one
either). As in the reference's
``stateless_call`` path, regularizers and constraints play no part in
training. Without weights it initialises from the config's initializers
(the VarianceScaling family, Orthogonal, the constants, LSTM's
``unit_forget_bias``) with an explicit ``torch.Generator``, as
``model_from_json`` would (same distributions, other bits).

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
import torch.utils.checkpoint

from .. import resolve_device
from .losses import (metric_name, metric_results, metric_state, resolve_accuracy,
                     resolve_metric, resolve_per_sample_loss)
from .stateful_metrics import result_value
from .optimizers import _tree_where, loss_scale_spec, to_torch_optimizer

Params = Dict[str, torch.Tensor]

# the ROADMAP item each refused part of a Keras model waits for
LAYERS_ITEM = ("ROADMAP queue 1 item 13 (Keras models beyond the layers, graphs and "
               "options the port interprets)")

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
    "celu": F.celu,
    "glu": lambda h: F.glu(h, dim=-1),
    "hard_shrink": lambda h: F.hardshrink(h, 0.5),
    "hard_tanh": F.hardtanh,
    "log_sigmoid": F.logsigmoid,
    "soft_shrink": lambda h: F.softshrink(h, 0.5),
    "sparse_plus": lambda h: torch.where(h <= -1.0, torch.zeros_like(h), torch.where(
        h >= 1.0, h, torch.square(h + 1.0) / 4)),
    "sparse_sigmoid": lambda h: 0.5 * torch.clamp(h + 1.0, 0.0, 2.0),
    "sparsemax": lambda h: _sparsemax(h),
    "squareplus": lambda h: (h + torch.sqrt(torch.square(h) + 4)) / 2,
    "tanh_shrink": lambda h: h - torch.tanh(h),
}


def _sparsemax(h):
    """Keras's sparsemax over the last axis: the projection onto the
    simplex, ``max(h - tau, 0)`` with ``tau`` from the sorted values'
    running sums."""
    z = torch.sort(h, dim=-1, descending=True).values
    cum = torch.cumsum(z, dim=-1)
    r = torch.arange(1, h.shape[-1] + 1, device=h.device, dtype=h.dtype)
    support = z - (cum - 1) / r > 0
    k = support.sum(dim=-1, keepdim=True).to(h.dtype)
    tau = (torch.where(support, cum, torch.zeros_like(cum)).sum(dim=-1, keepdim=True) - 1) / k
    return torch.clamp(h - tau, min=0.0)


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
    "identity": "Identity", "IdentityInitializer": "Identity",
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
    if cls == "Identity":
        if len(shape) != 2:
            raise ValueError(f"the Identity initializer takes a 2-D shape, got {shape}")
        return float(cfg.get("gain", 1.0)) * torch.eye(*shape, dtype=torch.float32)
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
# statistics into ``ntv_out`` when that is a dict. A merge layer takes a
# list of such tensors. A layer of several outputs (a recurrent layer with
# ``return_state``) returns a tuple, ``n_outputs`` long, whose feature
# shapes are ``out_feats``. Masks follow Keras 3.13: an op with
# ``uses_mask`` takes its input's mask (a merge: the list of them) as
# ``mask=``; :meth:`_Op.output_masks` is Keras's ``compute_mask``, which
# hands the mask on in a layer that ``supports_masking`` and drops it in
# any other (Keras warns there and goes on). ``dtype`` is the compute
# dtype of the layer's dtype policy: under a mixed policy the model casts
# an op's floating inputs to it (``autocast``) and its weights
# (``cast_weights``) before the call, as Keras's layer call and its
# autocast scope do.


class _Spec(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    init: Any
    trainable: bool = True


class _Op:
    """No weights, one input, one output; a mask dropped."""
    supports_masking = False
    uses_mask = False
    merge = False
    n_outputs = 1
    out_feat = None
    dtype = torch.float32
    autocast = True
    cast_weights = True

    @property
    def out_feats(self):
        return [self.out_feat]

    def weight_shapes(self):
        return []

    def output_masks(self, hs, masks) -> list:
        """Keras's ``compute_mask``: the mask of each output, from the
        inputs ``hs`` and their masks (None where unmasked)."""
        return [masks[0] if self.supports_masking else None]


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


def _channels_first(cls: str, cfg: dict) -> bool:
    fmt = cfg.get("data_format") or "channels_last"
    if fmt not in ("channels_last", "channels_first"):
        raise ValueError(f"{cls} {cfg.get('name')!r}: data_format {fmt!r}")
    return fmt == "channels_first"


def _split_channels(feat, first: bool) -> Tuple[int, List[int]]:
    """``(channels, spatial sizes)`` of a feature shape."""
    return (int(feat[0]), list(feat[1:])) if first else (int(feat[-1]), list(feat[:-1]))


def _join_channels(c: int, spatial, first: bool) -> List[int]:
    return [c] + list(spatial) if first else list(spatial) + [c]


def _to_ncs(h, rank: int, first: bool):
    """``[L, B, *feat]`` → ``[L * B, C, *S]``."""
    x = h.reshape((h.shape[0] * h.shape[1],) + tuple(h.shape[2:]))
    return x if first else x.permute((0, rank + 1) + tuple(range(1, rank + 1)))


def _from_ncs(y, L: int, B: int, rank: int, first: bool):
    """``[L * B, C, *S]`` → ``[L, B, *feat]``."""
    if not first:
        y = y.permute((0,) + tuple(range(2, rank + 2)) + (1,))
    return y.reshape((L, B) + tuple(y.shape[1:]))


def _flat_pad(pads) -> List[int]:
    """Per-axis ``(before, after)`` pairs as ``F.pad`` takes them (last axis
    first)."""
    return [v for pair in reversed(pads) for v in pair]


class _Dense(_Op):
    supports_masking = True

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


class _Dropout(_Op):
    """Inverted dropout, as ``keras.random.dropout``: keep ``1 - rate``, scale
    the kept values by ``1 / (1 - rate)``. One draw over the whole replica
    stack, so every replica gets its own mask; with ``noise_shape`` the
    mask is drawn at that shape (``None`` axes take the input's size) and
    broadcast over the others, per replica."""
    supports_masking = True

    def __init__(self, cfg: dict):
        self.rate = float(cfg.get("rate", 0.0))
        ns = cfg.get("noise_shape")
        self.noise_shape = None if ns is None else tuple(None if v is None else int(v)
                                                         for v in ns)

    def __call__(self, p, h, training, gen, ntv_out):
        if not training or self.rate <= 0.0:
            return h
        keep = 1.0 - self.rate
        shape = h.shape
        if self.noise_shape is not None:
            if len(self.noise_shape) != h.dim() - 1:
                raise ValueError(f"Dropout noise_shape {self.noise_shape} for inputs of "
                                 f"{h.dim() - 1} axes")
            shape = (h.shape[0],) + tuple(h.shape[i + 1] if v is None else v
                                          for i, v in enumerate(self.noise_shape))
        mask = torch.rand(shape, generator=gen, device=h.device) < keep
        return torch.where(mask, h / keep, torch.zeros_like(h))


class _Activation(_Op):
    supports_masking = True

    def __init__(self, cfg: dict):
        self.act = _activation(cfg.get("activation"))

    def __call__(self, p, h, training, gen, ntv_out):
        return self.act(h)


class _Flatten(_Op):
    """Every feature axis in one; ``channels_first`` moves the channels last
    first, as Keras does."""

    def __init__(self, cfg: dict, feat=None):
        self.first = _channels_first("Flatten", cfg)
        self.out_feat = None if feat is None else [int(np.prod(feat))]

    def __call__(self, p, h, training, gen, ntv_out):
        if self.first and h.dim() > 3:
            h = h.permute((0, 1) + tuple(range(3, h.dim())) + (2,))
        return h.reshape(h.shape[0], h.shape[1], -1)


class _Reshape(_Op):
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

    def __call__(self, p, h, training, gen, ntv_out):
        return h.reshape(tuple(h.shape[:2]) + self.target)


class _Conv(_Op):
    """Conv1D (``rank`` 1) and Conv2D (``rank`` 2), kernel ``[*kernel_size,
    in / groups, filters]``. The replicas run as one grouped convolution:
    replica ``l``'s group ``g`` is group ``l * groups + g``."""

    def __init__(self, cfg: dict, feat, rank: int):
        cls = f"Conv{rank}D"
        self.first = _channels_first(cls, cfg)
        self.name, self.rank = cfg["name"], rank
        self.groups = int(cfg.get("groups", 1))
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
        self.cin, spatial = _split_channels(_need_feat(cls, cfg, feat, rank + 1), self.first)
        if self.cin % self.groups or self.filters % self.groups:
            raise ValueError(f"{cls} {self.name!r}: groups {self.groups} does not divide "
                             f"{self.cin} input channels and {self.filters} filters")
        self.pads = []
        for size, k, s, d in zip(spatial, self.kernel_size, self.strides, self.dilation):
            if padding == "same":
                self.pads.append(_same_pads(size, k, s, d))
            elif padding == "causal":          # Keras pads the start, then "valid"
                self.pads.append(((k - 1) * d, 0))
            else:
                self.pads.append((0, 0))
        out = [_out_size(size, k, s, d, pd) for size, k, s, d, pd in
               zip(spatial, self.kernel_size, self.strides, self.dilation, self.pads)]
        self.out_feat = _join_channels(self.filters, out, self.first)

    def weight_shapes(self):
        shapes = [_Spec(f"{self.name}/kernel",
                        self.kernel_size + (self.cin // self.groups, self.filters),
                        self.kernel_init)]
        if self.use_bias:
            shapes.append(_Spec(f"{self.name}/bias", (self.filters,), self.bias_init))
        return shapes

    def __call__(self, p, h, training, gen, ntv_out):
        L, B, r = h.shape[0], h.shape[1], self.rank
        # [L, B, *S, C] (or [L, B, C, *S]) -> [B, L * C, *S]
        if self.first:
            x = h.transpose(0, 1)
            spatial = tuple(h.shape[3:3 + r])
        else:
            x = h.permute((1, 0, r + 2) + tuple(range(2, r + 2)))
            spatial = tuple(h.shape[2:2 + r])
        x = x.reshape((B, L * self.cin) + spatial)
        pad = _flat_pad(self.pads)
        if any(pad):
            x = F.pad(x, pad)
        # [L, *k, C / g, F] -> [L * F, C / g, *k]
        w = p[f"{self.name}/kernel"].permute((0, r + 2, r + 1) + tuple(range(1, r + 1)))
        w = w.reshape((L * self.filters, self.cin // self.groups) + self.kernel_size)
        b = p[f"{self.name}/bias"].reshape(L * self.filters) if self.use_bias else None
        conv = F.conv2d if r == 2 else F.conv1d
        y = conv(x, w, b, self.strides, 0, self.dilation, L * self.groups)
        # [B, L * F, *S'] -> [L, B, *S', F] (or [L, B, F, *S'])
        y = y.reshape((B, L, self.filters) + tuple(y.shape[2:]))
        if self.first:
            return self.act(y.transpose(0, 1))
        return self.act(y.permute((1, 0) + tuple(range(3, r + 3)) + (2,)))


class _Pool(_Op):
    """MaxPooling1D/2D and AveragePooling1D/2D. ``"same"`` padding as XLA's
    windows: a max over the cells inside the image (``-inf`` padding), an
    average over the cells inside the image only (the window's sum over
    its count of real cells)."""

    def __init__(self, cfg: dict, feat, rank: int, kind: str):
        cls = f"{'Max' if kind == 'max' else 'Average'}Pooling{rank}D"
        self.first, self.rank, self.kind = _channels_first(cls, cfg), rank, kind
        self.pool = _ints(cfg.get("pool_size", 2), rank)
        self.strides = _ints(cfg.get("strides") or self.pool, rank)
        padding = str(cfg.get("padding", "valid")).lower()
        if padding not in ("valid", "same"):
            raise ValueError(f"{cls} {cfg.get('name')!r}: padding {padding!r}")
        c, spatial = _split_channels(_need_feat(cls, cfg, feat, rank + 1), self.first)
        self.pads = [_same_pads(size, k, s, 1) if padding == "same" else (0, 0)
                     for size, k, s in zip(spatial, self.pool, self.strides)]
        out = [_out_size(size, k, s, 1, pd) for size, k, s, pd in
               zip(spatial, self.pool, self.strides, self.pads)]
        self.out_feat = _join_channels(c, out, self.first)

    def __call__(self, p, h, training, gen, ntv_out):
        L, B = h.shape[:2]
        x = _to_ncs(h, self.rank, self.first)
        # 1-D windows run as 2-D ones over a unit height
        pool, strides, pads = self.pool, self.strides, self.pads
        if self.rank == 1:
            x, pool, strides, pads = x[:, :, None], (1,) + pool, (1,) + strides, [(0, 0)] + pads
        pad = _flat_pad(pads)
        if self.kind == "max":
            if any(pad):
                x = F.pad(x, pad, value=float("-inf"))
            y = F.max_pool2d(x, pool, strides)
        elif any(pad):
            total = F.avg_pool2d(F.pad(x, pad), pool, strides, divisor_override=1)
            ones = F.pad(torch.ones_like(x[:1, :1]), pad)
            y = total / F.avg_pool2d(ones, pool, strides, divisor_override=1)
        else:
            y = F.avg_pool2d(x, pool, strides)
        if self.rank == 1:
            y = y[:, :, 0]
        return _from_ncs(y, L, B, self.rank, self.first)


class _GlobalPool(_Op):
    """GlobalAveragePooling1D/2D and GlobalMaxPooling1D/2D (``keepdims``).
    GlobalAveragePooling1D takes a mask as Keras does, a mean over the
    unmasked steps, and makes none; the others drop it (Keras's plain max
    or mean over every step)."""

    def __init__(self, cfg: dict, feat, rank: int, kind: str):
        cls = f"Global{'Max' if kind == 'max' else 'Average'}Pooling{rank}D"
        self.first, self.kind = _channels_first(cls, cfg), kind
        self.uses_mask = self.supports_masking = kind == "avg" and rank == 1
        self.keepdims = bool(cfg.get("keepdims", False))
        c, _ = _split_channels(_need_feat(cls, cfg, feat, rank + 1), self.first)
        self.axes = tuple(range(3, rank + 3)) if self.first else tuple(range(2, rank + 2))
        self.out_feat = (_join_channels(c, [1] * rank, self.first) if self.keepdims
                         else [c])

    def output_masks(self, hs, masks):
        return [None]

    def __call__(self, p, h, training, gen, ntv_out, mask=None):
        if self.kind == "max":
            return torch.amax(h, dim=self.axes, keepdim=self.keepdims)
        if mask is None:
            return torch.mean(h, dim=self.axes, keepdim=self.keepdims)
        # Keras: inputs * mask summed over the steps, over the mask's sum
        m = mask.to(h.dtype).unsqueeze(2 if self.first else 3)
        return (torch.sum(h * m, dim=self.axes, keepdim=self.keepdims)
                / torch.sum(m, dim=self.axes, keepdim=self.keepdims))


def _pad_pairs(padding, rank: int) -> List[Tuple[int, int]]:
    """A ZeroPadding layer's ``padding`` as ``(before, after)`` per axis."""
    if isinstance(padding, int):
        return [(padding, padding)] * rank
    padding = list(padding)
    if rank == 1:
        return [(int(padding[0]), int(padding[1]))]
    return [(int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))
            for v in padding]


class _ZeroPad(_Op):
    """ZeroPadding1D/2D: zeros around the spatial axes."""

    def __init__(self, cfg: dict, feat, rank: int):
        cls = f"ZeroPadding{rank}D"
        first = _channels_first(cls, cfg)
        self.pairs = _pad_pairs(cfg.get("padding", 1), rank)
        c, spatial = _split_channels(_need_feat(cls, cfg, feat, rank + 1), first)
        self.out_feat = _join_channels(
            c, [s + a + b for s, (a, b) in zip(spatial, self.pairs)], first)
        # F.pad's list, last axis first; the channels axis (last) unpadded
        self.pad = _flat_pad(self.pairs) if first else [0, 0] + _flat_pad(self.pairs)

    def __call__(self, p, h, training, gen, ntv_out):
        return F.pad(h, self.pad)


def _or_masks(masks):
    """The merges' ``compute_mask``: the masks OR-ed, None unless every
    input has one."""
    if any(m is None for m in masks):
        return None
    out = masks[0]
    for m in masks[1:]:
        out = out | m
    return out


class _Merge(_Op):
    """Add, Subtract, Multiply, Average, Maximum and Minimum over a list of
    inputs of one shape, folded left to right as Keras folds them. With
    masks: Maximum and Minimum fold each masked input's step in only where
    it is unmasked (Keras's ``_apply_merge_op_and_or_mask``), Multiply
    takes 1 for a masked step and, when every input has a mask, 0 where
    none is set; the output's mask is the inputs' OR-ed when every input
    has one."""
    merge = True
    supports_masking = uses_mask = True

    def __init__(self, cls: str, cfg: dict, feats):
        if feats and len({len(f) for f in feats if f is not None}) > 1:
            raise _refuse(f"{cls} {cfg.get('name')!r} over inputs of different ranks "
                          f"{feats}")
        self.cls = cls

    def output_masks(self, hs, masks):
        return [_or_masks(masks)]

    def __call__(self, p, hs, training, gen, ntv_out, mask=None):
        masks = [None] * len(hs) if mask is None else [
            None if m is None else m[..., None].expand(h.shape) for m, h in zip(mask, hs)]
        if self.cls == "Subtract":
            if len(hs) != 2:
                raise ValueError(f"Subtract takes 2 inputs, got {len(hs)}")
            return hs[0] - hs[1]
        if self.cls in ("Maximum", "Minimum") and any(m is not None for m in masks):
            fold = torch.maximum if self.cls == "Maximum" else torch.minimum
            out, out_mask = hs[0], masks[0]
            for h, m in zip(hs[1:], masks[1:]):
                if m is not None:
                    h = torch.where(m, h, out)
                if out_mask is not None:
                    out = torch.where(out_mask, out, h)
                out_mask = out_mask | m if m is not None and out_mask is not None else None
                out = fold(out, h)
            return out
        if self.cls == "Multiply" and any(m is not None for m in masks):
            out, out_mask = None, None
            every = all(m is not None for m in masks)
            for h, m in zip(hs, masks):
                if m is not None:
                    h = torch.where(m, h, torch.ones_like(h))
                    if every:
                        out_mask = m if out_mask is None else out_mask | m
                out = h if out is None else out * h
            return torch.where(out_mask, out, torch.zeros_like(out)) if every else out
        fold = {"Add": torch.add, "Average": torch.add, "Multiply": torch.mul,
                "Maximum": torch.maximum, "Minimum": torch.minimum}[self.cls]
        out = hs[0]
        for h in hs[1:]:
            out = fold(out, h)
        return out / len(hs) if self.cls == "Average" else out


class _Concatenate(_Op):
    """Concatenate along Keras's ``axis`` (counted with the batch axis): a
    non-negative axis ``k`` is axis ``k + 1`` of the replica stack. Its
    mask is Keras's: each input's mask (all set where it has none)
    broadcast to the input's shape, concatenated along the axis, any over
    the last axis."""
    merge = True
    supports_masking = True

    def output_masks(self, hs, masks):
        if all(m is None for m in masks):
            return [None]
        full = [torch.ones_like(h, dtype=torch.bool) if m is None else
                (m[..., None] | torch.zeros_like(h, dtype=torch.bool))
                if m.dim() < h.dim() else m for h, m in zip(hs, masks)]
        return [torch.cat(full, dim=self.axis).any(dim=-1)]

    def __init__(self, cfg: dict):
        axis = int(cfg.get("axis", -1))
        if axis == 0:
            raise ValueError(f"Concatenate {cfg.get('name')!r}: axis 0 is the batch")
        self.axis = axis + 1 if axis > 0 else axis

    def __call__(self, p, hs, training, gen, ntv_out):
        return torch.cat(list(hs), dim=self.axis)


class _BatchNorm(_Op):
    """BatchNormalization over one axis (Keras's ``axis``, counted with the
    batch axis). In training it normalises by the batch's moments over
    every other axis (the biased variance, as Keras) and moves the
    statistics ``m * momentum + batch * (1 - momentum)``; in inference, and
    always when frozen (``trainable=False``, as Keras 3), it normalises by
    the moving statistics. Under a mixed policy it computes in float32 from
    its float32 weights and returns the compute dtype, as Keras does. A
    mask (one axis fewer than the input) weights the batch's moments as
    Keras's ``_moments`` weights them and is handed on."""
    cast_weights = False
    supports_masking = uses_mask = True

    def __init__(self, cfg: dict, feat):
        self.name = cfg["name"]
        feat = _need_feat("BatchNormalization", cfg, feat)
        axis = cfg.get("axis", -1)
        if isinstance(axis, (list, tuple)):
            if len(axis) != 1:
                raise NotImplementedError(
                    f"BatchNormalization axis={axis!r}: Keras's constructor refuses a list "
                    f"axis of more than one (it takes int(axis)), so no Keras JSON carries "
                    f"one and the reference's entry points do not take it either")
            axis = axis[0]
        ndim = len(feat) + 1
        axis = int(axis) + ndim if int(axis) < 0 else int(axis)
        if not 1 <= axis < ndim:
            raise ValueError(f"BatchNormalization {self.name!r}: axis {cfg.get('axis')!r} "
                             f"for inputs of {ndim} axes")
        if cfg.get("synchronized"):
            raise _refuse("BatchNormalization synchronized=True")
        self.frozen = not cfg.get("trainable", True)
        self.momentum = float(cfg.get("momentum", 0.99))
        self.epsilon = float(cfg.get("epsilon", 1e-3))
        self.center = bool(cfg.get("center", True))
        self.scale = bool(cfg.get("scale", True))
        self.channels = int(feat[axis - 1])
        self.axis = axis + 1                  # in the replica stack [L, B, *feat]
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

    def _masked_moments(self, h, mask, dims):
        """Keras's ``_moments`` with a mask: the mask broadcast over the
        last axis, a weighted mean and variance (of the weighted inputs
        about it) over the weights' sum plus Keras's epsilon."""
        if mask.dim() != h.dim() - 1:
            raise ValueError(f"BatchNormalization {self.name!r}: the mask provided should "
                             f"be one dimension less than the inputs")
        w = mask.to(h.dtype)[..., None].expand(h.shape)
        wx = w * h
        total = torch.sum(w, dim=dims, keepdim=True) + 1e-7
        mean = torch.sum(wx, dim=dims, keepdim=True) / total
        var = torch.sum(w * torch.square(wx - mean), dim=dims, keepdim=True) / total
        shape = (h.shape[0], self.channels)
        return var.reshape(shape), mean.reshape(shape)

    def __call__(self, p, h, training, gen, ntv_out, mask=None):
        n = self.name
        # Keras: result_type(inputs, float32), float32 for a 16-bit input
        out_dtype, h = h.dtype, h.to(torch.promote_types(h.dtype, torch.float32))
        # a layer called twice reads the statistics its first call moved
        moved = ntv_out if ntv_out is not None else {}
        mm = moved.get(f"{n}/moving_mean", p[f"{n}/moving_mean"])
        mv = moved.get(f"{n}/moving_variance", p[f"{n}/moving_variance"])
        if training and not self.frozen:
            dims = tuple(d for d in range(1, h.dim()) if d != self.axis)
            var, mean = (torch.var_mean(h, dim=dims, correction=0) if mask is None
                         else self._masked_moments(h, mask, dims))
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
        shape = [h.shape[0]] + [1] * (h.dim() - 1)
        shape[self.axis] = self.channels
        return (h * inv.reshape(shape) + res.reshape(shape)).to(out_dtype)


class _Embedding(_Op):
    """``[input_dim, output_dim]`` rows gathered by id. Float ids (the engine
    stages ``x`` as float32) are truncated to integers, as Keras casts
    them; an id outside ``[0, input_dim)`` raises :class:`ValueError`,
    where the reference's gather reads no row (a departure: on the card such
    an index would fault the device). With ``mask_zero`` it makes Keras's
    mask, ``ids != 0`` on the ids as given. Its ids are not cast to the
    compute dtype (Keras's Embedding does not autocast); its rows are
    gathered in float32 and cast to it."""
    autocast = False
    cast_weights = False

    def __init__(self, cfg: dict, feat):
        self.name = cfg["name"]
        self.mask_zero = bool(cfg.get("mask_zero"))
        self.input_dim, self.output_dim = int(cfg["input_dim"]), int(cfg["output_dim"])
        self.init = cfg.get("embeddings_initializer", "RandomUniform")
        self.out_feat = None if feat is None else list(feat) + [self.output_dim]

    def weight_shapes(self):
        return [_Spec(f"{self.name}/embeddings", (self.input_dim, self.output_dim),
                      self.init)]

    @staticmethod
    def compute_mask(h):
        return h != 0

    def output_masks(self, hs, masks):
        return [self.compute_mask(hs[0]) if self.mask_zero else None]

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
        out = F.embedding(ids + offsets * V, p[f"{self.name}/embeddings"].reshape(
            L * V, self.output_dim))
        return out if self.dtype == torch.float32 else out.to(self.dtype)


class _Recurrent(_Op):
    """The recurrent layers' common loop: the input projection ``x @ kernel
    (+ bias)`` for every step at once, then one ``step`` a time step from a
    zero state (or ``initial_state``, tensors of the graph), backwards over
    time with ``go_backwards`` (the outputs then in that order, as Keras
    returns them). A masked step (an Embedding's ``mask_zero``) keeps the
    state and outputs the previous output (zeros with
    ``zero_output_for_mask``), as Keras's JAX backend does; the last
    output, or with ``return_sequences`` every step's, and with
    ``return_state`` the final states after it (``h`` and ``c`` for LSTM,
    ``h`` for GRU and SimpleRNN). The output's mask is the input's with
    ``return_sequences``, else none; the states have none.

    ``stateful=True`` runs as the reference runs it: Keras 3.13 keeps a
    stateful layer's states in variables outside ``non_trainable_variables``
    (and outside ``get_weights()``), so its ``stateless_call`` and the JAX
    backend's ``fit``, ``evaluate`` and ``predict`` start every batch from
    zeros, as without the option. What stays of it is Keras's check that
    every batch has the batch size the model was built with.

    ``dropout`` and ``recurrent_dropout`` act in training only, as Keras
    3.13's cells apply them: :meth:`draw_masks` draws the masks once a call
    (inverted dropout, values 0 and ``1 / (1 - rate)`` in the compute
    dtype), fixed over the time steps. With ``recurrent_dropout`` LSTM and
    GRU run Keras's ``implementation=1``: one input mask and one recurrent
    mask a gate, each gate's projection from its own masked copy; without
    it one input mask for every gate. SimpleRNN has one of each. The masks
    come from the adapter's generator (other bits than Keras's)."""
    supports_masking = uses_mask = True
    n_gates = 1
    n_states = 1

    def __init__(self, cls: str, cfg: dict, feat, batch: Optional[int] = None):
        self.name = cfg["name"]
        self.units = int(cfg["units"])
        self.return_state = bool(cfg.get("return_state", False))
        self.n_outputs = 1 + self.n_states if self.return_state else 1
        self.batch = None
        if cfg.get("stateful"):
            if batch is None:
                raise ValueError(f"{cls} {self.name!r}: when using `stateful=True` in a "
                                 f"RNN, the batch size must be static")
            self.batch = int(batch)
        self.dropout = min(1.0, max(0.0, float(cfg.get("dropout") or 0.0)))
        self.recurrent_dropout = min(1.0, max(0.0, float(cfg.get("recurrent_dropout")
                                                         or 0.0)))
        # Keras's implementation 1: a mask a gate
        self.per_gate = self.n_gates > 1 and self.recurrent_dropout > 0.0
        self.act = _activation(cfg.get("activation", "tanh"))
        self.rec_act = _activation(cfg.get("recurrent_activation", "sigmoid"))
        self.use_bias = bool(cfg.get("use_bias", True))
        self.return_sequences = bool(cfg.get("return_sequences", False))
        self.go_backwards = bool(cfg.get("go_backwards", False))
        self.zero_masked = bool(cfg.get("zero_output_for_mask", False))
        feat = _need_feat(cls, cfg, feat, 2)
        self.in_dim = int(feat[-1])
        self.out_feat = ([feat[0], self.units] if self.return_sequences
                         else [self.units])
        self.kernel_init = cfg.get("kernel_initializer", "GlorotUniform")
        self.rec_init = cfg.get("recurrent_initializer", "Orthogonal")
        self.bias_init = cfg.get("bias_initializer", "Zeros")

    @property
    def out_feats(self):
        return [self.out_feat] + [[self.units]] * (self.n_outputs - 1)

    def output_masks(self, hs, masks):
        out = masks[0] if self.return_sequences else None
        return [out] + [None] * (self.n_outputs - 1)

    def bias_shape(self):
        return (self.n_gates * self.units,)

    def weight_shapes(self):
        g = self.n_gates * self.units
        shapes = [_Spec(f"{self.name}/kernel", (self.in_dim, g), self.kernel_init),
                  _Spec(f"{self.name}/recurrent_kernel", (self.units, g), self.rec_init)]
        if self.use_bias:
            shapes.append(_Spec(f"{self.name}/bias", self.bias_shape(), self.bias_init))
        return shapes

    def input_bias(self, p):
        return p[f"{self.name}/bias"]

    def draw_masks(self, L: int, B: int, like, gen):
        """``(input masks, recurrent masks)`` of one training call, each a
        list (a mask a gate, or one) of ``[L, B, width]`` tensors of 0 and
        ``1 / (1 - rate)`` in ``like``'s dtype, or None where the rate is 0
        (or 1, where Keras's LSTM and GRU cells apply none)."""
        def draw(rate, width):
            if not 0.0 < rate < 1.0:
                return None
            keep = 1.0 - rate
            ones = torch.ones((L, B, width), dtype=like.dtype, device=like.device)
            return [torch.where(torch.rand((L, B, width), generator=gen,
                                           device=like.device) < keep,
                                ones / keep, torch.zeros_like(ones))
                    for _ in range(self.n_gates if self.per_gate else 1)]

        return draw(self.dropout, self.in_dim), draw(self.recurrent_dropout, self.units)

    def _project(self, p, h, in_masks):
        """``x @ kernel (+ bias)`` for every step, ``[L, B, T, gates * units]``;
        with input masks each gate's slice from its own masked input."""
        L, B, T = h.shape[:3]
        kernel = p[f"{self.name}/kernel"]
        if in_masks is None or len(in_masks) == 1:
            x = h if in_masks is None else h * in_masks[0][:, :, None]
            xz = torch.bmm(x.reshape(L, B * T, self.in_dim), kernel)
        else:
            u = self.units
            xz = torch.cat([torch.bmm((h * m[:, :, None]).reshape(L, B * T, self.in_dim),
                                      kernel[..., g * u:(g + 1) * u])
                            for g, m in enumerate(in_masks)], dim=-1)
        if self.use_bias:
            xz = xz + self.input_bias(p)[:, None, :]
        return xz.reshape(L, B, T, self.n_gates * self.units)

    def _recurrent(self, hs, rk, rmasks, gates):
        """``h @ recurrent_kernel`` over the gate indices ``gates``, each
        gate's product from ``h`` times its own recurrent mask."""
        u = self.units
        if rmasks is None or len(rmasks) == 1:
            h = hs if rmasks is None else hs * rmasks[0]
            return torch.bmm(h, rk[..., gates[0] * u:(gates[-1] + 1) * u])
        return torch.cat([torch.bmm(hs * rmasks[g], rk[..., g * u:(g + 1) * u])
                          for g in gates], dim=-1)

    def __call__(self, p, h, training, gen, ntv_out, mask=None, initial_state=None):
        L, B, T = h.shape[:3]
        if self.batch is not None and B != self.batch:
            raise ValueError(
                f"If an RNN is stateful, the batch size of the input sequences must be "
                f"the same as the batch size of the initial state (layer {self.name!r}: "
                f"expected batch size {self.batch}, received {B})")
        in_masks, rmasks = (self.draw_masks(L, B, h, gen) if training
                            else (None, None))
        xz = self._project(p, h, in_masks)
        if initial_state is None:
            state = tuple(h.new_zeros((L, B, self.units)) for _ in range(self.n_states))
        else:
            if len(initial_state) != self.n_states:
                raise ValueError(f"{self.name!r}: initial_state has {len(initial_state)} "
                                 f"tensors, the layer {self.n_states} states")
            state = tuple(s.to(h.dtype) for s in initial_state)
        outs, out = [], None
        for t in (range(T - 1, -1, -1) if self.go_backwards else range(T)):
            new = self.step(p, xz[:, :, t], state, rmasks)
            out = new[0]
            if mask is not None:
                m = mask[:, :, t, None]
                out = torch.where(m, out, torch.zeros_like(out) if self.zero_masked
                                  else state[0])
                new = tuple(torch.where(m, n, s) for n, s in zip(new, state))
            state = new
            if self.return_sequences:
                outs.append(out)
        out = torch.stack(outs, dim=2) if self.return_sequences else out
        return (out,) + tuple(state) if self.return_state else out


class _LSTM(_Recurrent):
    """Keras 3's LSTM: ``z = x @ kernel + h @ recurrent_kernel + bias``, gates
    i, f, c, o in that order, ``c = f * c + i * act(z_c)``, ``h = o *
    act(c)``, ``recurrent_activation`` on i, f and o."""
    n_gates, n_states = 4, 2

    def __init__(self, cfg: dict, feat, batch=None):
        super().__init__("LSTM", cfg, feat, batch)
        if cfg.get("unit_forget_bias", True):
            bias_init = self.bias_init

            def forget_ones(shape, gen, u=self.units):
                # Keras: bias_init for i, ones for f, bias_init for c and o
                return torch.cat([_initial_value(bias_init, (u,), gen), torch.ones(u),
                                  _initial_value(bias_init, (2 * u,), gen)])
            self.bias_init = forget_ones

    def step(self, p, xz_t, state, rmasks=None):
        hs, cs = state
        u = self.units
        rk = p[f"{self.name}/recurrent_kernel"]
        if rmasks is None:
            z = torch.baddbmm(xz_t, hs, rk)
        else:
            z = xz_t + self._recurrent(hs, rk, rmasks, (0, 1, 2, 3))
        gates = self.rec_act(z)            # i, f and o (c's quarter unused)
        cs = gates[..., u:2 * u] * cs + gates[..., :u] * self.act(z[..., 2 * u:3 * u])
        return gates[..., 3 * u:] * self.act(cs), cs


class _GRU(_Recurrent):
    """Keras 3's GRU, gates z, r, h: ``z = ra(x_z + h @ rk_z)``, ``r = ra(x_r +
    h @ rk_r)``, ``hh = act(x_h + r * (h @ rk_h + rb_h))`` with
    ``reset_after`` (bias ``[2, 3 units]``: the input bias, then the
    recurrent one) or ``act(x_h + (r * h) @ rk_h)`` without (bias ``[3
    units]``), ``h = z * h + (1 - z) * hh`` (the unmasked ``h``)."""
    n_gates = 3

    def __init__(self, cfg: dict, feat, batch=None):
        super().__init__("GRU", cfg, feat, batch)
        self.reset_after = bool(cfg.get("reset_after", True))

    def bias_shape(self):
        g = 3 * self.units
        return (2, g) if self.reset_after else (g,)

    def input_bias(self, p):
        b = p[f"{self.name}/bias"]
        return b[:, 0] if self.reset_after else b

    def step(self, p, xz_t, state, rmasks=None):
        hs, = state
        u = self.units
        rk = p[f"{self.name}/recurrent_kernel"]
        if self.reset_after:
            rec = self._recurrent(hs, rk, rmasks, (0, 1, 2))
            if self.use_bias:
                rec = rec + p[f"{self.name}/bias"][:, 1, None, :]
        else:
            rec = self._recurrent(hs, rk, rmasks, (0, 1))
        z = self.rec_act(xz_t[..., :u] + rec[..., :u])
        r = self.rec_act(xz_t[..., u:2 * u] + rec[..., u:2 * u])
        if self.reset_after:
            rec_h = r * rec[..., 2 * u:]
        else:
            h_h = hs if rmasks is None else hs * rmasks[-1]
            rec_h = torch.bmm(r * h_h, rk[..., 2 * u:])
        hh = self.act(xz_t[..., 2 * u:] + rec_h)
        return (z * hs + (1 - z) * hh,)


class _SimpleRNN(_Recurrent):
    """Keras 3's SimpleRNN: ``h = act(x @ kernel + bias + h @ recurrent_kernel)``."""

    def __init__(self, cfg: dict, feat, batch=None):
        super().__init__("SimpleRNN", cfg, feat, batch)

    def step(self, p, xz_t, state, rmasks=None):
        hs, = state
        return (self.act(xz_t + self._recurrent(hs, p[f"{self.name}/recurrent_kernel"],
                                                rmasks, (0,))),)


# the dtype policies the port runs, by their compute dtype: variables stay
# float32 under each (``weights_to_state``)
_POLICIES = {"float32": torch.float32, "mixed_bfloat16": torch.bfloat16,
             "mixed_float16": torch.float16}


def _policy_name(cfg: dict) -> str:
    """A layer's or a model's dtype policy by name (``"float32"`` when the
    config names none)."""
    policy = cfg.get("dtype")
    if isinstance(policy, dict):
        policy = (policy.get("config") or {}).get("name")
    return "float32" if policy is None else str(policy)


def _model_policy(model, arch: dict) -> Optional[str]:
    """A model's dtype policy: a live model's ``dtype_policy`` (read
    duck-typed), else its config's (a Sequential model writes one), else
    the one policy every layer of it shares (a Functional model's JSON
    names none; Keras gives it the global policy it was built under), else
    None: the JSON does not say (its layers' policies differ, as in a
    ``mixed_float16`` model with a float32 head)."""
    live = getattr(getattr(model, "dtype_policy", None), "name", None)
    if isinstance(live, str):
        return live
    cfg = arch.get("config") or {}
    if "dtype" in cfg:
        return _policy_name(cfg)
    names = {_policy_name(layer.get("config") or {}) for layer in cfg.get("layers", [])
             if layer.get("class_name") != "InputLayer"}
    return names.pop() if len(names) == 1 else None


def _compute_dtype(cfg: dict) -> torch.dtype:
    """The compute dtype of a config's policy. The pure ``bfloat16`` and
    ``float16`` policies (16-bit variables) and any other raise."""
    name = _policy_name(cfg)
    if name not in _POLICIES:
        raise _refuse(f"dtype policy {name!r} (the port runs float32, mixed_bfloat16 "
                      f"and mixed_float16)")
    return _POLICIES[name]


_RECURRENT = {"LSTM": _LSTM, "GRU": _GRU, "SimpleRNN": _SimpleRNN}
_MERGES = ("Add", "Subtract", "Multiply", "Average", "Maximum", "Minimum")


def _make_op(cls: str, cfg: dict, feat, in_dim: Optional[int] = None,
             batch: Optional[int] = None):
    """The op of one layer config at input feature shape ``feat`` (a list of
    them for a merge layer), computing in its policy's dtype. ``in_dim`` is
    a Dense layer's fan-in where the config gives no shape; ``batch`` the
    input's static batch size, if any (a stateful recurrent layer's)."""
    dtype = _compute_dtype(cfg)
    op = _layer_op(cls, cfg, feat, in_dim, batch)
    op.dtype = dtype
    return op


def _layer_op(cls: str, cfg: dict, feat, in_dim: Optional[int], batch: Optional[int]):
    if cls == "Dense":
        if feat is None and in_dim is None:
            raise ValueError(f"Dense layer {cfg.get('name')!r}: the config has no input "
                             f"shape and no weights were given")
        op = _Dense(cfg, int(feat[-1]) if feat is not None else in_dim)
        op.out_feat = (list(feat[:-1]) if feat is not None else []) + [op.units]
        return op
    if cls in _MERGES:
        return _Merge(cls, cfg, feat)
    if cls == "Concatenate":
        return _Concatenate(cfg)
    if cls == "Dropout":
        op = _Dropout(cfg)
    elif cls == "Activation":
        op = _Activation(cfg)
    elif cls == "Flatten":
        return _Flatten(cfg, feat)
    elif cls == "BatchNormalization":
        op = _BatchNorm(cfg, feat)
    elif cls in ("Conv1D", "Conv2D"):
        return _Conv(cfg, feat, int(cls[4]))
    elif cls in ("MaxPooling1D", "MaxPooling2D", "AveragePooling1D", "AveragePooling2D"):
        return _Pool(cfg, feat, int(cls[-2]), "max" if cls.startswith("Max") else "avg")
    elif cls in ("GlobalMaxPooling1D", "GlobalMaxPooling2D", "GlobalAveragePooling1D",
                 "GlobalAveragePooling2D"):
        return _GlobalPool(cfg, feat, int(cls[-2]),
                           "max" if cls.startswith("GlobalMax") else "avg")
    elif cls in ("ZeroPadding1D", "ZeroPadding2D"):
        return _ZeroPad(cfg, feat, int(cls[-2]))
    elif cls == "Reshape":
        return _Reshape(cfg, feat)
    elif cls == "Embedding":
        return _Embedding(cfg, feat)
    elif cls in _RECURRENT:
        return _RECURRENT[cls](cfg, feat, batch)
    else:
        raise _refuse(f"layer {cls!r}")
    op.out_feat = None if feat is None else list(feat)    # shape-keeping ops
    return op


_MODELS = ("Sequential", "Functional", "Model")
# the Keras ops a Functional config holds where Keras computed a layer's
# mask on its symbolic tensors (an Embedding's ``not_equal``, a merge's
# ``logical_or``, Concatenate's broadcast, concatenation and ``any``) and
# handed it to a layer as ``mask=``: the walk computes the same masks
# itself (:meth:`_Op.output_masks`)
_MASK_OPS = ("NotEqual", "ExpandDims", "ZerosLike", "OnesLike", "LogicalOr", "LogicalAnd",
             "Concatenate", "Any", "All", "BroadcastTo", "Cast")


def _is_mask_op(layer: dict) -> bool:
    return (str(layer.get("module", "")).startswith("keras.src.ops")
            and layer.get("class_name") in _MASK_OPS)


class _Node(NamedTuple):
    """One call of a layer (``label``, its class and name): ``op`` over the
    values ``inputs`` (keys; a merge's list of them) and, for a recurrent
    layer's ``initial_state``, ``states``; its results stored as
    ``outputs`` (one key an output); ``free`` are the keys no later node
    reads."""
    op: Any
    inputs: Tuple[Any, ...]
    outputs: Tuple[Any, ...]
    label: str
    states: Tuple[Any, ...] = ()
    free: Tuple[Any, ...] = ()
    # Keras hands a call its input's mask when it has one tensor argument
    # or names ``mask=``; a recurrent call with ``initial_state`` gets none
    takes_mask: bool = True


def _several(n: int, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"a model of {n} {what}s: the reference's entry points do not take one either "
        f"(its SparkModel.fit stacks each partition into one x array and one y array, "
        f"and its predict, evaluate and ML skins read one array each)")


def _tensor_ref(arg) -> Tuple[str, int, int]:
    """``(layer, node, output index)`` of a ``__keras_tensor__`` argument."""
    if not (isinstance(arg, dict) and arg.get("class_name") == "__keras_tensor__"):
        raise _refuse(f"a layer argument that is not a tensor ({str(arg)[:80]})")
    layer, node, index = arg["config"]["keras_history"]
    return layer, int(node), int(index)


def _one_io(refs, what: str) -> Tuple[str, int, int]:
    """The single ``[layer, node, tensor]`` of ``input_layers`` /
    ``output_layers`` (a list of one is one too)."""
    if isinstance(refs, dict):
        raise _several(len(refs), what)
    if refs and isinstance(refs[0], (list, tuple)):
        if len(refs) != 1:
            raise _several(len(refs), what)
        refs = refs[0]
    return refs[0], int(refs[1]), int(refs[2])


def _call_arguments(cls: str, name: str, node: dict, mask_ops=()):
    """``(tensor arguments, initial_state arguments)`` of one call in a
    Functional config. Keras 3.13 writes ``training`` and ``mask`` into
    some calls; a ``training`` the caller gave is read as Keras reads it
    inside a model: the model's own call (every step of the reference and
    of Keras's ``fit``, ``evaluate`` and ``predict`` names its mode) passes
    its ``training`` down to every layer, nested models included, and that
    overrides the value saved with the call (``functional.operation_fn``),
    so a base called with ``training=False`` trains its BatchNormalization
    in a fit unless the layer is frozen, and ``Dropout(x, training=True)``
    is off in ``predict``. A recurrent layer's ``initial_state`` (by
    keyword or second argument) is read; a ``mask`` that the ops
    ``mask_ops`` made is the one the walk hands the layer; any other
    argument raises. Returns ``(tensor argument, initial_state arguments,
    whether a mask was named)``."""
    args = list(node.get("args", []))
    kwargs = dict(node.get("kwargs") or {})
    training = kwargs.pop("training", None)
    if training not in (None, True, False):
        raise ValueError(f"layer {name!r}: training={training!r}")
    mask = kwargs.get("mask")
    named_mask = mask is not None
    if mask is None or (isinstance(mask, dict) and mask.get("class_name") == "__keras_tensor__"
                        and _tensor_ref(mask)[0] in mask_ops):
        kwargs.pop("mask", None)
    states = kwargs.pop("initial_state", None)
    if cls in _RECURRENT and states is None and len(args) > 1:
        states = args.pop(1)
    extra = {k: v for k, v in kwargs.items() if v is not None}
    if len(args) != 1 or extra:
        raise _refuse(f"a call of layer {name!r} with arguments {str(args[1:])[:60]} "
                      f"{str(extra)[:80]}")
    if states is not None and cls not in _RECURRENT:
        raise _refuse(f"initial_state on layer {name!r} ({cls})")
    if states is not None and not isinstance(states, (list, tuple)):
        states = [states]
    return args[0], [] if states is None else list(states), named_mask


class _GraphBuilder:
    """Reads a model config into nodes and weight specs. A model nested as a
    layer (a Sequential or Functional config, in either, to any depth) is
    read in its caller's place: its calls become nodes of the caller's
    graph, its input bound to the call's argument and its output to the
    call's result, its weights named under the model's name (Keras's
    variable paths, ``"base/conv1/kernel"``) in the nested layer's place in
    the weight order, once however often it is called. A frozen model
    (``trainable: false``) freezes every layer in it, as Keras does."""

    def __init__(self, weight_shapes):
        self.specs: List[_Spec] = []
        self._seen = set()
        # the Dense kernels' input widths, in order (biases are the 1-D arrays)
        self._kernel_in = iter([s[0] for s in weight_shapes or [] if len(s) == 2])

    def _op(self, cls, lcfg, prefix, trainable, feat, batch=None):
        """The op of a layer whose weights are named under ``prefix``; its
        weights join the specs the first time the layer is met."""
        lcfg = dict(lcfg, name=prefix + str(lcfg.get("name")))
        if not trainable:
            lcfg["trainable"] = False
        in_dim = next(self._kernel_in, None) if cls == "Dense" and feat is None else None
        op = _make_op(cls, lcfg, feat, in_dim, batch)
        frozen = not lcfg.get("trainable", True)
        for spec in op.weight_shapes():
            if spec.name not in self._seen:
                self._seen.add(spec.name)
                self.specs.append(spec._replace(trainable=False) if frozen else spec)
        return op

    def model(self, arch: dict, scope: tuple, prefix: str, trainable: bool,
              bind_in=None, bind_out=None, feat=None):
        """``(nodes, input key, output key, output feature shape)`` of a
        model config; keys are tuples under ``scope``, the input renamed
        ``bind_in`` and the output ``bind_out`` where given."""
        cfg = arch.get("config", {})
        _compute_dtype(cfg)
        trainable = trainable and cfg.get("trainable", True)
        kind = arch.get("class_name")
        if kind == "Sequential":
            return self._sequential(arch, cfg, scope, prefix, trainable, bind_in, bind_out,
                                    feat)
        if kind in ("Functional", "Model") and "layers" in cfg:
            return self._functional(cfg, scope, prefix, trainable, bind_in, bind_out)
        raise _refuse(f"model class {kind!r} (the port interprets Sequential and "
                      f"Functional models)")

    def _sequential(self, arch, cfg, scope, prefix, trainable, bind_in, bind_out, feat):
        """A chain. Input shapes come from the config (InputLayer, build
        shapes, each layer's ``build_config``) or, for a Dense layer failing
        those, from the kernels' shapes in the weights."""
        shape = cfg.get("build_input_shape") or (arch.get("build_config") or {}).get(
            "input_shape")
        batch = shape[0] if shape else None
        if shape:
            feat = list(shape[1:])
        layers = cfg.get("layers", [])
        calls = [layer for layer in layers if layer.get("class_name") != "InputLayer"]
        first, last = scope + (0,), scope + (len(calls),)

        def key(i):
            k = scope + (i,)
            return (bind_in if k == first and bind_in is not None else
                    bind_out if k == last and bind_out is not None else k)

        nodes, i, n_out = [], 0, 1
        for layer in layers:
            cls, lcfg = layer.get("class_name"), layer.get("config", {})
            if cls == "InputLayer":
                bs = lcfg.get("batch_shape") or lcfg.get("batch_input_shape")
                if bs:
                    batch, feat = bs[0], list(bs[1:])
                continue
            name = lcfg.get("name")
            if n_out > 1:
                # Keras hands the tuple on, and the layer refuses it
                raise ValueError(f"Layer {name!r} expects 1 input(s), but it received "
                                 f"{n_out} input tensors")
            build = (layer.get("build_config") or {}).get("input_shape")
            if build:
                batch, feat = build[0], list(build[1:])
            if cls in _MERGES or cls == "Concatenate":
                raise ValueError(f"{cls} in a Sequential model takes one input")
            if cls in _MODELS:
                inner, _, _, feat = self.model(layer, scope + ((name, 0),),
                                               f"{prefix}{name}/", trainable,
                                               key(i), key(i + 1), feat)
                nodes += inner
            else:
                op = self._op(cls, lcfg, prefix, trainable, feat, batch)
                n_out, feat = op.n_outputs, op.out_feat
                nodes.append(_Node(op, (key(i),), (key(i + 1),) + tuple(
                    scope + (i + 1, j) for j in range(1, n_out)), f"{cls} {name!r}"))
            i += 1
        if n_out > 1:
            raise _several(n_out, "output")
        return nodes, key(0), key(len(calls)), feat

    def _functional(self, cfg, scope, prefix, trainable, bind_in, bind_out):
        """A graph of one input and one output. Each layer's
        ``inbound_nodes`` are its calls; an argument ``__keras_tensor__``
        names the ``(layer, node, output)`` that made it and carries its
        shape; ``specs`` follow the layers' order, which is
        ``get_weights()``'s."""
        first = scope + _one_io(cfg.get("input_layers"), "input")
        last = scope + _one_io(cfg.get("output_layers"), "output")

        def key(ref):
            k = scope + tuple(ref)
            return (bind_in if k == first and bind_in is not None else
                    bind_out if k == last and bind_out is not None else k)

        nodes, out_feat = [], None
        mask_ops = {layer.get("name", layer.get("config", {}).get("name"))
                    for layer in cfg.get("layers", []) if _is_mask_op(layer)}
        for layer in cfg.get("layers", []):
            cls, lcfg = layer.get("class_name"), layer.get("config", {})
            name = layer.get("name", lcfg.get("name"))
            if cls == "InputLayer" or name in mask_ops:
                continue
            for i, node in enumerate(layer.get("inbound_nodes", [])):
                arg, states, named_mask = _call_arguments(cls, name, node, mask_ops)
                merge = cls in _MERGES or cls == "Concatenate"
                tensors = list(arg) if merge else [arg]
                shapes = [t["config"].get("shape") for t in tensors]
                feat = [list(s[1:]) for s in shapes] if merge else (
                    list(shapes[0][1:]) if shapes[0] is not None else None)
                ins = tuple(key(_tensor_ref(t)) for t in tensors)
                if cls in _MODELS:
                    inner, _, _, f = self.model(layer, scope + ((name, i),),
                                                f"{prefix}{name}/", trainable, ins[0],
                                                key((name, i, 0)), feat)
                    nodes += inner
                    outs = [(key((name, i, 0)), f)]
                else:
                    batch = None if merge or shapes[0] is None else shapes[0][0]
                    op = self._op(cls, lcfg, prefix, trainable, feat, batch)
                    outs = [(key((name, i, j)), f) for j, f in enumerate(op.out_feats)]
                    nodes.append(_Node(op, ins, tuple(k for k, _ in outs), f"{cls} {name!r}",
                                       tuple(key(_tensor_ref(t)) for t in states),
                                       takes_mask=named_mask or not states))
                for k, f in outs:
                    if k == key(last[len(scope):]):
                        out_feat = f
        return nodes, key(first[len(scope):]), key(last[len(scope):]), out_feat


def _in_order(nodes: List[_Node], first, last) -> List[_Node]:
    """The calls in the config's order, a call whose inputs are not made yet
    put off until they are (a shared layer's second call may read a later
    layer, as Keras's own ``from_config`` allows)."""
    order, made, pending = [], {first}, list(nodes)
    while pending:
        ready = [n for n in pending if all(k in made for k in n.inputs + n.states)]
        if not ready:
            raise ValueError(f"the graph's calls {[n.outputs[0] for n in pending][:4]} read "
                             f"values no call makes")
        for n in ready:
            order.append(n)
            made.update(n.outputs)
        pending = [n for n in pending if n.outputs[0] not in made]
    if last not in made:
        raise ValueError(f"the model's output {last} is made by no call")
    return order


def _parse(arch: dict, weight_shapes=None):
    """``(nodes, specs, input key, output key)`` of a Keras-3 Sequential or
    Functional config (:class:`_GraphBuilder`); the nodes in an order that
    runs, each marking the values it reads last so the walk frees them."""
    builder = _GraphBuilder(weight_shapes)
    nodes, first, last, _ = builder.model(arch, (), "", True)
    nodes = _in_order(nodes, first, last)
    last_read = {}
    for i, node in enumerate(nodes):
        for k in node.inputs + node.states:
            last_read[k] = i
    nodes = [n._replace(free=tuple(k for k in set(n.inputs + n.states)
                                   if last_read[k] == i and k not in (first, last)))
             for i, n in enumerate(nodes)]
    return nodes, builder.specs, first, last


def _is_accuracy_name(name) -> bool:
    return "accuracy" in str(name) or str(name) == "acc"


def _flat_metric_specs(spec) -> list:
    """The metrics of a ``compile(metrics=...)`` argument, in order."""
    if spec is None:
        return []
    if isinstance(spec, dict) and "class_name" not in spec:
        return [m for s in spec.values() for m in _flat_metric_specs(s)]
    if isinstance(spec, (list, tuple)):
        return [m for s in spec for m in _flat_metric_specs(s)]
    return [spec]


def compile_metric_names(model) -> Tuple[List[str], List[str]]:
    """``(metric_names, weighted_metric_names)`` from ``model.compile(...)``:
    the compile config of a :class:`KerasModelAdapter`, of a model's JSON
    (a string, a config dict, ``model_to_dict``'s dict), or of an object
    with ``to_json()`` (a compiled Keras model, read duck-typed). The one
    reading of the compiled metrics, which the adapter's metric inference
    and ``SparkModel.evaluate``'s gate share."""
    if isinstance(model, KerasModelAdapter):
        cc = model.compile_config
    elif hasattr(model, "to_json") and not isinstance(model, (str, dict)):
        cc = json.loads(model.to_json()).get("compile_config") or {}
    else:
        cc = _read_model(model)[0].get("compile_config") or {}
    return tuple([metric_name(m) for m in _flat_metric_specs(cc.get(k))]
                 for k in ("metrics", "weighted_metrics"))


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


def stats_row(stats) -> torch.Tensor:
    """One replica's ``[loss * B, B, *metric states]`` from the stats of a
    step :meth:`KerasModelAdapter.build_metric_steps` builds, on the
    device: what Keras's ``fit`` and ``evaluate`` add up over batches (a
    mean metric's sum and count, a stateful class's vector), read with
    :func:`~elephas_tpu_torch.models.losses.metric_results`."""
    loss, _, count, states = stats
    return torch.cat([loss, count, states[0]])


class KerasModelAdapter:
    """Functional view over a Keras-3 Sequential or Functional model's JSON
    and weights."""

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
        self.metrics = list(metrics) if metrics is not None else self._infer_metrics()
        shapes = None if weights is None else [np.shape(w) for w in weights]
        self._nodes, self._specs, self._input, self._output = _parse(arch, shapes)
        # the ops in the order they run (a shared layer once a call)
        self.layers = [n.op for n in self._nodes]
        # the model's dtype policy (None: its JSON does not say); Keras's
        # compile wraps the optimizer of a mixed_float16 model in a
        # LossScaleOptimizer, which the JSON's compile_config does not name
        self.policy = _model_policy(model, arch)
        opt = optimizer if optimizer is not None else self.compile_config.get("optimizer")
        if optimizer is None and opt is not None:
            if self.policy is None and any(op.dtype == torch.float16 for op in self.layers):
                raise _refuse("a Functional model's JSON with mixed_float16 layers whose "
                              "policies differ (it names no model policy, so whether "
                              "Keras wraps the optimizer in a LossScaleOptimizer is "
                              "unknown): pass the live Keras model, or optimizer=")
            if self.policy == "mixed_float16":
                opt = loss_scale_spec(opt)
        self.optimizer_spec = opt or "sgd"
        # under a mixed policy: the compute dtype of each weight that its
        # layer reads cast (BatchNormalization's and Embedding's are read
        # as float32)
        self._mixed = any(op.dtype != torch.float32 for op in self.layers)
        self._weight_dtypes = {spec.name: op.dtype for op in self.layers
                               if op.cast_weights and op.dtype != torch.float32
                               for spec in op.weight_shapes()}
        if weights is None:
            gen = torch.Generator().manual_seed(int(seed))
            weights = [_initial_value(s.init, s.shape, gen) for s in self._specs]
        self.set_weights(weights)

    # -- introspection ---------------------------------------------------
    def compile_metric_names(self) -> Tuple[List[str], List[str]]:
        """``(metric_names, weighted_metric_names)`` of the compile config
        (:func:`compile_metric_names`)."""
        return compile_metric_names(self)

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
    def _forward(self, params: Params, x, training: bool, generator, ntv_out,
                 with_mask: bool = False):
        """The graph's calls in order, each value kept by key until its last
        reader has run; a mask travels beside its values as Keras 3.13
        hands it on (:meth:`_Op.output_masks`). With ``with_mask`` returns
        ``(output, its mask or None)``."""
        vals, masks = {self._input: x}, {}
        if self._weight_dtypes:
            params = {**params, **{k: params[k].to(dt)
                                   for k, dt in self._weight_dtypes.items()}}

        def cast(h, op):
            if self._mixed and op.autocast and h.is_floating_point():
                return h.to(op.dtype)
            return h

        for node in self._nodes:
            op = node.op
            hs = [vals[k] for k in node.inputs]
            in_masks = [masks.get(k) for k in node.inputs]
            kw = {}
            if op.uses_mask and node.takes_mask and any(m is not None for m in in_masks):
                kw["mask"] = in_masks if op.merge else in_masks[0]
            if node.states:
                kw["initial_state"] = [cast(vals[k], op) for k in node.states]
            arg = [cast(h, op) for h in hs] if op.merge else cast(hs[0], op)
            out = op(params, arg, training, generator, ntv_out, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            for k, h, m in zip(node.outputs, outs, op.output_masks(hs, in_masks)):
                vals[k] = h
                if m is not None:
                    masks[k] = m
            for k in node.free:
                vals.pop(k, None)
                masks.pop(k, None)
        if with_mask:
            return vals[self._output], masks.get(self._output)
        return vals[self._output]

    def apply(self, params: Params, x, training: bool = False,
              generator: Optional[torch.Generator] = None):
        """The model over a replica stack: ``params`` ``[L, ...]`` (the
        trainable and non-trainable values, by name), ``x`` ``[L, B, ...]`` →
        ``[L, B, ...]``."""
        return self._forward(params, x, training, generator, None)

    def stateless_call(self, tv: Params, ntv: Params, x, training: bool = False,
                       generator: Optional[torch.Generator] = None, with_mask: bool = False):
        """Keras's ``stateless_call`` over a replica stack: ``(y, ntv2)``,
        ``ntv2`` the statistics that training moved (``ntv`` otherwise);
        with ``with_mask``, ``(y, ntv2, y's mask or None)``."""
        ntv2 = dict(ntv)
        out = self._forward({**tv, **ntv}, x, training, generator, ntv2 if training else None,
                            with_mask)
        return (out[0], ntv2, out[1]) if with_mask else (out, ntv2)

    def predict(self, x, batch_size: int = 32, verbose: int = 0) -> np.ndarray:
        """Keras ``model.predict``: the current weights over ``x`` in batches
        of ``batch_size`` rows on the adapter's device, in the output
        layer's compute dtype as Keras returns it; a bfloat16 output comes
        back widened exactly to float32 (numpy has no bfloat16 without
        ``ml_dtypes``)."""
        predict_fn = self.build_predict_fn()
        tv, ntv = ({k: v[None] for k, v in d.items()} for d in self.state_values())
        x = np.asarray(x, dtype=np.float32)
        outs = []
        for i in range(0, x.shape[0], int(batch_size)):
            xb = torch.as_tensor(x[i:i + int(batch_size)]).to(self.device)
            out = predict_fn(tv, ntv, xb[None])[0].cpu()
            outs.append((out.float() if out.dtype == torch.bfloat16 else out).numpy())
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)

    def keras_evaluate(self, x, y, batch_size: int = 32):
        """Keras ``model.evaluate`` of the compiled model, as the reference's
        fall-back runs it: batches of ``batch_size`` rows (Keras's 32 when
        the caller names none) through the host path's Keras evaluate step
        (:meth:`build_metric_steps`), with the compile config's loss (its
        batch values averaged over the rows, a loss object's scalar for the
        whole batch) and each of its ``metrics`` then ``weighted_metrics``
        (no sample weights: the weighted ones take the same values), each
        metric's state summed on the device over the batches and read once
        (a mean metric's sum and count, a stateful class's vector, reset for
        each call as Keras resets it). Returns the loss alone, or ``[loss,
        *metrics]``, a metric whose result is a vector as a float32 array."""
        specs = [m for k in ("metrics", "weighted_metrics")
                 for m in _flat_metric_specs(self.compile_config.get(k))]
        fns = [resolve_metric(m)[1] for m in specs]
        eval_step = self._eval_step(fns, self.compile_config.get("loss"))
        tv, ntv = ({k: v[None] for k, v in d.items()} for d in self.state_values())
        x = torch.as_tensor(np.asarray(x, np.float32))
        y = torch.as_tensor(np.asarray(y))
        if y.is_floating_point():
            y = y.to(torch.float32)
        tot = None
        for i in range(0, x.shape[0], int(batch_size)):
            xb, yb = (t[i:i + int(batch_size)].to(self.device) for t in (x, y))
            sw = torch.ones((1, xb.shape[0]), device=self.device)
            row = stats_row(eval_step(tv, ntv, xb[None], yb[None], sw))
            tot = row if tot is None else tot + row
        if tot is None:
            return 0.0 if not specs else [0.0] * (1 + len(specs))
        loss = float(tot[0] / torch.clamp(tot[1], min=1.0))
        if not specs:
            return loss
        return [loss] + [result_value(r) for r in metric_results(fns, tot[2:])]

    # -- step builders ---------------------------------------------------
    def _require_loss(self):
        if self.loss_spec is None:
            raise ValueError(
                "No loss available: compile the model or pass loss= explicitly."
            )
        return self.loss_spec

    def make_optimizer(self):
        return to_torch_optimizer(self.optimizer_spec)

    def _loss_parts(self, metric_fns: Optional[Sequence[Callable]] = None, loss_spec=None):
        """The per-sample loss, accuracy and metric sums of a batch. With
        ``metric_fns`` (a list, empty too) the steps are Keras's own
        ``fit`` / ``evaluate`` (the host path's workers, the reference's
        evaluate fall-back), whose ``Loss`` casts ``y_pred`` to float32;
        without, the reference's compiled loss, in ``y_pred``'s dtype.
        ``loss_spec`` overrides the adapter's."""
        per_sample_loss = resolve_per_sample_loss(
            loss_spec if loss_spec is not None else self._require_loss())
        # a loss the reference hands to Keras: its scalar is each replica's
        grouped = getattr(per_sample_loss, "grouped", None)
        acc_fn = resolve_accuracy(self.loss_spec) if self.wants_accuracy else None
        keras_loss = metric_fns is not None

        def per_and_acc(y, y_pred, sw, with_acc=True, mask=None, mask_metrics=True):
            """Per-sample losses ``[L, B]`` over the flattened rows (one call
            for every replica) and the weighted accuracy sums ``[L]``; with
            ``metric_fns``, also each metric's state, ``[L, S]`` (the
            metrics' states side by side: a mean metric's sum and count, a
            stateful class's vector). ``mask`` is the output's mask, which
            only Keras's own steps read (:meth:`_masked_loss`); its metrics
            read it with ``mask_metrics`` (Keras's JAX ``fit`` hands the
            metrics a ``y_pred`` that left ``jax.value_and_grad`` and lost its
            mask there; ``evaluate`` keeps it)."""
            L, B = sw.shape
            yf = y.reshape((L * B,) + tuple(y.shape[2:]))
            pf = y_pred.reshape((L * B,) + tuple(y_pred.shape[2:]))
            lp = y_pred.to(torch.float32) if keras_loss else y_pred
            if keras_loss and mask is not None:
                if grouped is not None:
                    raise _refuse("a mask reaching a loss the reference hands to Keras")
                per = self._masked_loss(per_sample_loss, y, lp, mask)
            else:
                per = grouped(y, lp) if grouped is not None else \
                    per_sample_loss(yf, lp.reshape(pf.shape)).reshape(L, B)
            if acc_fn is None or not with_acc:
                acc = torch.zeros(L, dtype=torch.float32, device=sw.device)
            else:
                with torch.no_grad():
                    acc = (acc_fn(yf, pf.detach()).reshape(L, B) * sw).sum(dim=1)
            if metric_fns is None:
                return per, acc
            with torch.no_grad():
                states = [torch.cat([metric_state(fn, y[l], y_pred[l].detach(),
                                                  None if mask is None or not mask_metrics
                                                  else mask[l])
                                     for fn in metric_fns])
                          if metric_fns else torch.zeros(0, device=sw.device)
                          for l in range(L)]
            return per, acc, torch.stack(states)

        return per_and_acc

    @staticmethod
    def _masked_loss(per_sample_loss, y, y_pred, mask):
        """Keras's ``Loss`` over an output with a mask ``[L, B, *A]``: the
        loss's values at each masked position (its rows flattened over the
        mask's axes), weighted ``total / valid`` where set and 0 elsewhere
        (``apply_mask``), then each row's mean: ``[L, B]``, whose mean over
        the batch is ``sum(values * mask) / valid``."""
        L, B = mask.shape[:2]
        n = mask.dim()
        rows = int(np.prod(mask.shape))
        values = per_sample_loss(y.reshape((rows,) + tuple(y.shape[n:])),
                                 y_pred.reshape((rows,) + tuple(y_pred.shape[n:])))
        w = mask.reshape(L, -1).to(values.dtype)
        valid = w.sum(dim=1, keepdim=True)
        w = w * torch.where(valid == 0, torch.zeros_like(valid), w.shape[1] / valid)
        return (values.reshape(L, -1) * w).reshape(L, B, -1).mean(dim=-1)

    @staticmethod
    def _region_grads(region, leaves: Params, remat: bool, gen, *args):
        """``(outputs, grads)``: ``region(leaves, *args, gen, gen_state)``'s
        outputs, the first a loss ``[L]``, and the gradients of its sum by
        leaf. With ``remat`` the region runs under
        ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
        around its ``_loss``): nothing inside it is kept for the backward,
        which runs it again whole. The dropout generator ``gen`` is not one
        that ``preserve_rng_state`` saves, so the region sets it to the
        step's starting state on every run and it is left, after the
        backward, where the first run left it; the values leaving the
        region (the moved statistics) are the first run's."""
        with torch.enable_grad():
            if not remat:
                out = region(leaves, *args, gen, None)
            else:
                start = None if gen is None else gen.get_state()
                with torch.utils.checkpoint.set_checkpoint_early_stop(False):
                    out = torch.utils.checkpoint.checkpoint(
                        region, leaves, *args, gen, start, use_reentrant=False,
                        preserve_rng_state=gen is None)
                after = None if gen is None else gen.get_state()
            grads = torch.autograd.grad(out[0].sum(), list(leaves.values()))
        if remat and gen is not None:
            gen.set_state(after)
        return out, grads

    def build_train_step(self, optimizer, remat: bool = False) -> Callable:
        """``(tv, ntv, opt_state, x, y, sw, gen) → (tv, ntv, opt_state,
        stats)`` over ``L`` replicas: ``tv`` and ``ntv`` ``[L, ...]``, ``x``
        ``[L, B, ...]``, ``sw`` ``[L, B]``. ``stats`` is
        ``(loss_weighted_sum, acc_weighted_sum, weight_sum)``, each ``[L]``
        (:meth:`build_metric_steps` adds Keras metrics). A replica whose
        batch is all padding keeps its parameters, statistics and optimizer
        state. ``remat=True`` recomputes the model and the loss in the
        backward instead of keeping their activations
        (:meth:`_region_grads`). An optimizer with a ``loss_scale``
        (:func:`~elephas_tpu_torch.models.optimizers.keras_loss_scale`) has
        the gradients of the loss times its scale; it unscales them.

        ``denom`` (``[L]``, optional) divides the weighted loss sum in place
        of the weight sum, as Keras's ``sum_over_batch_size`` divides a
        class-weighted batch's by its rows; the stats then count ``denom``
        where they count the weight sum."""
        return self._train_step(optimizer, remat, None)

    def build_metric_steps(self, optimizer, metric_fns: Sequence[Callable]):
        """``(train_step, eval_step)`` as :meth:`build_train_step` and
        :meth:`build_eval_step` build them, whose stats also carry each
        Keras metric function's (``metric_fns``,
        :func:`~elephas_tpu_torch.models.losses.resolve_metric`) sums and
        counts ``[L, M]``, on the training batch in the train step: what the
        host path's ``model.fit`` logs."""
        return self._train_step(optimizer, False, list(metric_fns)), \
            self._eval_step(list(metric_fns))

    def _train_step(self, optimizer, remat, metric_fns):
        per_and_acc = self._loss_parts(metric_fns)
        loss_scale = getattr(optimizer, "loss_scale", None)

        def region(leaves, ntv, x, y, sw, scale, denom, gen, gen_state):
            if gen_state is not None:
                gen.set_state(gen_state)
            y_pred, ntv2, mask = self.stateless_call(leaves, ntv, x, True, gen, with_mask=True)
            per, *rest = per_and_acc(y, y_pred, sw, mask=mask, mask_metrics=False)
            if denom is None:
                denom = torch.clamp(sw.sum(dim=1), min=1e-9)
            loss = (per * sw).sum(dim=1) / denom
            scaled = loss if scale is None else loss * scale
            return (scaled, ntv2, loss, *rest)

        def train_step(tv, ntv, opt_state, x, y, sw, gen, denom=None):
            leaves = {k: t.detach().requires_grad_() for k, t in tv.items()}
            scale = None if loss_scale is None else loss_scale(opt_state)
            # the replicas share nothing, so the gradient of the sum is each
            # replica's own gradient
            (_, ntv2, loss, acc, *mstats), grads = self._region_grads(
                region, leaves, remat, gen, ntv, x, y, sw, scale, denom)
            with torch.no_grad():
                loss, wsum = loss.detach(), sw.sum(dim=1)
                grads = dict(zip(leaves, grads))
                updates, opt2 = optimizer.update(grads, opt_state, tv)
                tv2 = {k: tv[k] + updates[k] for k in tv}
                valid = wsum > 0
                tv2 = _tree_where(valid, tv2, tv)
                ntv2 = _tree_where(valid, ntv2, ntv)
                opt2 = _tree_where(valid, opt2, opt_state)
                count = wsum if denom is None else denom
                stats = (torch.where(valid, loss * count, 0.0), acc, count, *mstats)
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
        per_and_acc = self._loss_parts()
        # a stateful recurrent layer checks each replica's batch size
        keep_replicas = any(not s.trainable for s in self._specs) or any(
            getattr(op, "batch", None) is not None for op in self.layers)

        def region(leaves, ntv, x, y, sw, scale, gen, gen_state):
            if gen_state is not None:
                gen.set_state(gen_state)
            L, B = sw.shape
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
            return (per * sw).sum(dim=1), ntv2, acc

        def grad_step(tv, ntv, x, y, sw, gen):
            leaves = {k: t.detach().requires_grad_() for k, t in tv.items()}
            (loss_wsum, ntv2, acc), grads = self._region_grads(region, leaves, remat, gen,
                                                               ntv, x, y, sw, None)
            wsum = sw.sum(dim=1)
            ntv2 = _tree_where(wsum > 0, ntv2, ntv) if keep_replicas else ntv
            return dict(zip(leaves, grads)), ntv2, (loss_wsum.detach(), acc, wsum)

        return grad_step

    def build_eval_step(self) -> Callable:
        """``(tv, ntv, x, y, sw) → (loss_wsum, acc_wsum, wsum)``, each ``[L]``."""
        return self._eval_step(None)

    def _eval_step(self, metric_fns, loss_spec=None):
        per_and_acc = self._loss_parts(metric_fns, loss_spec)

        @torch.no_grad()
        def eval_step(tv, ntv, x, y, sw):
            y_pred, _, mask = self.stateless_call(tv, ntv, x, False, with_mask=True)
            per, acc, *mstats = per_and_acc(y, y_pred, sw, mask=mask)
            return ((per * sw).sum(dim=1), acc, sw.sum(dim=1), *mstats)

        return eval_step

    def build_predict_fn(self) -> Callable:
        @torch.no_grad()
        def predict_fn(tv, ntv, x):
            return self.stateless_call(tv, ntv, x, False)[0]

        return predict_fn
