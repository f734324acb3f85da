"""Elementwise math over model-weight lists (port of
``elephas_tpu/utils/functional_utils.py``).

The reference elephas zips two lists of numpy arrays (``add_params``,
``subtract_params``, ``get_neutral``, ``divide_by``); the JAX package maps
the same operations over JAX pytrees. The port maps them over lists,
tuples and dicts whose leaves are numpy arrays or torch tensors, so the
reference's call signatures hold verbatim and a torch leaf stays on its
device.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np


def _tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over matching leaves of lists, tuples and dicts."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def add_params(p1, p2):
    """Elementwise ``p1 + p2`` over two matching weight trees (reference
    ``functional_utils.add_params``)."""
    return _tree_map(lambda a, b: a + b, p1, p2)


def subtract_params(p1, p2):
    """Elementwise ``p1 - p2`` over two matching weight trees (reference
    ``functional_utils.subtract_params``). The training *delta* is
    ``subtract_params(weights_before, weights_after)``, and applying a delta
    to the master weights is again ``subtract_params(master, delta)``."""
    return _tree_map(lambda a, b: a - b, p1, p2)


def get_neutral(params):
    """Zeros with the structure, shapes and dtypes of ``params`` (reference
    ``functional_utils.get_neutral``): the neutral element of delta
    accumulation."""
    def zeros(w):
        return w.new_zeros(w.shape) if hasattr(w, "new_zeros") else np.zeros_like(w)

    return _tree_map(zeros, params)


def divide_by(params, num_workers):
    """Every leaf scaled by ``1 / num_workers`` (reference
    ``functional_utils.divide_by``, the delta-averaging merge)."""
    return _tree_map(lambda w: w / num_workers, params)


def scale_params(params, factor):
    """Every leaf scaled by ``factor``."""
    return _tree_map(lambda w: w * factor, params)


def subtract_params_np(p1, p2):
    """Pure-numpy ``p1 - p2`` over weight lists: the host-path variant the
    workers and parameter servers use, whose weights are numpy so that
    payloads pickle without device round trips."""
    return [np.asarray(a) - np.asarray(b) for a, b in zip(p1, p2)]


def mean_params(params_list):
    """The mean of a list of matching weight trees."""
    n = len(params_list)
    summed = params_list[0]
    for p in params_list[1:]:
        summed = add_params(summed, p)
    return divide_by(summed, n)
