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

from typing import Callable, Dict, NamedTuple

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


def _adam_fns(learning_rate: float, b1: float, b2: float, eps: float,
              moment_dtype: torch.dtype):
    """``(init, update, fused_apply)`` of Adam with moments stored in
    ``moment_dtype`` and every operation in float32."""
    step_size = -float(learning_rate)

    def init(params: Params) -> AdamState:
        first = next(iter(params.values()))
        zeros = {k: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
                 for k, p in params.items()}
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=zeros,
            nu={k: torch.zeros_like(z) for k, z in zeros.items()})

    def corrections(count):
        c = count.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=c.device)
        return (1.0 - torch.pow(one * b1, c), 1.0 - torch.pow(one * b2, c))

    def moments(g, m, v):
        g32 = g.to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1.0 - b1) * g32
        v32 = b2 * v.to(torch.float32) + (1.0 - b2) * g32 * g32
        return m32, v32

    def update(grads: Params, state: AdamState, params=None):
        del params
        count = state.count + 1
        bc1, bc2 = corrections(count)
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            m32, v32 = moments(g, state.mu[k], state.nu[k])
            u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
            updates[k] = u * step_size      # optax.scale(-learning_rate)
            mu[k], nu[k] = m32.to(moment_dtype), v32.to(moment_dtype)
        return updates, AdamState(count, mu, nu)

    def fused_apply(grads: Params, state: AdamState, params: Params):
        count = state.count + 1
        bc1, bc2 = corrections(count)
        out, mu, nu = {}, {}, {}
        for k, g in grads.items():
            m32, v32 = moments(g, state.mu[k], state.nu[k])
            u = ((m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)) * step_size
            p = params[k]
            out[k] = (p + u).to(p.dtype)
            mu[k], nu[k] = m32.to(moment_dtype), v32.to(moment_dtype)
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
