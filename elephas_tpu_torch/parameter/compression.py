"""Delta compression for parameter-server traffic (an extension over the
reference elephas; a copy of ``elephas_tpu/parameter/compression.py``, whose
encodings it reproduces bit for bit).

The reference pickles the FULL float32 weight list on every push
(``elephas/parameter/client.py:~20`` — no compression, SURVEY.md §2.4), so
PS bandwidth scales with model size × push rate. These codecs shrink the
*delta* pushes (pulls stay exact — replicas must start from true weights):

- ``int8``: per-array linear quantization to int8 (scale = max|x|/127),
  ~4× smaller, error bounded by scale/2 per element.
- ``topk:F``: keep the fraction ``F`` of entries with largest magnitude
  (values + flat indices), ~``1/F × 1/2``-ish smaller. Pairs with
  client-side **error feedback**: the dropped residual is remembered and
  added to the next delta, so nothing is lost over time — the standard
  trick that keeps sparsified SGD converging.

Codecs are applied client-side via :class:`CompressingClient` (a wrapper
over any :class:`~elephas_tpu_torch.parameter.client.BaseParameterClient`) and
decoded server-side in ``apply_delta`` — the wire stays "a pickled object",
so compressed and plain clients interoperate against one server. Enable
with ``SparkModel(compression='int8' | 'topk:0.01')``.

Explicitly an extension: the reference has no gradient/delta compression of
any kind (SURVEY.md §2.3 "explicitly ABSENT" list).
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

_MARKER = "__elephas_codec__"


# -- codecs -------------------------------------------------------------------


class Int8Codec:
    """Per-array linear int8 quantization of a weight-delta list."""

    name = "int8"

    def encode(self, deltas: List[np.ndarray]) -> dict:
        arrays = []
        for d in deltas:
            d = np.asarray(d, np.float32)
            scale = float(np.max(np.abs(d))) / 127.0 if d.size else 0.0
            q = (np.zeros(d.shape, np.int8) if scale == 0.0
                 else np.clip(np.round(d / scale), -127, 127).astype(np.int8))
            arrays.append({"shape": d.shape, "scale": scale, "q": q})
        return {_MARKER: self.name, "arrays": arrays}

    @staticmethod
    def decode(payload: dict) -> List[np.ndarray]:
        out = []
        for a in payload["arrays"]:
            out.append((a["q"].astype(np.float32) * a["scale"]).reshape(a["shape"]))
        return out


class TopKCodec:
    """Magnitude top-k sparsification with client-side error feedback.

    ``fraction`` of entries (per array, at least 1) survive; the rest are
    remembered in ``self.residual`` and folded into the next ``encode`` —
    over time every coordinate's contribution reaches the server.
    """

    def __init__(self, fraction: float):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"top-k fraction must be in (0, 1], got {fraction}")
        self.fraction = float(fraction)
        self.name = f"topk:{self.fraction}"
        self.residual: Optional[List[np.ndarray]] = None

    def encode(self, deltas: List[np.ndarray]) -> dict:
        if self.residual is None:
            self.residual = [np.zeros_like(np.asarray(d, np.float32))
                             for d in deltas]
        arrays = []
        for i, d in enumerate(deltas):
            d = np.asarray(d, np.float32) + self.residual[i]
            flat = d.ravel()
            k = max(1, int(round(flat.size * self.fraction)))
            if flat.size == 0 or k >= flat.size:
                idx = np.arange(flat.size)  # zero-size or keep-everything
            else:
                idx = np.argpartition(np.abs(flat), flat.size - k)[-k:]
            vals = flat[idx]
            res = d.copy()
            res.ravel()[idx] = 0.0     # what the server got leaves the residual
            self.residual[i] = res
            arrays.append({"shape": d.shape,
                           "idx": idx.astype(np.int64),
                           "vals": vals.astype(np.float32)})
        return {_MARKER: "topk", "arrays": arrays}

    @staticmethod
    def decode(payload: dict) -> List[np.ndarray]:
        out = []
        for a in payload["arrays"]:
            flat = np.zeros(int(np.prod(a["shape"])), np.float32)
            flat[a["idx"]] = a["vals"]
            out.append(flat.reshape(a["shape"]))
        return out


def make_codec(spec: Optional[str]):
    """``None``/``'none'`` → None; ``'int8'``; ``'topk:F'`` (e.g. 0.01)."""
    if spec is None or spec == "none":
        return None
    if spec == "int8":
        return Int8Codec()
    if spec.startswith("topk:"):
        return TopKCodec(float(spec.split(":", 1)[1]))
    raise ValueError(f"Unknown compression spec: {spec!r}")


def maybe_decode(obj: Any) -> List[np.ndarray]:
    """Server-side: transparently decode a compressed push; pass plain
    weight lists through untouched (reference-shaped clients)."""
    if isinstance(obj, dict) and _MARKER in obj:
        kind = obj[_MARKER]
        if kind == "int8":
            return Int8Codec.decode(obj)
        if kind == "topk":
            return TopKCodec.decode(obj)
        raise ValueError(f"Unknown codec marker: {kind!r}")
    return obj


def flush_residual(codec, push_raw, push_tagged, task_id: Optional[str] = None):
    """Push any error-feedback residual as ONE final exact delta and clear
    it: with few pushes per task (e.g. ``frequency='epoch'``, one epoch)
    most of the delta mass would otherwise die with the client. Shared by
    :class:`CompressingClient` and the native binary client — one flush
    contract to keep in sync, not two."""
    residual = getattr(codec, "residual", None)
    if residual is not None and any(
        r.size and np.abs(r).max() > 0 for r in residual
    ):
        if task_id is not None:
            push_tagged(task_id, residual)
        else:
            push_raw(residual)
        codec.residual = None


# -- client wrapper -----------------------------------------------------------


class CompressingClient:
    """Wraps any parameter client: pushes encoded deltas, pulls untouched.

    One wrapper per worker thread (the top-k residual is per-client state,
    like the reference's one-client-per-executor layout).
    """

    def __init__(self, inner, codec):
        self._inner = inner
        self._codec = codec

    def get_parameters(self):
        return self._inner.get_parameters()

    def update_parameters(self, delta):
        self._inner.update_parameters(self._codec.encode(delta))

    def register_attempt(self, task_id, attempt):
        ok = self._inner.register_attempt(task_id, attempt)
        if ok:
            self._tagged = True
        return ok

    def update_parameters_tagged(self, task_id, delta, attempt=None):
        encoded = self._codec.encode(delta)
        if attempt is None:
            self._inner.update_parameters_tagged(task_id, encoded)
        else:
            self._inner.update_parameters_tagged(
                task_id, encoded, attempt=attempt
            )

    def get_version(self):
        return self._inner.get_version()

    def commit_attempt(self, task_id):
        # Flush BEFORE committing, tagged with the task: if the flush (or
        # the commit) fails, the task fails pre-commit and the retry's
        # rollback erases everything — exactly-once is preserved. Flushing
        # after commit would leave a window where a failed untagged flush
        # retries on top of committed pushes.
        flush_residual(self._codec, self._inner.update_parameters,
                       self._inner.update_parameters_tagged, task_id)
        self._inner.commit_attempt(task_id)

    def close(self):
        # Untagged workflow only: best-effort flush on the success path
        # (that mode's at-least-once contract). A TAGGED client must NOT
        # flush here — on the success path commit_attempt already flushed,
        # so a nonzero residual at close means the attempt FAILED and an
        # untagged push would escape the retry's rollback (double-apply).
        if not getattr(self, "_tagged", False):
            flush_residual(self._codec, self._inner.update_parameters,
                           self._inner.update_parameters_tagged)
        self._inner.close()
