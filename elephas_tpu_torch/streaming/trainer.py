"""The streaming ingest loop: micro-batch in, versioned commit out.

:class:`StreamTrainer` reuses the batch pipeline's machinery wholesale —
the same parameter-server clients (http/socket/native, with the failover/
resilience wrapper stack), the same delta convention
(``delta = before - after``; the server applies ``master - delta``), the
same tagged-push exactly-once protocol. What it adds is the STREAM
contract: batches are consumed exactly once, in order, and every commit
carries the server's monotonic weight version, which is what the
publisher's staleness bound and the supervisor's deterministic
version-history replay hang off.

A copy of ``elephas_tpu/streaming/trainer.py`` over the port's
``utils.functional_utils.subtract_params_np``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, List, Optional, Tuple

import numpy as np

from ..utils.functional_utils import subtract_params_np

TrainFn = Callable[[List[np.ndarray], Any], Tuple[List[np.ndarray], float]]


@dataclass(frozen=True)
class StreamCommit:
    """One applied micro-batch: its ingest ordinal, the server's weight
    version AFTER the delta applied, and the step's training loss."""

    index: int
    version: int
    loss: float


class StreamTrainer:
    """Pull -> train one micro-batch -> push delta -> stamp version.

    ``train_fn(weights, batch) -> (new_weights, loss)`` runs in PS wire
    order (``List[np.ndarray]``) — use the :mod:`~elephas_tpu_torch.streaming.bridge`
    if the step function wants named params. The trainer registers a task
    attempt up front so its pushes ride the server's exactly-once fence
    when the transport supports it, and degrades to plain pushes (the
    reference's at-least-once) when it doesn't.

    Version stamping: the commit's ``version`` is ``client.get_version()``
    read after the push. With one streaming writer (this pipeline's
    topology) that is exactly the version this delta produced; concurrent
    batch workers sharing the server would make it an upper bound, which
    still bounds publisher staleness correctly. A transport with no
    version API yields ``-1`` stamps — the publisher then falls back to
    its own pull-side versioning.
    """

    def __init__(self, client, train_fn: TrainFn, *,
                 task_id: str = "stream-trainer"):
        self.client = client
        self.train_fn = train_fn
        self.task_id = str(task_id)
        self.commits = 0
        self.last_loss: Optional[float] = None
        self._tagged = False
        self._registered = False

    def _ensure_registered(self) -> None:
        if self._registered:
            return
        # one long-lived attempt: the stream IS attempt 0; a supervisor
        # restart re-registers the same pair, which is idempotent
        self._tagged = bool(self.client.register_attempt(self.task_id, 0))
        self._registered = True

    def step(self, batch: Any, index: Optional[int] = None) -> StreamCommit:
        """Apply one micro-batch to the server; returns its commit."""
        self._ensure_registered()
        before = [np.asarray(w) for w in self.client.get_parameters()]
        after, loss = self.train_fn(before, batch)
        delta = subtract_params_np(before, after)
        if self._tagged:
            self.client.update_parameters_tagged(self.task_id, delta,
                                                 attempt=0)
        else:
            self.client.update_parameters(delta)
        version = int(self.client.get_version())
        idx = self.commits if index is None else int(index)
        self.commits += 1
        self.last_loss = float(loss)
        return StreamCommit(index=idx, version=version, loss=float(loss))

    def run(self, batches: Iterable[Any], publisher=None,
            start_index: int = 0,
            on_commit: Optional[Callable[[StreamCommit], None]] = None,
            ) -> List[StreamCommit]:
        """Drain ``batches`` in order, skipping ordinals below
        ``start_index`` (the resume cursor: already-committed batches are
        NOT re-applied — exactly-once consumption is what makes the
        version history replay deterministically). Each commit is offered
        to ``publisher`` (if any), then to ``on_commit``."""
        commits: List[StreamCommit] = []
        for i, batch in enumerate(batches):
            if i < start_index:
                continue
            commit = self.step(batch, index=i)
            commits.append(commit)
            if publisher is not None:
                publisher.offer(commit)
            if on_commit is not None:
                on_commit(commit)
        return commits
