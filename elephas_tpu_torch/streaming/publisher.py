"""PS -> serving weight publication with bounded staleness and rollback.

:class:`WeightPublisher` sits between the training side's commit stream
and a serving sink. Its contract:

- **Bounded staleness** — publish at least every ``publish_every``
  commits or ``max_interval_s`` seconds, whichever fires first. Serving
  weights are never more than one cadence window behind the PS.
- **Eval gate** — each candidate pull is scored by ``eval_fn`` on a
  held-out micro-batch before it reaches the sink. A regression (loss
  worse than the last published good loss by more than
  ``regression_margin``) is NOT published; instead the sink is rolled
  back to the last good version — republished with its ORIGINAL stamp,
  because the serving version gauge records what is serving, not a
  monotone sequence.
- **Bounded ring** — the last ``ring_size`` published versions (weights
  included) are retained for inspection/rollback; older ones fall off.
- **Checkpointable** — :meth:`state_dict` is pure JSON (counters +
  history, no arrays) so the supervisor can persist it; resuming with the
  same commit stream replays the identical version history.

A copy of ``elephas_tpu/streaming/publisher.py``; :func:`engine_sink`
swaps into the port's :class:`~elephas_tpu_torch.serving.engine.ServingEngine`.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from .bridge import list_to_params


@dataclass(frozen=True)
class PublishRecord:
    """One publisher decision. ``event`` is ``"publish"`` or
    ``"rollback"``; ``version`` is the version the SINK is serving after
    the decision (on rollback, the last good version — and
    ``rejected_version`` is the regressed candidate that was refused)."""

    event: str
    version: int
    commit_index: int
    eval_loss: Optional[float] = None
    rejected_version: Optional[int] = None


class WeightPublisher:
    """Cadence-gated, eval-gated publication from a PS client to a sink.

    ``sink(weights, version)`` receives the PS wire-order weight list and
    the version stamp — :func:`engine_sink` adapts it onto
    ``ServingEngine.swap_params``. ``clock`` is injectable (tests pass a
    fake) and only drives the ``max_interval_s`` cadence leg.
    """

    def __init__(self, client, sink: Callable[[List[np.ndarray], int], None],
                 *, publish_every: int = 1,
                 max_interval_s: Optional[float] = None,
                 eval_fn: Optional[Callable[[List[np.ndarray], Any], float]] = None,
                 eval_batch: Any = None,
                 regression_margin: float = 0.0,
                 ring_size: int = 4,
                 clock: Callable[[], float] = time.monotonic):
        if publish_every < 1:
            raise ValueError("publish_every must be >= 1")
        if ring_size < 1:
            raise ValueError("ring_size must be >= 1")
        self.client = client
        self.sink = sink
        self.publish_every = int(publish_every)
        self.max_interval_s = max_interval_s
        self.eval_fn = eval_fn
        self.eval_batch = eval_batch
        self.regression_margin = float(regression_margin)
        self.clock = clock
        # (version, weights, eval_loss) for the newest ring_size publishes
        self.ring: Deque[Tuple[int, List[np.ndarray], Optional[float]]] = \
            deque(maxlen=int(ring_size))
        self.history: List[PublishRecord] = []
        self.commits_since = 0
        self.published = 0
        self.rollbacks = 0
        self.serving_version = -1       # what the sink is serving now
        self.last_good_version = -1
        self.last_good_loss: Optional[float] = None
        self._last_good_weights: Optional[List[np.ndarray]] = None
        self._last_publish_t = clock()

    # -- cadence ----------------------------------------------------------
    def offer(self, commit) -> Optional[PublishRecord]:
        """Feed one :class:`StreamCommit`; publishes iff a cadence leg is
        due (every N commits, or T seconds since the last publication).
        Returns the record when a publication/rollback happened."""
        self.commits_since += 1
        due = self.commits_since >= self.publish_every
        if not due and self.max_interval_s is not None:
            due = (self.clock() - self._last_publish_t
                   >= self.max_interval_s)
        if not due:
            return None
        return self.publish(commit_index=commit.index)

    # -- publication ------------------------------------------------------
    def _pull(self) -> Tuple[int, List[np.ndarray]]:
        weights = self.client.get_parameters()
        # the transports piggyback the version on the pull itself (HTTP
        # header / socket b"G" pair); a legacy transport falls back to an
        # explicit (slightly racy) version read, then to -1 = unversioned
        version = int(getattr(self.client, "last_seen_version", -1))
        if version < 0:
            version = int(self.client.get_version())
        return version, weights

    def publish(self, commit_index: int = -1) -> PublishRecord:
        """Pull, gate, and push one candidate to the sink (or roll back)."""
        version, weights = self._pull()
        loss: Optional[float] = None
        if self.eval_fn is not None:
            loss = float(self.eval_fn(weights, self.eval_batch))
            if (self.last_good_loss is not None
                    and loss > self.last_good_loss + self.regression_margin):
                return self._rollback(commit_index, version, loss)
        kept = [np.array(w) for w in weights]  # detach from the live master
        self.sink(kept, version)
        self.serving_version = version
        self.last_good_version = version
        if loss is not None:
            self.last_good_loss = loss
        self._last_good_weights = kept
        self.ring.append((version, kept, loss))
        self.published += 1
        record = PublishRecord("publish", version, int(commit_index), loss)
        self.history.append(record)
        self.commits_since = 0
        self._last_publish_t = self.clock()
        return record

    def _rollback(self, commit_index: int, rejected_version: int,
                  loss: float) -> PublishRecord:
        """The candidate regressed: put the last good version back on the
        sink (with its original stamp) and refuse the candidate. The PS
        keeps training — a later candidate that clears the gate publishes
        normally."""
        self.rollbacks += 1
        if (self._last_good_weights is not None
                and self.serving_version != self.last_good_version):
            self.sink(self._last_good_weights, self.last_good_version)
        self.serving_version = self.last_good_version
        record = PublishRecord("rollback", self.last_good_version,
                               int(commit_index), loss,
                               rejected_version=int(rejected_version))
        self.history.append(record)
        self.commits_since = 0
        self._last_publish_t = self.clock()
        return record

    def ring_versions(self) -> List[int]:
        return [v for v, _w, _l in self.ring]

    # -- checkpoint -------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """Pure-JSON state (no weight arrays — the checkpoint's weight
        payload is the PS master, saved alongside by the supervisor)."""
        return {
            "commits_since": self.commits_since,
            "published": self.published,
            "rollbacks": self.rollbacks,
            "serving_version": self.serving_version,
            "last_good_version": self.last_good_version,
            "last_good_loss": self.last_good_loss,
            "ring_versions": self.ring_versions(),
            "history": [asdict(r) for r in self.history],
        }

    def load_state_dict(self, state: Dict[str, Any],
                        weights: Optional[List[np.ndarray]] = None) -> None:
        """Restore counters + history; ``weights`` (if given) re-seeds the
        last-good weight payload (checkpointed PS master) so a post-resume
        regression can still roll back."""
        self.commits_since = int(state.get("commits_since", 0))
        self.published = int(state.get("published", 0))
        self.rollbacks = int(state.get("rollbacks", 0))
        self.serving_version = int(state.get("serving_version", -1))
        self.last_good_version = int(state.get("last_good_version", -1))
        loss = state.get("last_good_loss")
        self.last_good_loss = None if loss is None else float(loss)
        self.history = [PublishRecord(**r) for r in state.get("history", [])]
        if weights is not None:
            kept = [np.array(w) for w in weights]
            self._last_good_weights = kept
            self.ring.append((self.last_good_version, kept,
                              self.last_good_loss))


def engine_sink(engine, template: Dict[str, Any]):
    """Adapt a live :class:`~elephas_tpu_torch.serving.engine.ServingEngine`
    into a publisher sink: wire-order weights are bridged back to the
    model's named params and hot-swapped between decode rounds. The main
    weights only — a ModelDrafter stands down until its own params are
    refreshed (see ``ServingEngine.swap_params``)."""
    def sink(weights: List[np.ndarray], version: int) -> None:
        engine.swap_params(list_to_params(weights, template),
                           version=version)
    return sink
