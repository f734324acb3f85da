"""Training supervisor: checkpoint, crash, auto-resume.

The layering below the supervisor already absorbs *task-scoped* failure:
the facade RDD re-executes dead partitions (Spark-parity ``maxFailures``)
and the parameter server's stage-scoped task-id attempt machinery keeps
retried async pushes exactly-once. What nothing absorbs is *whole-fit*
death — driver OOM, preemption, an
:class:`~elephas_tpu_torch.resilience.faults.InjectedWorkerCrash` escaping a fit
chunk. :class:`TrainingSupervisor` owns that layer: it wraps
``SparkModel.fit`` so the job checkpoints every ``checkpoint_frequency``
epochs, and on a crash restarts the fit resuming from the latest VALID
checkpoint (``has_checkpoint`` refuses partially written directories),
up to ``max_restarts`` times with backoff.

Two delegation modes, chosen by the model's comm path:

- ``comm='jax'`` — delegate to ``SparkModel.fit``'s native checkpointed
  path, which carries optimizer state AND (sync+epoch) the per-worker
  weight stacks across chunks, so a crash-resume run merges exactly like
  an uninterrupted one.
- host paths — the supervisor chunks epochs itself: fit ``chunk`` epochs,
  snapshot the master weights, repeat; resume restores weights and the
  epoch cursor. (Host-path optimizer state lives in throwaway per-worker
  replicas, so weights + epoch IS the whole resumable state.)

Every lifecycle transition is recorded as a :class:`SupervisorEvent`
(``events`` list + optional ``on_event`` callback) so tests and operators
can see exactly what the recovery did.

A copy of ``elephas_tpu/resilience/supervisor.py`` over the port's
:mod:`elephas_tpu_torch.utils.checkpoint`; ``comm='jax'`` is the port's
compiled path (:class:`~elephas_tpu_torch.parallel.engine.CompiledTrainer`),
which keeps the reference's name for it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..utils.checkpoint import has_checkpoint, load_checkpoint, save_checkpoint
from .policy import RetryPolicy


class SupervisorAborted(RuntimeError):
    """The restart budget is spent (or the error was not restartable);
    ``__cause__`` is the final crash."""


@dataclass
class SupervisorEvent:
    """One lifecycle transition: ``kind`` in ``{"start", "resume", "crash",
    "complete"}``, the restart count when it happened, and free-form
    detail (crash repr, resume epoch)."""

    kind: str
    restarts: int
    detail: str = ""
    info: Dict[str, Any] = field(default_factory=dict)


class TrainingSupervisor:
    """Run ``SparkModel.fit`` to completion across crashes.

    ``restart_policy`` is consulted only for pacing (``delay``/``sleep``)
    between restarts — the budget is ``max_restarts``, not the policy's
    attempt cap. By default restarts are immediate (tests shouldn't wait);
    production callers pass a backoff so a crash-looping job doesn't spin.

    ``should_restart`` filters crashes: anything it rejects aborts
    immediately. The default restarts every ``Exception`` —
    ``KeyboardInterrupt``/``SystemExit`` propagate regardless.
    """

    def __init__(self, model, checkpoint_dir: str, *,
                 checkpoint_frequency: int = 1,
                 max_restarts: int = 3,
                 restart_policy: Optional[RetryPolicy] = None,
                 should_restart: Callable[[BaseException], bool] = lambda e: True,
                 on_event: Optional[Callable[[SupervisorEvent], None]] = None):
        if checkpoint_frequency < 1:
            raise ValueError("checkpoint_frequency must be >= 1")
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        self.model = model
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_frequency = int(checkpoint_frequency)
        self.max_restarts = int(max_restarts)
        self.restart_policy = restart_policy or RetryPolicy(
            base_delay_s=0.0, jitter=0.0
        )
        self.should_restart = should_restart
        self.on_event = on_event
        self.restarts = 0
        self.events: List[SupervisorEvent] = []

    def _emit(self, kind: str, detail: str = "", **info) -> None:
        event = SupervisorEvent(kind, self.restarts, detail, dict(info))
        self.events.append(event)
        if self.on_event is not None:
            self.on_event(event)

    def fit(self, rdd, epochs: int = 10, **fit_kwargs) -> None:
        """Train to ``epochs`` total epochs, surviving up to
        ``max_restarts`` crashes. Raises :class:`SupervisorAborted` when
        the budget runs out."""
        self._supervise(
            lambda resume: self._run_fit(rdd, epochs, resume, fit_kwargs),
            {"epochs": epochs},
        )

    def fit_stream(self, batches, trainer, *, publisher=None,
                   checkpoint_every: Optional[int] = None) -> None:
        """Drain a finite micro-batch stream through ``trainer``
        (:class:`~elephas_tpu_torch.streaming.trainer.StreamTrainer`), surviving
        crashes the same way :meth:`fit` does. The checkpoint carries the
        CURSOR (batches consumed) plus the publisher's JSON state and the
        current PS master weights; on resume, already-committed batches
        are skipped — exactly-once consumption — so the parameter server's
        version history (and therefore the publisher's publish/rollback
        history) replays deterministically at a fixed seed. The PS itself
        is assumed to outlive the driver-side crash (it holds the
        authoritative weights); the checkpointed weights exist for the
        cold-restart case where the PS must be reseeded too.

        ``checkpoint_every`` defaults to ``checkpoint_frequency``
        (commits, not epochs, in this mode)."""
        batches = list(batches)
        every = (self.checkpoint_frequency if checkpoint_every is None
                 else int(checkpoint_every))
        if every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        self._supervise(
            lambda resume: self._run_stream(batches, trainer, publisher,
                                            every, resume),
            {"batches": len(batches)},
        )

    def _supervise(self, attempt: Callable[[bool], None],
                   complete_info: Dict[str, Any]) -> None:
        while True:
            resume = has_checkpoint(self.checkpoint_dir)
            self._emit(
                "resume" if resume else "start",
                detail=self.checkpoint_dir if resume else "",
            )
            try:
                attempt(resume)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as err:
                if not self.should_restart(err):
                    raise SupervisorAborted(
                        f"crash not restartable: {err!r}"
                    ) from err
                if self.restarts >= self.max_restarts:
                    raise SupervisorAborted(
                        f"restart budget ({self.max_restarts}) exhausted; "
                        f"last crash: {err!r}"
                    ) from err
                self._emit("crash", detail=repr(err))
                pause = self.restart_policy.delay(self.restarts)
                self.restarts += 1
                if pause > 0.0:
                    self.restart_policy.sleep(pause)
                continue
            self._emit("complete", **complete_info)
            return

    # -- one attempt ------------------------------------------------------
    def _run_fit(self, rdd, epochs: int, resume: bool,
                 fit_kwargs: Dict[str, Any]) -> None:
        if getattr(self.model, "comm", None) == "jax":
            self.model.fit(
                rdd, epochs=epochs,
                checkpoint_dir=self.checkpoint_dir,
                checkpoint_frequency=self.checkpoint_frequency,
                resume=resume, **fit_kwargs,
            )
            return
        self._run_fit_host(rdd, epochs, resume, fit_kwargs)

    def _run_fit_host(self, rdd, epochs: int, resume: bool,
                      fit_kwargs: Dict[str, Any]) -> None:
        network = self.model.master_network
        start_epoch = 0
        if resume:
            weights, meta, _ = load_checkpoint(self.checkpoint_dir)
            network.set_weights(weights)
            start_epoch = int(meta.get("epoch", 0))
        epoch = start_epoch
        while epoch < epochs:
            chunk = min(self.checkpoint_frequency, epochs - epoch)
            self.model.fit(rdd, epochs=chunk, **fit_kwargs)
            epoch += chunk
            save_checkpoint(
                self.checkpoint_dir,
                [np.asarray(w) for w in network.get_weights()],
                {"epoch": epoch, "epochs": epochs, "mode": self.model.mode},
            )

    # -- one streaming attempt --------------------------------------------
    def _run_stream(self, batches, trainer, publisher, every: int,
                    resume: bool) -> None:
        start = 0
        if resume:
            _weights, meta, _ = load_checkpoint(self.checkpoint_dir)
            stream = meta.get("stream", {})
            start = int(stream.get("batches_done", 0))
            trainer.commits = int(stream.get("commits", trainer.commits))
            if publisher is not None and stream.get("publisher") is not None:
                publisher.load_state_dict(stream["publisher"],
                                          weights=_weights)
        done = start
        for i, batch in enumerate(batches):
            if i < start:
                continue  # committed before the crash: never re-applied
            commit = trainer.step(batch, index=i)
            if publisher is not None:
                publisher.offer(commit)
            done = i + 1
            if done % every == 0:
                self._checkpoint_stream(trainer, publisher, done)
        if done % every != 0 or done == start:
            self._checkpoint_stream(trainer, publisher, done)

    def _checkpoint_stream(self, trainer, publisher, done: int) -> None:
        weights = [np.asarray(w) for w in trainer.client.get_parameters()]
        meta: Dict[str, Any] = {
            "mode": "stream",
            "stream": {
                "batches_done": int(done),
                "commits": int(trainer.commits),
                "publisher": (None if publisher is None
                              else publisher.state_dict()),
            },
        }
        save_checkpoint(self.checkpoint_dir, weights, meta)
