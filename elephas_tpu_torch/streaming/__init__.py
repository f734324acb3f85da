"""Streaming training with live serving weight rollover.

The batch pipeline ends at ``fit()``: train, converge, export. This
package is the train-to-serve loop that never ends — micro-batches flow
in, every commit advances the parameter server's monotonic weight
version, and a publisher pushes fresh weights into a live
:class:`~elephas_tpu_torch.serving.engine.ServingEngine` without draining it.

Three pieces, one direction of data flow::

    micro-batches ──> StreamTrainer ──commits──> WeightPublisher
                          │ push/pull                 │ gated publish
                          ▼                           ▼
                    parameter server ──pull──> ServingEngine.swap_params

- :class:`StreamTrainer` — the ingest loop: pull weights, run one train
  step on a micro-batch, push the delta, stamp the commit with the
  server's post-commit version.
- :class:`WeightPublisher` — bounded-staleness publication: every N
  commits or T seconds, pull ``(version, weights)``, run the eval gate on
  a held-out micro-batch, publish to the sink — or roll the sink back to
  the last good version on a regression. Keeps a bounded ring of recent
  versions and a JSON-able history, checkpointable through
  :class:`~elephas_tpu_torch.resilience.supervisor.TrainingSupervisor`.
- :func:`engine_sink` / the params bridge — the adapter that turns the
  server's flat weight list back into the model's named-params dict and
  hot-swaps it between decode rounds.

Version semantics (pinned by ``tests/streaming/``): every served token is
attributable to exactly one weight version, version boundaries fall only
between decode rounds, and a stream is token-identical to a replay of the
same version schedule.

The port's package keeps the reference's ``__all__``.
"""

from .bridge import list_to_params, params_to_list
from .publisher import PublishRecord, WeightPublisher, engine_sink
from .trainer import StreamCommit, StreamTrainer

__all__ = [
    "StreamCommit",
    "StreamTrainer",
    "WeightPublisher",
    "PublishRecord",
    "engine_sink",
    "params_to_list",
    "list_to_params",
]
