"""Continuous-batching LM serving on the dense slot cache (port of
``elephas_tpu/serving``).

- :mod:`~elephas_tpu_torch.serving.cache` — ``SlotKVCache``: one fixed
  ``[L, slots, Hkv, T, Dh]`` KV buffer whose batch axis is the SLOT axis.
- :mod:`~elephas_tpu_torch.serving.scheduler` — bounded FIFO+priority
  admission queue and the per-iteration prefill-vs-decode decision.
- :mod:`~elephas_tpu_torch.serving.engine` — ``ServingEngine``: ``submit()
  → request_id``, ``step()``, ``drain()``, one batched ``decode_step``
  over all slots per iteration.
- :mod:`~elephas_tpu_torch.serving.metrics` — per-request TTFT / queue-wait
  / decode throughput and engine gauges as a JSON snapshot.

The paged KV memory (``serving/memory.py`` in the reference) is a later
slice.
"""

from .cache import SlotKVCache, bucket_length
from .engine import FinishedRequest, ServingEngine
from .metrics import RequestTiming, ServingMetrics
from .scheduler import AdmissionError, Scheduler, ServingRequest

__all__ = [
    "AdmissionError",
    "FinishedRequest",
    "RequestTiming",
    "Scheduler",
    "ServingEngine",
    "ServingMetrics",
    "ServingRequest",
    "SlotKVCache",
    "bucket_length",
]
