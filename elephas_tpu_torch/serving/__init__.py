"""Continuous-batching LM serving on a dense slot cache or a paged pool
(port of ``elephas_tpu/serving``).

- :mod:`~elephas_tpu_torch.serving.cache` — ``SlotKVCache``: one fixed
  ``[L, slots, Hkv, T, Dh]`` KV buffer whose batch axis is the SLOT axis.
- :mod:`~elephas_tpu_torch.serving.scheduler` — bounded FIFO+priority
  admission queue and the per-iteration prefill-vs-decode decision.
- :mod:`~elephas_tpu_torch.serving.engine` — ``ServingEngine``: ``submit()
  → request_id``, ``step()``, ``drain()``, one batched ``decode_step``
  over all slots per iteration, or, with ``speculate_k``, a drafter
  (``NgramDrafter``, ``ModelDrafter``) and one verify chunk.
- :mod:`~elephas_tpu_torch.serving.metrics` — per-request TTFT / queue-wait
  / decode throughput and engine gauges as a JSON snapshot.

- :mod:`~elephas_tpu_torch.serving.memory` — ``PagedKVCache``: the paged
  alternative (``paged=True`` on the engine): KV in a pool of fixed-size
  pages behind per-slot block tables, refcounted by ``BlockAllocator``,
  with a ``RadixPrefixCache`` sharing prompt-prefix pages between requests.
"""

from .cache import SlotKVCache, bucket_length
from .engine import FinishedRequest, ModelDrafter, NgramDrafter, ServingEngine
from .memory import (BlockAllocator, PagedKVCache, PagesExhausted,
                     RadixPrefixCache)
from .metrics import RequestTiming, ServingMetrics
from .scheduler import AdmissionError, Scheduler, ServingRequest

__all__ = [
    "AdmissionError",
    "BlockAllocator",
    "FinishedRequest",
    "ModelDrafter",
    "NgramDrafter",
    "PagedKVCache",
    "PagesExhausted",
    "RadixPrefixCache",
    "RequestTiming",
    "Scheduler",
    "ServingEngine",
    "ServingMetrics",
    "ServingRequest",
    "SlotKVCache",
    "bucket_length",
]
