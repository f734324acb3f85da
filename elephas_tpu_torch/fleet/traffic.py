"""Trace-driven load generation: the million-user traffic harness.

A serving fleet is only as credible as the traffic it is measured under,
and production traffic is none of the things hand-written test loops are:
arrivals are BURSTY (diurnal rate modulation with superimposed bursts,
not a constant rate), lengths are HEAVY-TAILED (a lognormal body with a
long tail — most prompts are short, the p99 prompt is 50× the median),
and tenants are SKEWED (a Zipf distribution over ``adapter_id``s: a
handful of tenants dominate, a long tail trickles). This module
generates that traffic as a **seeded, fully deterministic, replayable
trace**:

- :class:`TrafficModel` — the generator. Arrivals are a nonhomogeneous
  Poisson process realized by Lewis thinning (draw at the peak rate,
  keep each arrival with probability ``rate(t)/rate_max``), where
  ``rate(t)`` composes a diurnal sine modulation with seeded burst
  windows. Prompt/output lengths are clipped lognormals; tenants are
  Zipf-skewed; interactive tenants carry priorities and deadlines,
  batch tenants ride best-effort. Everything derives from ONE
  ``numpy`` generator seeded at construction — same seed, same trace,
  bit-for-bit.
- :class:`Trace` / :class:`TraceRequest` — the replayable artifact: a
  flat list of concrete requests (arrival time, tenant, prompt TOKENS,
  budget, temperature, seed, deadline, priority) that serializes to
  JSON and back losslessly, so a bench trace can be pinned in a file
  and replayed against any fleet configuration.
- :class:`SimClock` — the explicitly-advanced clock the replay harness
  drives. Engines, router, registry, and autoscaler all read the SAME
  injected clock, so a trace replay is a deterministic simulation:
  deadline misses, SLO attainment, membership epochs, and scale-up
  decisions are pure functions of (trace, fleet config), which is what
  lets tier-1 pin a chaos scenario instead of sampling a flake.

The generator is rate-parameterized, not count-parameterized: the same
model that produces a 30-request tier-1 trace produces the
million-user-scale bench trace by turning up ``base_rps`` and
``duration_s`` — the distributions, not the volume, are what the fleet
policies are exercised against.

A copy of ``elephas_tpu/fleet/traffic.py`` (numpy only): a seeded trace is
the reference's, request for request.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


class SimClock:
    """Explicitly-advanced simulation clock. Unlike the auto-ticking fake
    clocks in the serving tests, reading it NEVER advances it — every
    component of a fleet replay (engines, router, registry, autoscaler)
    shares one instance and sees one consistent notion of now."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"dt must be >= 0, got {dt}")
        self.t += float(dt)
        return self.t


@dataclass
class TraceRequest:
    """One concrete request in a trace — everything the router's
    ``submit`` needs, with the prompt as literal tokens so the trace is
    self-contained and replayable without the generator."""

    request_id: str
    arrival_s: float
    tenant: int                    # adapter_id (fleet fairness key)
    prompt: List[int]
    max_new: int
    temperature: float = 0.0
    seed: int = 0
    priority: int = 0
    deadline_s: Optional[float] = None   # relative to arrival
    eos_id: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TraceRequest":
        return cls(**d)


@dataclass
class Trace:
    """A replayable request trace: ``config`` records the generator
    parameters that produced it (provenance, not behavior — replay reads
    only ``requests``), requests are sorted by arrival time."""

    config: Dict[str, Any] = field(default_factory=dict)
    requests: List[TraceRequest] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.requests)

    def __iter__(self) -> Iterator[TraceRequest]:
        return iter(self.requests)

    @property
    def duration_s(self) -> float:
        return self.requests[-1].arrival_s if self.requests else 0.0

    @property
    def offered_rps(self) -> float:
        """Mean offered load over the trace span."""
        d = self.duration_s
        return len(self.requests) / d if d > 0 else float(len(self.requests))

    def tenants(self) -> Dict[int, int]:
        """Request count per tenant (the Zipf skew, observable)."""
        out: Dict[int, int] = {}
        for r in self.requests:
            out[r.tenant] = out.get(r.tenant, 0) + 1
        return out

    def scaled(self, factor: float) -> "Trace":
        """The SAME requests offered ``factor``× faster (arrival times
        divided by ``factor``) — how the bench sweeps offered load
        without changing the work mix. Deadlines and lengths are
        untouched; only arrival density changes."""
        if factor <= 0:
            raise ValueError(f"factor must be > 0, got {factor}")
        reqs = [TraceRequest(**{**r.to_dict(),
                                "arrival_s": r.arrival_s / factor})
                for r in self.requests]
        cfg = dict(self.config)
        cfg["load_scale"] = cfg.get("load_scale", 1.0) * factor
        return Trace(config=cfg, requests=reqs)

    def to_json(self) -> str:
        return json.dumps({
            "config": self.config,
            "requests": [r.to_dict() for r in self.requests],
        })

    @classmethod
    def from_json(cls, s: str) -> "Trace":
        d = json.loads(s)
        return cls(config=d.get("config", {}),
                   requests=[TraceRequest.from_dict(r)
                             for r in d.get("requests", [])])


def zipf_weights(n: int, a: float) -> np.ndarray:
    """Normalized Zipf pmf over ranks ``0..n-1``: ``p_i ∝ (i+1)^-a``."""
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-float(a))
    return w / w.sum()


class TrafficModel:
    """Seeded generator of bursty, heavy-tailed, tenant-skewed traces.

    Arrival rate composes three layers, all deterministic in the seed::

        rate(t) = base_rps
                  * (1 + diurnal_amp * sin(2π t / diurnal_period_s))
                  * (1 + burst_amp   * in_burst(t))

    ``in_burst`` is an indicator over seeded burst windows (exponential
    gaps of mean ``burst_every_s``, widths of mean ``burst_width_s``) —
    the flash-crowd component diurnal modulation alone misses. The
    process is realized by Lewis thinning at ``rate_max``, so the
    arrival sequence is exact for the composed rate, not a binned
    approximation.

    Lengths: prompt and output budgets are clipped lognormals
    (``*_median`` sets the body, ``*_sigma`` the tail weight — sigma
    ≈1.0 gives a p99/p50 ratio near 10×). Tenants: Zipf(``zipf_a``)
    over ``n_tenants`` adapter ids. The first ``interactive_tenants``
    ranks are the latency-sensitive tier: priority
    ``interactive_priority``, per-request deadline ``deadline_base_s +
    max_new * deadline_per_token_s``, and sampled temperature; the rest
    are batch traffic (priority 0, deadline only if
    ``batch_deadline_s`` is set).
    """

    def __init__(self, *, seed: int = 0, base_rps: float = 4.0,
                 duration_s: float = 30.0, n_tenants: int = 8,
                 zipf_a: float = 1.1,
                 diurnal_period_s: float = 20.0, diurnal_amp: float = 0.5,
                 burst_every_s: float = 10.0, burst_width_s: float = 2.0,
                 burst_amp: float = 2.0,
                 prompt_len_median: float = 6.0, prompt_len_sigma: float = 0.6,
                 prompt_len_max: int = 24,
                 max_new_median: float = 6.0, max_new_sigma: float = 0.6,
                 max_new_max: int = 16,
                 vocab: int = 17,
                 interactive_tenants: int = 2,
                 interactive_priority: int = 1,
                 deadline_base_s: float = 4.0,
                 deadline_per_token_s: float = 0.5,
                 batch_deadline_s: Optional[float] = None,
                 sampled_frac: float = 0.25, temperature: float = 0.8):
        if base_rps <= 0 or duration_s <= 0:
            raise ValueError("base_rps and duration_s must be > 0")
        if not 0 <= diurnal_amp < 1:
            raise ValueError(f"diurnal_amp must be in [0, 1), got {diurnal_amp}")
        if n_tenants < 1:
            raise ValueError(f"n_tenants must be >= 1, got {n_tenants}")
        self.cfg = dict(
            seed=int(seed), base_rps=float(base_rps),
            duration_s=float(duration_s), n_tenants=int(n_tenants),
            zipf_a=float(zipf_a), diurnal_period_s=float(diurnal_period_s),
            diurnal_amp=float(diurnal_amp),
            burst_every_s=float(burst_every_s),
            burst_width_s=float(burst_width_s), burst_amp=float(burst_amp),
            prompt_len_median=float(prompt_len_median),
            prompt_len_sigma=float(prompt_len_sigma),
            prompt_len_max=int(prompt_len_max),
            max_new_median=float(max_new_median),
            max_new_sigma=float(max_new_sigma), max_new_max=int(max_new_max),
            vocab=int(vocab),
            interactive_tenants=int(interactive_tenants),
            interactive_priority=int(interactive_priority),
            deadline_base_s=float(deadline_base_s),
            deadline_per_token_s=float(deadline_per_token_s),
            batch_deadline_s=(None if batch_deadline_s is None
                              else float(batch_deadline_s)),
            sampled_frac=float(sampled_frac), temperature=float(temperature),
        )

    # -- the composed rate ------------------------------------------------
    def _burst_windows(self, rng: np.random.Generator) -> List[tuple]:
        c = self.cfg
        windows, t = [], 0.0
        while t < c["duration_s"]:
            t += rng.exponential(c["burst_every_s"])
            width = rng.exponential(c["burst_width_s"])
            if t < c["duration_s"]:
                windows.append((t, t + width))
            t += width
        return windows

    def _rate(self, t: float, windows: List[tuple]) -> float:
        c = self.cfg
        r = c["base_rps"] * (
            1.0 + c["diurnal_amp"]
            * math.sin(2.0 * math.pi * t / c["diurnal_period_s"]))
        if any(lo <= t < hi for lo, hi in windows):
            r *= 1.0 + c["burst_amp"]
        return r

    def _heavy_len(self, rng: np.random.Generator, median: float,
                   sigma: float, hi: int) -> int:
        draw = math.exp(math.log(median) + sigma * rng.standard_normal())
        return int(min(max(1, round(draw)), hi))

    def generate(self) -> Trace:
        """Realize one trace. Deterministic: a fresh generator with the
        same config returns a bit-identical trace."""
        c = self.cfg
        rng = np.random.default_rng(c["seed"])
        windows = self._burst_windows(rng)
        rate_max = (c["base_rps"] * (1.0 + c["diurnal_amp"])
                    * (1.0 + c["burst_amp"]))
        tenant_p = zipf_weights(c["n_tenants"], c["zipf_a"])
        reqs: List[TraceRequest] = []
        t = 0.0
        while True:
            t += rng.exponential(1.0 / rate_max)
            if t >= c["duration_s"]:
                break
            if rng.random() >= self._rate(t, windows) / rate_max:
                continue  # thinned: this candidate is not an arrival
            i = len(reqs)
            tenant = int(rng.choice(c["n_tenants"], p=tenant_p))
            p_len = self._heavy_len(rng, c["prompt_len_median"],
                                    c["prompt_len_sigma"],
                                    c["prompt_len_max"])
            max_new = self._heavy_len(rng, c["max_new_median"],
                                      c["max_new_sigma"], c["max_new_max"])
            prompt = rng.integers(0, c["vocab"], size=p_len).tolist()
            interactive = tenant < c["interactive_tenants"]
            if interactive:
                deadline = (c["deadline_base_s"]
                            + max_new * c["deadline_per_token_s"])
            else:
                deadline = c["batch_deadline_s"]
            sampled = rng.random() < c["sampled_frac"]
            reqs.append(TraceRequest(
                request_id=f"t{i}",
                arrival_s=round(float(t), 6),
                tenant=tenant,
                prompt=[int(x) for x in prompt],
                max_new=max_new,
                temperature=c["temperature"] if sampled else 0.0,
                seed=int(rng.integers(0, 2**31 - 1)),
                priority=c["interactive_priority"] if interactive else 0,
                deadline_s=deadline,
                eos_id=None,
            ))
        return Trace(config=dict(c), requests=reqs)
