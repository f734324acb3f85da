"""Deadline-driven fleet autoscaling on the injectable clock.

The autoscaler closes the loop the router leaves open: the router
places work on whatever partitions exist; the autoscaler decides how
many SHOULD exist. Two signals drive it, both already maintained by the
router and both observable deterministically in trace replay:

- **Queue depth** — requests waiting in the fleet policy queue. A
  persistently deep queue means offered load exceeds fleet capacity.
- **Deadline-miss rate** — the fraction of deadline-carrying requests
  that completed OUTSIDE their SLO (late, reaped, or shed) within the
  last decision window. Queue depth leads, miss rate confirms: depth
  spikes before misses materialize, so scaling on depth alone
  over-reacts to bursts the fleet would have absorbed, and scaling on
  misses alone reacts one SLO-violation too late. Either signal past
  its high-water mark triggers scale-UP; BOTH below their low-water
  marks (and a drained queue) triggers scale-DOWN.

Scaling actions go through the router's own membership surface —
:meth:`~elephas_tpu_torch.fleet.router.FleetRouter.join_partition` to grow,
:meth:`~elephas_tpu_torch.fleet.router.FleetRouter.retire_partition` (graceful
migration, no lost work) to shrink — so a scale event is just another
membership-epoch change the fleet already handles. ``cooldown_s``
separates decisions: fleets oscillate when the controller outruns the
effect of its own actions (a new partition needs a few steps of
prefills before it absorbs anything).

Every decision is a pure function of (router counters, clock), so the
judged bench's recovery scenario — miss rate spikes under a burst,
scale-up lands, miss rate recovers — replays bit-identically in tier-1.

A copy of ``elephas_tpu/fleet/autoscaler.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .router import OK_REASONS, FleetRouter


class Autoscaler:
    """Grow/shrink a :class:`~elephas_tpu_torch.fleet.router.FleetRouter`
    against queue depth and windowed deadline-miss rate.

    ``queue_high``/``queue_low`` are fleet-queue depths per LIVE
    partition (so thresholds scale with the fleet);
    ``miss_rate_high``/``miss_rate_low`` bound the per-window fraction
    of deadline-carrying completions that violated their SLO.
    """

    def __init__(self, router: FleetRouter, *,
                 min_partitions: int = 1, max_partitions: int = 8,
                 cooldown_s: float = 1.0,
                 queue_high: float = 4.0, queue_low: float = 0.5,
                 miss_rate_high: float = 0.2, miss_rate_low: float = 0.05):
        if min_partitions < 1 or max_partitions < min_partitions:
            raise ValueError(
                f"need 1 <= min_partitions <= max_partitions, got "
                f"{min_partitions}..{max_partitions}")
        if cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        self.router = router
        self.min_partitions = int(min_partitions)
        self.max_partitions = int(max_partitions)
        self.cooldown_s = float(cooldown_s)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.miss_rate_high = float(miss_rate_high)
        self.miss_rate_low = float(miss_rate_low)
        self._last_action_at: Optional[float] = None
        # completion counters at the last decision, for windowed rates
        self._seen_deadline_done = 0
        self._seen_deadline_missed = 0
        self.events: List[Dict[str, Any]] = []

    # -- signals ----------------------------------------------------------
    def _deadline_counts(self) -> tuple:
        """(done, missed) over all deadline-carrying terminal requests."""
        done = missed = 0
        for s in self.router._states.values():
            if s.deadline_at is None or s.status != "done":
                continue
            done += 1
            late = (s.finished_at is not None
                    and s.finished_at > s.deadline_at)
            if s.finish_reason not in OK_REASONS or late:
                missed += 1
        return done, missed

    def window_miss_rate(self) -> Optional[float]:
        """Deadline-miss fraction among completions since the last
        decision — ``None`` when the window saw no deadline completions
        (no evidence either way)."""
        done, missed = self._deadline_counts()
        d = done - self._seen_deadline_done
        m = missed - self._seen_deadline_missed
        return (m / d) if d > 0 else None

    # -- the control decision ---------------------------------------------
    def maybe_scale(self, now: float) -> Optional[str]:
        """Poll once; returns ``"up"``, ``"down"``, or ``None``. Call
        every driver iteration — cooldown gating is internal."""
        if (self._last_action_at is not None
                and now - self._last_action_at < self.cooldown_s):
            return None
        n = self.router.n_live
        depth = self.router.policy.queue_depth
        per_part = depth / max(n, 1)
        miss = self.window_miss_rate()
        action = None
        if n < self.max_partitions and (
                per_part >= self.queue_high
                or (miss is not None and miss >= self.miss_rate_high)):
            pid = self.router.join_partition()
            action = "up"
        elif (n > self.min_partitions and depth == 0
                and per_part <= self.queue_low
                and (miss is None or miss <= self.miss_rate_low)):
            # retire the highest-numbered idle-most partition; graceful
            # retire migrates anything it still holds
            pid = max(self.router.partition_ids())
            self.router.retire_partition(pid)
            action = "down"
        if action is not None:
            self._last_action_at = now
            done, missed = self._deadline_counts()
            self._seen_deadline_done = done
            self._seen_deadline_missed = missed
            self.events.append({
                "t": round(float(now), 6), "action": action, "pid": pid,
                "n_live": self.router.n_live, "queue_depth": depth,
                "window_miss_rate": (None if miss is None
                                     else round(miss, 4)),
            })
        return action

    def snapshot(self) -> Dict[str, Any]:
        return {
            "n_live": self.router.n_live,
            "bounds": [self.min_partitions, self.max_partitions],
            "events": list(self.events),
        }
