"""Per-tenant admission control: token-bucket budgets by (tenant, class).

At saturation a batch-class tenant can otherwise starve interactive p99 —
update mega-batches and huge degree scans fill every dispatch window and
the interactive queue's deadlines slip unboundedly.  Admission control
bounds each ``(tenant, latency_class)`` pair to a sustained lane rate with
a burst allowance (the classic token bucket, refilled from the frontend's
injectable clock so tests and replays meter virtual time):

  * within budget    -> **admit** (tokens consumed = request lanes);
  * over budget      -> **defer** for batch-class traffic (the request is
    parked and re-offered as tokens refill — batch work is throughput
    traffic, it waits); **shed** for interactive/standard (completing a
    latency-bound request seconds late is worse than a fast reject the
    caller can retry against another frontend);
  * a deferred backlog past ``defer_cap_lanes`` sheds too — an unbounded
    park queue is just a slower starvation.

Every decision lands on the serving metrics registry
(``serve.admitted`` / ``serve.shed`` / ``serve.deferred`` counters by
tenant and class), so shed accounting is checkable: submitted = completed
+ shed + still queued, always.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

ADMIT = "admit"
DEFER = "defer"
SHED = "shed"


@dataclasses.dataclass
class TokenBucket:
    """Lane-rate token bucket metered on an external clock."""
    rate: float                 # lanes/s sustained
    burst: float                # bucket capacity in lanes
    tokens: float = 0.0
    t_last: Optional[float] = None

    def refill(self, now: float) -> None:
        if self.t_last is None:
            self.tokens = self.burst       # start full: a cold tenant may burst
        else:
            dt = max(0.0, now - self.t_last)   # replay clocks may jitter back
            self.tokens = min(self.burst, self.tokens + self.rate * dt)
        self.t_last = max(now, self.t_last or now)

    # refill accumulates rate*dt in floats: without a tolerance a bucket
    # can sit an ulp short of ``lanes`` forever while eta() keeps promising
    # an epsilon-future retry time — a scheduler livelock
    EPS = 1e-6

    def try_take(self, lanes: int, now: float) -> bool:
        self.refill(now)
        if self.tokens + self.EPS >= lanes:
            self.tokens = max(0.0, self.tokens - lanes)
            return True
        return False

    def eta(self, lanes: int, now: float) -> float:
        """Seconds until ``lanes`` tokens will be available (0 if now)."""
        self.refill(now)
        deficit = lanes - self.tokens
        if deficit <= self.EPS:
            return 0.0
        return deficit / self.rate if self.rate > 0 else float("inf")


class AdmissionController:
    """Budgets per (tenant, latency_class); unbudgeted pairs always admit."""

    def __init__(self, default_rate: float = 0.0, default_burst: int = 0,
                 defer_cap_lanes: Optional[int] = None):
        self.default_rate = float(default_rate)
        self.default_burst = int(default_burst)
        # park-queue bound: beyond this many deferred lanes per (tenant,
        # class), batch traffic sheds as well
        self.defer_cap_lanes = (int(defer_cap_lanes)
                                if defer_cap_lanes is not None
                                else max(8 * self.default_burst, 1 << 14))
        self._buckets: Dict[Tuple[str, str], TokenBucket] = {}
        self._overrides: Dict[str, Tuple[float, int]] = {}
        self._deferred_lanes: Dict[Tuple[str, str], int] = {}

    def set_budget(self, tenant: str, rate: float, burst: int) -> None:
        """Per-tenant override of the plan's default budget (rate<=0 turns
        admission *off* for that tenant)."""
        self._overrides[tenant] = (float(rate), int(burst))
        for key in [k for k in self._buckets if k[0] == tenant]:
            del self._buckets[key]

    def _bucket(self, tenant: str, cls: str) -> Optional[TokenBucket]:
        rate, burst = self._overrides.get(
            tenant, (self.default_rate, self.default_burst))
        if rate <= 0:
            return None
        key = (tenant, cls)
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = TokenBucket(rate=rate, burst=float(burst))
        return b

    def admit(self, tenant: str, cls: str, lanes: int, now: float) -> str:
        """One of ``admit`` / ``defer`` / ``shed`` for an offered request."""
        b = self._bucket(tenant, cls)
        if b is None or b.try_take(lanes, now):
            return ADMIT
        if b.burst < lanes:
            return SHED     # wider than the bucket: deferring = waiting forever
        if cls == "batch" and \
                self._deferred_lanes.get((tenant, cls), 0) < self.defer_cap_lanes:
            return DEFER
        return SHED

    def try_readmit(self, tenant: str, cls: str, lanes: int,
                    now: float) -> bool:
        """Re-offer an already-deferred request: admit or keep parked
        (never sheds — the park decision was made at submit time)."""
        b = self._bucket(tenant, cls)
        return b is None or b.try_take(lanes, now)

    def retry_eta(self, tenant: str, cls: str, lanes: int, now: float) -> float:
        """When a deferred request's tokens will next suffice (absolute)."""
        b = self._bucket(tenant, cls)
        return now if b is None else now + b.eta(lanes, now)

    # deferred-lane accounting (the scheduler parks/unparks, we just count
    # so the defer cap can bound the park queue)

    def on_defer(self, tenant: str, cls: str, lanes: int) -> None:
        key = (tenant, cls)
        self._deferred_lanes[key] = self._deferred_lanes.get(key, 0) + lanes

    def on_undefer(self, tenant: str, cls: str, lanes: int) -> None:
        key = (tenant, cls)
        self._deferred_lanes[key] = max(
            0, self._deferred_lanes.get(key, 0) - lanes)
