"""SLO tracking: per-(tenant, class) objectives with error-budget burn rate.

An objective declares what "good" means for one ``(tenant, latency_class)``
pair — a latency target and the fraction of requests that must meet it
(shed requests always count against the budget: a fast reject is
availability loss, not a served answer).  The tracker keeps a bounded
rolling window of good/bad outcomes per objective and reports the classic
SRE statistic:

    burn_rate = observed_bad_fraction / allowed_bad_fraction

Burn 1.0 means the error budget is being consumed exactly as fast as the
objective allows; sustained burn above 1.0 means the SLO will be missed.
Two consumers act on it:

  * :meth:`ServeFrontend.report` surfaces per-objective burn/compliance and
    the frontend emits a structured ``slo.breach`` decision-log event (plus
    an ``slo.breach`` counter) each time an objective *crosses* into
    breach — edge-triggered, so a sustained breach is one event, not one
    per request;
  * admission control: :meth:`SloTracker.should_shed_batch` reports when
    any **interactive** objective burns hotter than ``shed_burn_ratio``, and
    the frontend then sheds batch-class load *before* interactive p99
    burns — the cheapest load to drop is the load that can be retried.

The clock is injectable like every scheduling component in this repo, so
tests and replays meter burn on a virtual timeline.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

# minimum window samples before burn rate is reported (a burn over three
# requests is noise, the same guard philosophy as guarded_percentiles)
MIN_BURN_SAMPLES = 20


@dataclasses.dataclass(frozen=True)
class Objective:
    """One (tenant, class) service-level objective."""
    tenant: str
    latency_class: str
    latency_target_s: float          # a request is good iff latency <= this
    target_fraction: float = 0.99    # ... for at least this share of requests
    window: int = 512                # rolling request window

    @property
    def allowed_bad_fraction(self) -> float:
        return max(1.0 - self.target_fraction, 1e-9)


class _ObjectiveState:
    __slots__ = ("objective", "outcomes", "good", "bad", "breached")

    def __init__(self, objective: Objective):
        self.objective = objective
        self.outcomes: deque = deque(maxlen=objective.window)
        self.good = 0                # totals, never forgotten
        self.bad = 0
        self.breached = False        # edge-trigger state for breach events


class SloTracker:
    """Rolling per-objective error-budget accounting."""

    def __init__(self, clock: Callable[[], float] = None,
                 shed_burn_ratio: float = 1.0):
        self.clock = clock if clock is not None else time.monotonic
        # interactive burn at/above this ratio => shed batch-class load
        self.shed_burn_ratio = float(shed_burn_ratio)
        self._objectives: Dict[Tuple[str, str], _ObjectiveState] = {}

    # ---- configuration ----------------------------------------------------

    def set_objective(self, tenant: str, latency_class: str,
                      latency_target_s: float,
                      target_fraction: float = 0.99,
                      window: int = 512) -> Objective:
        obj = Objective(tenant, latency_class, float(latency_target_s),
                        float(target_fraction), int(window))
        self._objectives[(tenant, latency_class)] = _ObjectiveState(obj)
        return obj

    def objectives(self):
        return [st.objective for st in self._objectives.values()]

    # ---- observation ------------------------------------------------------

    def observe(self, tenant: str, latency_class: str,
                latency_s: Optional[float] = None,
                shed: bool = False) -> Optional[dict]:
        """Record one request outcome against its objective (no-op for
        pairs without one).  Returns a breach event dict when this
        observation *crosses* the objective into breach (burn >= 1 with
        enough samples), else None — the caller owns event emission."""
        st = self._objectives.get((tenant, latency_class))
        if st is None:
            return None
        good = (not shed and latency_s is not None
                and latency_s <= st.objective.latency_target_s)
        st.outcomes.append(bool(good))
        if good:
            st.good += 1
        else:
            st.bad += 1
        burn = self._burn(st)
        if burn is not None and burn >= 1.0:
            if not st.breached:
                st.breached = True
                return {
                    "tenant": tenant, "cls": latency_class,
                    "burn_rate": round(burn, 3),
                    "window_n": len(st.outcomes),
                    "latency_target_s": st.objective.latency_target_s,
                    "target_fraction": st.objective.target_fraction,
                }
        elif burn is not None:
            st.breached = False
        return None

    # ---- queries ----------------------------------------------------------

    @staticmethod
    def _burn(st: _ObjectiveState) -> Optional[float]:
        n = len(st.outcomes)
        if n < MIN_BURN_SAMPLES:
            return None
        bad = n - sum(st.outcomes)
        return (bad / n) / st.objective.allowed_bad_fraction

    def burn_rate(self, tenant: str, latency_class: str) -> Optional[float]:
        """Window burn rate, or None without an objective / enough data."""
        st = self._objectives.get((tenant, latency_class))
        return None if st is None else self._burn(st)

    def should_shed_batch(self) -> bool:
        """True when any *interactive* objective burns at or above
        ``shed_burn_ratio`` — the signal admission control uses to shed
        batch-class load pre-emptively."""
        for (tenant, cls), st in self._objectives.items():
            if cls != "interactive":
                continue
            burn = self._burn(st)
            if burn is not None and burn >= self.shed_burn_ratio:
                return True
        return False

    def summary(self) -> dict:
        """JSON-safe per-objective state (report / CI artifact payload)."""
        out = {}
        for (tenant, cls), st in sorted(self._objectives.items()):
            n = len(st.outcomes)
            bad = n - sum(st.outcomes)
            burn = self._burn(st)
            out[f"{tenant}/{cls}"] = {
                "latency_target_ms": st.objective.latency_target_s * 1e3,
                "target_fraction": st.objective.target_fraction,
                "window_n": n,
                "window_bad": int(bad),
                "window_compliance": (n - bad) / n if n else None,
                "burn_rate": None if burn is None else round(burn, 4),
                "breached": st.breached,
                "total_good": st.good,
                "total_bad": st.bad,
            }
        return out
