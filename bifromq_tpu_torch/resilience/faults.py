"""Process-global fault injection: copy of ``FaultRule``,
``InjectedFault``, ``FaultInjector`` and ``get_injector`` from
``bifromq_tpu/resilience/faults.py`` (``ChaosCampaign`` is ROADMAP A.10).

Rules match by (side, service, method) with a probability. The port's
hooks are the device-side rule set (``service="tpu-device"``), in the
matcher's dispatch and fetch stages and the dispatch ring's readiness
poll:

- ``error``: the dispatch (method="dispatch") or fetch (method="fetch")
  raises — a crashed kernel or a poisoned buffer.
- ``hang``: the dispatched batch NEVER reports ready while the rule stays
  installed — a wedged card; the watchdog deadline is the only way out.
  Removing the rule "un-wedges" it.
- ``slow``: readiness is withheld for ``delay`` seconds.
- ``flaky_ready``: each readiness poll lies "not ready" with the rule's
  probability; completion is only delayed, never denied.

The dist worker adds one matcher-side hook: an ``error`` rule for
``service="tpu-matcher"`` (side ``"matcher"``, method ``"match"``) fails
a range's match at its dispatch boundary, and the worker serves that
range from the host oracle (``check_raise``).

Everything is deterministic under a seeded ``random.Random``; injected
faults are counted globally (``utils.metrics.FABRIC``) and per rule.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class FaultRule:
    service: str = "*"
    method: str = "*"
    side: str = "*"            # "device" | "*"
    probability: float = 1.0
    action: str = "error"      # error | hang | slow | flaky_ready
    delay: float = 0.0         # seconds, for action="slow"
    max_hits: Optional[int] = None   # stop firing after N hits
    hits: int = field(default=0, init=False)

    def matches(self, side: str, service: str, method: str) -> bool:
        if self.max_hits is not None and self.hits >= self.max_hits:
            return False
        return ((self.side in ("*", side))
                and (self.service in ("*", service))
                and (self.method in ("*", method)))


class InjectedFault(Exception):
    """Raised for action="error" at a hook point (the device's dispatch
    or fetch, the dist worker's match boundary)."""


class FaultInjector:
    def __init__(self, seed: Optional[int] = None) -> None:
        self.rules: List[FaultRule] = []
        self.rng = random.Random(seed)
        self.enabled = False
        self.injected_total = 0

    # ---------------- configuration ----------------------------------------

    def add_rule(self, **kw) -> FaultRule:
        rule = FaultRule(**kw)
        self.rules.append(rule)
        self.enabled = True
        return rule

    def remove_rule(self, rule: FaultRule) -> None:
        if rule in self.rules:
            self.rules.remove(rule)
        self.enabled = bool(self.rules)

    def reset(self, seed: Optional[int] = None) -> None:
        self.rules.clear()
        self.enabled = False
        self.injected_total = 0
        if seed is not None:
            self.rng = random.Random(seed)

    # ---------------- decision points --------------------------------------

    def decide(self, side: str, service: str, method: str,
               actions: Optional[tuple] = None) -> Optional[FaultRule]:
        """First matching rule that fires, or None. ``actions`` restricts
        which rule actions a hook point can honor — rules it cannot act
        on are left untouched (hits/counters unconsumed) for the hook
        that can. O(1) when disabled — the hot path pays a single
        attribute check."""
        if not self.enabled:
            return None
        for rule in self.rules:
            if actions is not None and rule.action not in actions:
                continue
            if rule.matches(side, service, method) \
                    and self.rng.random() < rule.probability:
                rule.hits += 1
                self.injected_total += 1
                self._meter()
                return rule
        return None

    def check_raise(self, side: str, service: str, method: str) -> None:
        """Raise InjectedFault when an ``error`` rule fires; rules of other
        actions are NOT consumed here — they stay armed for the hook
        that can act on them (the readiness poll)."""
        if self.decide(side, service, method,
                       actions=("error",)) is not None:
            raise InjectedFault(f"{service}/{method} ({side})")

    #: the device-side action taxonomy — see module docstring
    DEVICE_ACTIONS = ("error", "hang", "slow", "flaky_ready")

    def device_rule(self, method: str) -> Optional[FaultRule]:
        """Device-fault hook for ``service="tpu-device"`` rules at the
        matcher's dispatch/fetch stages. ``error`` rules raise here; the
        readiness-shaping actions (hang/slow/flaky_ready) return the
        fired rule for the caller to thread into ``wait_ready``. O(1)
        when the injector is disabled."""
        rule = self.decide("device", "tpu-device", method,
                           actions=self.DEVICE_ACTIONS)
        if rule is not None and rule.action == "error":
            raise InjectedFault(f"tpu-device/{method} (device)")
        return rule

    def rule_active(self, rule: Optional[FaultRule]) -> bool:
        """Is a previously-fired rule still installed? The hang action
        polls this so REMOVING the rule un-wedges the device mid-wait."""
        return rule is not None and rule in self.rules

    @staticmethod
    def _meter() -> None:
        from ..utils.metrics import FABRIC, FabricMetric
        FABRIC.inc(FabricMetric.FAULTS_INJECTED)


# the process-global injector the device hooks consult (tests and the
# chaos phase reconfigure it; serving leaves it disabled — one bool check
# per batch)
_INJECTOR = FaultInjector()


def get_injector() -> FaultInjector:
    return _INJECTOR
