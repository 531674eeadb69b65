"""Sub-broker delivery SPI (copy of ``bifromq_tpu/plugin/subbroker.py``;
≈ plugin-sub-broker ISubBroker.java:28).

The dist plane fans matched messages out to *sub-brokers* identified by id:
id 0 = transient MQTT sessions (mqtt-broker-client), id 1 = persistent inbox
(inbox-client). ``deliver`` takes packs grouped by deliverer key and reports
per-matchinfo results (OK / NO_SUB / NO_RECEIVER) which drive route cleanup
(bifromq-deliverer .../BatchDeliveryCall.java:53 result interpretation).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from ..types import MatchInfo, TopicMessagePack

TRANSIENT_SUB_BROKER_ID = 0
PERSISTENT_SUB_BROKER_ID = 1


class DeliveryResult(enum.Enum):
    OK = "ok"
    NO_SUB = "no_sub"          # subscription vanished -> unmatch route
    NO_RECEIVER = "no_receiver"  # receiver gone -> unmatch route
    ERROR = "error"


@dataclass
class DeliveryPack:
    message_pack: TopicMessagePack
    match_infos: Tuple[MatchInfo, ...]


class ISubBroker:
    id: int

    async def deliver(self, tenant_id: str, deliverer_key: str,
                      packs: Sequence[DeliveryPack]
                      ) -> Dict[MatchInfo, DeliveryResult]:
        raise NotImplementedError

    async def check_subscriptions(self, tenant_id: str,
                                  match_infos: Sequence[MatchInfo]
                                  ) -> List[bool]:
        """True per match info iff the subscription still exists (dist GC)."""
        raise NotImplementedError


class SubBrokerRegistry:
    def __init__(self) -> None:
        self._brokers: Dict[int, ISubBroker] = {}

    def register(self, broker: ISubBroker) -> None:
        self._brokers[broker.id] = broker

    def get(self, broker_id: int) -> ISubBroker:
        return self._brokers[broker_id]

    def has(self, broker_id: int) -> bool:
        return broker_id in self._brokers
