"""Per-tenant runtime settings (copy of ``bifromq_tpu/plugin/settings.py``
without ``TenantSettings``, the MQTT frontend's CONNECT snapshot, ROADMAP
A.5b; ≈ plugin-setting-provider Setting.java:31-77).

The reference declares 40+ validated Setting enum entries resolved per tenant
through ISettingProvider with caching; the subset here covers everything the
current broker surface consults, with the reference's defaults.
"""

from __future__ import annotations

import enum
from typing import Any, Dict


class Setting(enum.Enum):
    """Names follow the reference Setting.java; defaults in ``_DEFAULTS``
    (enum values must be unique — equal values silently become aliases)."""
    MQTT3Enabled = enum.auto()
    MQTT4Enabled = enum.auto()   # 3.1.1
    MQTT5Enabled = enum.auto()
    DebugModeEnabled = enum.auto()
    ForceTransient = enum.auto()
    ByPassPermCheckError = enum.auto()
    PayloadFormatValidationEnabled = enum.auto()
    RetainEnabled = enum.auto()
    WildcardSubscriptionEnabled = enum.auto()
    SubscriptionIdentifierEnabled = enum.auto()
    SharedSubscriptionEnabled = enum.auto()
    MaximumQoS = enum.auto()
    MaxTopicLevelLength = enum.auto()
    MaxTopicLevels = enum.auto()
    MaxTopicLength = enum.auto()
    MaxTopicAlias = enum.auto()
    MaxSharedGroupMembers = enum.auto()
    MaxTopicFiltersPerInbox = enum.auto()
    MsgPubPerSec = enum.auto()
    ReceivingMaximum = enum.auto()
    InBoundBandWidth = enum.auto()
    OutBoundBandWidth = enum.auto()
    MaxUserPayloadBytes = enum.auto()
    MaxResendTimes = enum.auto()
    ResendTimeoutSeconds = enum.auto()
    MaxTopicFiltersPerSub = enum.auto()
    MaxSessionExpirySeconds = enum.auto()
    SessionInboxSize = enum.auto()
    QoS0DropOldest = enum.auto()
    RetainMessageMatchLimit = enum.auto()
    MaxPersistentFanout = enum.auto()
    MaxGroupFanout = enum.auto()
    MinKeepAliveSeconds = enum.auto()
    MaxLastWillBytes = enum.auto()
    MinSessionExpirySeconds = enum.auto()
    NoLWTWhenServerShuttingDown = enum.auto()
    MinSendPerSec = enum.auto()
    MaxPersistentFanoutBytes = enum.auto()

    @property
    def default(self) -> Any:
        return _DEFAULTS[self]


_DEFAULTS: Dict["Setting", Any] = {
    Setting.MQTT3Enabled: True,
    Setting.MQTT4Enabled: True,
    Setting.MQTT5Enabled: True,
    Setting.DebugModeEnabled: False,
    Setting.ForceTransient: False,
    Setting.ByPassPermCheckError: True,
    Setting.PayloadFormatValidationEnabled: True,
    Setting.RetainEnabled: True,
    Setting.WildcardSubscriptionEnabled: True,
    Setting.SubscriptionIdentifierEnabled: True,
    Setting.SharedSubscriptionEnabled: True,
    Setting.MaximumQoS: 2,
    Setting.MaxTopicLevelLength: 40,
    Setting.MaxTopicLevels: 16,
    Setting.MaxTopicLength: 255,
    Setting.MaxTopicAlias: 10,
    Setting.MaxSharedGroupMembers: 200,
    Setting.MaxTopicFiltersPerInbox: 100,
    Setting.MsgPubPerSec: 200,
    Setting.ReceivingMaximum: 200,
    Setting.InBoundBandWidth: 512 * 1024,
    Setting.OutBoundBandWidth: 512 * 1024,
    Setting.MaxUserPayloadBytes: 256 * 1024,
    Setting.MaxResendTimes: 3,
    Setting.ResendTimeoutSeconds: 10,
    Setting.MaxTopicFiltersPerSub: 10,
    Setting.MaxSessionExpirySeconds: 24 * 60 * 60,
    Setting.SessionInboxSize: 1000,
    Setting.QoS0DropOldest: False,
    Setting.RetainMessageMatchLimit: 10,
    Setting.MaxPersistentFanout: 1000,
    Setting.MaxGroupFanout: 100,
    Setting.MinKeepAliveSeconds: 60,
    # 128 BYTES is the reference's own initial value (Setting.java:54)
    Setting.MaxLastWillBytes: 128,
    Setting.MinSessionExpirySeconds: 0,
    Setting.NoLWTWhenServerShuttingDown: True,
    Setting.MinSendPerSec: 8,
    Setting.MaxPersistentFanoutBytes: 2 ** 63 - 1,
}


class ISettingProvider:
    def provide(self, setting: Setting, tenant_id: str) -> Any:
        """Return the tenant's value, or None to fall back to default."""
        raise NotImplementedError


class DefaultSettingProvider(ISettingProvider):
    """Static defaults with optional per-tenant overrides (for tests/ops)."""

    def __init__(self, overrides: Dict[str, Dict[Setting, Any]] = None) -> None:
        self.overrides = overrides or {}

    def provide(self, setting: Setting, tenant_id: str) -> Any:
        return self.overrides.get(tenant_id, {}).get(setting)
