"""Resource throttler extension point (copy of
``bifromq_tpu/plugin/throttler.py``; ≈ plugin-resource-throttler).

``has_resource(tenant, type)`` gates data-path actions; the resource type set
mirrors the reference's TenantResourceType enum (20+ entries; subset here).
"""

from __future__ import annotations

import enum


class TenantResourceType(enum.Enum):
    TOTAL_CONNECTIONS = "total_connections"
    TOTAL_SESSION_MEMORY_BYTES = "total_session_memory_bytes"
    TOTAL_PERSISTENT_SESSIONS = "total_persistent_sessions"
    TOTAL_PERSISTENT_SESSION_SPACE_BYTES = "total_persistent_session_space"
    TOTAL_SHARED_SUBSCRIPTIONS = "total_shared_subscriptions"
    TOTAL_TRANSIENT_SUBSCRIPTIONS = "total_transient_subscriptions"
    TOTAL_PERSISTENT_SUBSCRIPTIONS = "total_persistent_subscriptions"
    TOTAL_RETAIN_TOPICS = "total_retain_topics"
    TOTAL_RETAINED_BYTES = "total_retained_bytes"
    TOTAL_INGRESS_BYTES_PER_SECOND = "total_ingress_bytes_per_sec"
    TOTAL_EGRESS_BYTES_PER_SECOND = "total_egress_bytes_per_sec"


class IResourceThrottler:
    def has_resource(self, tenant_id: str,
                     rtype: TenantResourceType) -> bool:
        raise NotImplementedError


class AllowAllResourceThrottler(IResourceThrottler):
    def has_resource(self, tenant_id: str,
                     rtype: TenantResourceType) -> bool:
        return True


# SLOAdvisedResourceThrottler, the decorator fed by the SLO layer's
# noisy-neighbor advisory (OBS.is_noisy): ROADMAP A.10
