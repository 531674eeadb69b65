"""Typed system-property flags (copy of ``bifromq_tpu/utils/sysprops.py``;
≈ bifromq-sysprops BifroMQSysProp.java).

Each prop has a typed parser + default; values resolve from environment
variables (``BIFROMQ_<NAME>``) the way the reference resolves JVM
``-D`` properties, with the same resolve-once-then-cache semantics. The port carries only the props it reads.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Dict

from .env import env_opt_str


class SysProp(enum.Enum):
    """(env suffix, parser, default)"""

    # dist plane (≈ DistTopicMatchExpirySeconds ...). The reference's
    # other props arrive with the slices that read them (A.5b).
    DIST_GC_INTERVAL_SECONDS = ("DIST_GC_INTERVAL_SECONDS", float, 600.0)

    def __init__(self, env_suffix: str, parser: Callable[[str], Any],
                 default: Any) -> None:
        self.env_suffix = env_suffix
        self.parser = parser
        self.default = default


_cache: Dict[SysProp, Any] = {}


def get(prop: SysProp) -> Any:
    """Resolve a prop: env var (parsed) > default; cached."""
    if prop not in _cache:
        raw = env_opt_str(f"BIFROMQ_{prop.env_suffix}")
        if raw is None:
            _cache[prop] = prop.default
        else:
            try:
                _cache[prop] = prop.parser(raw)
            except (ValueError, TypeError):
                _cache[prop] = prop.default
    return _cache[prop]

