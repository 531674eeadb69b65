"""Environment knob parsers (copy of ``env_int``/``env_str``/``env_bool``/
``env_float``/``env_opt_str`` from ``bifromq_tpu/utils/env.py``).

Every ``BIFROMQ_*`` knob the port reads resolves through these helpers,
lazily at first use, never at module import.
"""

from __future__ import annotations

import os
from typing import Optional


def env_float(name: str, default: float) -> float:
    """Float env knob with a default on unset/blank/garbage."""
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    """Int env knob, same unset/blank/garbage fallback as env_float."""
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def env_str(name: str, default: str = "") -> str:
    """Stripped string env knob; unset/blank yields the default."""
    return os.environ.get(name, "").strip() or default


def env_opt_str(name: str) -> Optional[str]:
    """Stripped string knob, or None when unset/blank (for callers that
    must distinguish 'absent' from any concrete value)."""
    raw = os.environ.get(name, "").strip()
    return raw or None


_FALSY = ("0", "off", "false", "no")
_TRUTHY = ("1", "on", "true", "yes")


def env_bool(name: str, default: bool) -> bool:
    """Boolean env knob: explicit falsy/truthy spellings win, anything
    else (unset, blank, garbage) yields the default."""
    raw = os.environ.get(name, "").strip().lower()
    if raw in _FALSY:
        return False
    if raw in _TRUTHY:
        return True
    return default
