"""RPC framing (copy of ``_len16`` / ``_read16`` from
``bifromq_tpu/rpc/fabric.py``: the one framing the dist worker's match
codec shares with the RPC fabric; the fabric itself is ROADMAP A.5b).
"""

from __future__ import annotations

import struct
from typing import Tuple


def _len16(b: bytes) -> bytes:
    return struct.pack(">H", len(b)) + b


def _read16(buf: bytes, pos: int) -> Tuple[bytes, int]:
    n = struct.unpack_from(">H", buf, pos)[0]
    pos += 2
    return buf[pos:pos + n], pos + n
